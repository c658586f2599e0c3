"""Parameters of the port's models: ``ParamDef`` trees made into
``nn.Module`` trees.

Counterpart of the reference's ``repro/models/params.py`` (``ParamDef``,
``tree_init``).  A model's parameters are described by a nested dict of
:class:`ParamDef` leaves, as in the reference; :class:`ParamModule` makes
that dict an ``nn.Module`` tree whose parameter names are the reference
tree's paths (``blocks.0.attn.wq``, ``embed.table``, ``head``,
``ln_f.scale``).  Layers are per-layer modules in an ``nn.ModuleList``:
the reference stacks them on a leading L dim for ``lax.scan``, an XLA
compile-size device that an eager loop does not need.

Weights keep the reference's ``x @ w`` orientation, ``(d_in, d_out)``,
so :func:`params_from_jax` carries a reference tree across unchanged
apart from unstacking the L dim of ``blocks`` (an MoE block's experts
keep their leading E; the hybrid's ``shared_attn`` is not stacked, and
the encoder's empty ``embed_in`` names no parameter).  Sharding specs are not ported
(ROADMAP Queue 1 item 8b).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    init: str = "normal"        # normal | zeros | ones
    scale: float | None = None  # default: 1/sqrt(fan_in)
    dtype: Any = None           # overrides the tree-level default when set

    def fan_in(self) -> int:
        return (int(self.shape[-2]) if len(self.shape) >= 2
                else int(self.shape[-1]))


def _leaves(tree):
    if isinstance(tree, ParamDef):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        for v in tree:
            yield from _leaves(v)


def tree_count(tree) -> int:
    """Number of scalars in a ``ParamDef`` tree."""
    return sum(math.prod(d.shape) for d in _leaves(tree))


class ParamModule(nn.Module):
    """An ``nn.Module`` made from a nested dict of :class:`ParamDef`
    leaves: a dict becomes a submodule, a list an ``nn.ModuleList``, a
    leaf an uninitialised ``nn.Parameter`` of ``dtype`` (or the leaf's
    own) on ``device``.  ``module["wq"]`` reads like the reference's
    ``p["wq"]``; :func:`init_params` fills the values."""

    def __init__(self, defs: dict, dtype=torch.float32, device=None):
        super().__init__()
        self.defs: dict[str, ParamDef] = {}
        for name, d in defs.items():
            if isinstance(d, ParamDef):
                self.defs[name] = d
                self.register_parameter(name, nn.Parameter(torch.empty(
                    d.shape, dtype=d.dtype or dtype, device=device)))
            elif isinstance(d, dict):
                self.add_module(name, ParamModule(d, dtype, device))
            else:
                self.add_module(name, nn.ModuleList(
                    ParamModule(x, dtype, device) for x in d))

    def __getitem__(self, name: str):
        return getattr(self, name)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every leaf of ``model`` in module order with the reference's
    scales: normal × ``1/sqrt(fan_in)`` unless the leaf names its own
    scale (the embedding's 0.02), ones and zeros as declared.  Draws are
    float32, cast to the leaf's dtype.  ``generator`` lives on the
    parameters' device; the numbers differ from ``jax.random``'s for the
    same seed (carry weights across with :func:`params_from_jax`)."""
    for mod in model.modules():
        if not isinstance(mod, ParamModule):
            continue
        for name, d in mod.defs.items():
            p = getattr(mod, name)
            if d.init == "zeros":
                p.zero_()
            elif d.init == "ones":
                p.fill_(1)
            else:
                scale = d.scale if d.scale is not None else \
                    1.0 / math.sqrt(d.fan_in())
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=p.device, dtype=torch.float32)
                        * scale)
    return model


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a)     # a writable copy: jax hands out read-only buffers
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """A state dict for :class:`ParamModule` from the reference's
    parameter tree, given as numpy arrays (``jax.tree.map(np.asarray,
    params)``).  The stacked ``blocks`` leaves are unstacked into
    ``blocks.<i>.…``; every weight keeps its ``(d_in, d_out)`` shape."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix, layer=None):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.", layer)
            return
        a = np.asarray(node)
        if layer is None:
            out[prefix[:-1]] = _to_tensor(a)
        else:
            for i in range(a.shape[0]):
                out[f"blocks.{i}.{prefix[len('blocks.'):-1]}"] = \
                    _to_tensor(a[i])

    for key, sub in tree.items():
        walk(sub, f"{key}.", layer=True if key == "blocks" else None)
    return out

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
the encoder's empty ``embed_in`` names no parameter).

Sharding follows the reference's convention (mesh axes: optional
``pod``, ``data``, ``model``): each ``ParamDef`` carries a ``pspec``, a
tuple with one entry per leading dim (an axis name, a tuple of names,
or ``None``), the reference's ``PartitionSpec`` as plain data.  Weights
carry only ``model`` (tensor parallel); optimizer moments add a ``data``
shard (``train/optimizer.zero_pspec``); MoE experts are also split over
``data`` (ZeRO-3); under ``sharding="fsdp"`` every leaf is re-specced by
:func:`fsdp_transform`.  :class:`NamedSharding` is the placement a spec
means on a :class:`~repro_torch.launch.mesh.Mesh`: ``split`` makes one
tensor per mesh position, on that position's device, and ``gather``
puts the shards back together.  A dim that its axis does not divide is
replicated over that axis (GSPMD would pad it); the answer is the same.
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
    pspec: tuple = ()           # PartitionSpec: an axis (tuple) per dim
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


def tree_map(fn, tree):
    """``tree`` with every ``ParamDef`` leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, ParamDef):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return [tree_map(fn, v) for v in tree]


def flat_defs(tree, prefix: str = "") -> dict[str, ParamDef]:
    """The leaves of a ``ParamDef`` tree by the names a
    :class:`ParamModule` of it gives its parameters
    (``blocks.0.attn.wq``)."""
    if isinstance(tree, ParamDef):
        return {prefix[:-1]: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(flat_defs(v, f"{prefix}{k}."))
    return out


def tree_pspecs(tree):
    """The tree of each leaf's ``pspec``."""
    return tree_map(lambda d: d.pspec, tree)


def stacked(defn: ParamDef, n: int) -> ParamDef:
    """A per-layer ``ParamDef`` stacked on a leading L dim, as the
    reference stacks layers for its scan (the spec gains a leading
    ``None``).  The port keeps layers apart; the stacked specs are what
    the reference's tree holds."""
    return ParamDef((n,) + tuple(defn.shape), (None,) + tuple(defn.pspec),
                    defn.init, defn.scale, defn.dtype)


def map_stacked(tree, n: int):
    return tree_map(lambda d: stacked(d, n), tree)


def fsdp_transform(tree, axes: tuple, total: int):
    """Re-spec every leaf for FSDP: the largest dim divisible by the full
    device count is sharded over all of ``axes``; everything else is
    replicated (the reference's spec function; the mesh executor,
    ``models/parallel.py``, gathers such leaves whole where a layer reads
    them)."""
    def one(d: ParamDef) -> ParamDef:
        best = None
        for i, dim in enumerate(d.shape):
            if dim % total == 0 and dim >= total:
                if best is None or dim > d.shape[best]:
                    best = i
        spec = [None] * len(d.shape)
        if best is not None:
            spec[best] = axes
        return ParamDef(d.shape, tuple(spec), d.init, d.scale, d.dtype)
    return tree_map(one, tree)


def spec_axes(entry) -> tuple:
    """The mesh axes one entry of a spec names (``None`` names none)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """Where a spec puts a tensor on a mesh (``jax.sharding.NamedSharding``
    made concrete): ``split`` gives one tensor per mesh position, on its
    device, holding the slice the position owns; ``gather`` assembles
    the global tensor from such shards.  Dim ``k`` is split over
    ``spec[k]`` (its axes flattened major to minor) when their size
    divides it, and replicated over them otherwise; mesh axes the spec
    does not name replicate the whole tensor.

        sh = NamedSharding(mesh, (None, "model"))
        shards = sh.split(w)            # numpy object array, mesh-shaped
        w2 = sh.gather(shards, w.shape, "cpu")   # == w
    """

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = tuple(spec)

    def _n(self, axes) -> int:
        return math.prod(self.mesh.shape[a] for a in axes)

    def dims(self, shape) -> dict[int, tuple]:
        """The dims this sharding splits for a tensor of ``shape``, each
        with the axes it is split over."""
        out = {}
        for k, entry in enumerate(self.spec[:len(shape)]):
            axes = spec_axes(entry)
            if axes and shape[k] % self._n(axes) == 0:
                out[k] = axes
        return out

    def local_shape(self, shape) -> tuple:
        shape = tuple(int(n) for n in shape)
        out = list(shape)
        for k, axes in self.dims(shape).items():
            out[k] //= self._n(axes)
        return tuple(out)

    def replica_axes(self, shape) -> tuple:
        """The mesh axes over which the shards of ``shape`` repeat."""
        used = {a for axes in self.dims(shape).values() for a in axes}
        return tuple(a for a in self.mesh.axis_names if a not in used)

    def index(self, coord: tuple, shape) -> tuple:
        """The global slice mesh position ``coord`` holds."""
        idx = [slice(None)] * len(shape)
        for k, axes in self.dims(shape).items():
            i = 0
            for a in axes:
                i = i * self.mesh.shape[a] + coord[
                    self.mesh.axis_names.index(a)]
            n = shape[k] // self._n(axes)
            idx[k] = slice(i * n, (i + 1) * n)
        return tuple(idx)

    def split(self, t: torch.Tensor) -> np.ndarray:
        out = np.empty(self.mesh.devices.shape, dtype=object)
        for c in np.ndindex(*out.shape):
            src = t[self.index(c, t.shape)]
            out[c] = torch.empty(src.shape, dtype=src.dtype,
                                 device=self.mesh.devices[c]).copy_(src)
        return out

    def gather(self, shards: np.ndarray, shape, device) -> torch.Tensor:
        """The global tensor of ``shape`` from ``shards``, on ``device``;
        a replicated part is read from its first replica."""
        first = shards.flat[0]
        shape = tuple(shape)
        y = torch.empty(shape, dtype=first.dtype, device=device)
        rep = [self.mesh.axis_names.index(a)
               for a in self.replica_axes(shape)]
        for c in np.ndindex(*shards.shape):
            if not any(c[k] for k in rep):
                y[self.index(c, shape)].copy_(shards[c])
        return y


class OnMesh:
    """The kind of a model placed on a mesh (``parallel.MeshModel``).
    ``transformer``'s entry points hand such a model to its own methods
    (``forward_hidden``, ``train_loss``, ``prefill``, ``decode_step``),
    so the model layer needs no import of the mesh executor above it."""


class Sharded:
    """A global tensor of ``shape`` held as one tensor per mesh position
    (``shards``, mesh-shaped) by ``sharding``: the optimizer's moments on
    a mesh, and what a checkpoint gathers and splits.

        m = Sharded.split(torch.zeros(64, 16), NamedSharding(mesh, ("data",)))
        m.gather("cpu").shape                 # (64, 16)
    """

    def __init__(self, shards: np.ndarray, sharding: NamedSharding, shape):
        self.shards, self.sharding = shards, sharding
        self.shape = tuple(int(n) for n in shape)

    @classmethod
    def split(cls, t: torch.Tensor, sharding: NamedSharding) -> "Sharded":
        return cls(sharding.split(t), sharding, t.shape)

    @property
    def dtype(self):
        return self.shards.flat[0].dtype

    def gather(self, device) -> torch.Tensor:
        return self.sharding.gather(self.shards, self.shape, device)


def tree_shardings(tree, mesh):
    """The tree of each leaf's :class:`NamedSharding` on ``mesh``."""
    return tree_map(lambda d: NamedSharding(mesh, d.pspec), tree)


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

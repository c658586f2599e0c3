"""AdamW and the LR schedules (cosine, and minicpm's WSD).

Counterpart of the reference's ``repro/train/optimizer.py``.  Moments are
float32 whatever the parameters' dtype; the step clips by the global
gradient norm and then updates, in the reference's order of operations
(``adamw_update``).  Parameters are a ``ParamModule`` (or any module);
the optimizer state is ``{"m": {name: tensor}, "v": {name: tensor},
"count": 0-d int32 tensor}`` keyed by the parameters' names, which are
the reference tree's paths, so ``params_from_jax`` carries the
reference's ``m`` and ``v`` across as it carries its parameters.

On a mesh (a ``parallel.MeshModel``) the moments are ZeRO-sharded as
in the reference: their specs (``zero_pspec``, ``opt_state_defs``) add a
``data`` shard on the first free dim that ``data`` divides, so each data
shard holds and updates its slice of every parameter, and an
``all_gather`` over ``data`` puts the updated parameters back in place.
The global gradient norm counts each logical element once: each slice
is summed on the one position that owns it, then ``psum``med over the
whole mesh.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.distributed import all_gather, psum
from repro_torch.models.parallel import MeshModel
from repro_torch.models.params import (NamedSharding, ParamDef, Sharded,
                                       spec_axes, tree_map)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"      # cosine | wsd | constant
    stable_frac: float = 0.8      # WSD: fraction of steps at peak LR


def schedule_lr(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor), a float32
    0-d tensor computed in float32 as the reference computes it."""
    step = torch.as_tensor(step).float()
    f32 = torch.float32
    warm = torch.clamp((step + 1) / max(1, cfg.warmup), max=1.0)
    if cfg.schedule == "constant":
        return torch.tensor(cfg.lr, dtype=f32) * warm
    frac = torch.clamp((step - cfg.warmup)
                       / max(1, cfg.total_steps - cfg.warmup), 0.0, 1.0)
    if cfg.schedule == "wsd":
        # warmup -> stable plateau -> 1-sqrt decay (minicpm, arXiv:2404.06395)
        decay_frac = torch.clamp((frac - cfg.stable_frac)
                                 / max(1e-6, 1 - cfg.stable_frac), 0.0, 1.0)
        return cfg.lr * warm * (1.0 - (1 - 0.1) * torch.sqrt(decay_frac))
    cos = 0.5 * (1 + torch.cos(torch.tensor(math.pi, dtype=f32) * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def zero_pspec(d: ParamDef, data_axis: str = "data",
               data_size: int = 16) -> tuple:
    """A parameter's spec with a ``data`` shard on the first dim that is
    unsharded and divisible by the data axis (ZeRO-1); a spec that
    already names ``data`` (the MoE's experts) stays."""
    spec = list(d.pspec) + [None] * (len(d.shape) - len(d.pspec))
    if data_axis in [a for s in spec for a in spec_axes(s)]:
        return tuple(spec)
    for i, (dim, cur) in enumerate(zip(d.shape, spec)):
        if cur is None and dim % data_size == 0 and dim >= data_size:
            spec[i] = data_axis
            break
    return tuple(spec)


def opt_state_defs(param_tree, data_size: int = 16):
    """The ``ParamDef`` tree of the (m, v) moments, float32 and
    ZeRO-sharded, and the step count."""
    def mom(d: ParamDef) -> ParamDef:
        return ParamDef(d.shape, zero_pspec(d, data_size=data_size), "zeros",
                        dtype=torch.float32)
    return {"m": tree_map(mom, param_tree), "v": tree_map(mom, param_tree),
            "count": ParamDef((), (), "zeros", dtype=torch.int32)}


def _moment_sharding(mm, name) -> NamedSharding:
    n_data = mm.mesh.shape.get("data", 1)
    d = mm.flat[name]
    return NamedSharding(mm.mesh, zero_pspec(d, data_size=n_data)
                         if n_data > 1 else d.pspec)


def init_state(model) -> dict:
    """Zero moments (float32, shaped and placed like each parameter; on a
    mesh, ZeRO-sharded :class:`Sharded` tensors) and a zero step
    count."""
    if isinstance(model, MeshModel):
        mesh = model.mesh
        state = {"count": torch.zeros((), dtype=torch.int32,
                                      device=mesh.devices.flat[0])}
        for k in ("m", "v"):
            state[k] = {}
            for n, d in model.flat.items():
                sh = _moment_sharding(model, n)
                shards = np.empty(mesh.devices.shape, dtype=object)
                for c in np.ndindex(*shards.shape):
                    shards[c] = torch.zeros(sh.local_shape(d.shape),
                                            dtype=torch.float32,
                                            device=mesh.devices[c])
                state[k][n] = Sharded(shards, sh, d.shape)
        return state
    m = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
         for n, p in model.named_parameters()}
    v = {n: torch.zeros_like(t) for n, t in m.items()}
    dev = next(model.parameters()).device
    return {"m": m, "v": v,
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads))


def _step_factors(cfg: OptConfig, step) -> tuple:
    """The step's learning rate and Adam's bias correction."""
    b1, b2 = cfg.betas
    t = (step + 1).float()
    return schedule_lr(cfg, step), torch.sqrt(1 - b2 ** t) / (1 - b1 ** t)


def _adamw_tensor(cfg: OptConfig, p, g32, m, v, lr, corr) -> torch.Tensor:
    """One tensor's AdamW step: ``m`` and ``v`` advanced in place by the
    (clipped, float32) gradient ``g32``; returns the updated ``p`` in
    float32."""
    b1, b2 = cfg.betas
    m.copy_(b1 * m + (1 - b1) * g32)
    v.copy_(b2 * v + (1 - b2) * g32 * g32)
    delta = corr * m / (torch.sqrt(v) + cfg.eps)
    return p.float() * (1 - lr * cfg.weight_decay) - lr * delta


@torch.no_grad()
def adamw_update(cfg: OptConfig, model: torch.nn.Module, grads: dict,
                 state: dict) -> tuple[dict, dict]:
    """One clipped AdamW step: ``grads`` maps each parameter name to its
    gradient (any float dtype).  The parameters are updated in place
    (rounded to their dtype once), as are the moments; returns
    ``(state, {"lr", "grad_norm"})`` with the count advanced.  On a mesh
    ``grads`` holds each leaf's logical gradient in shards
    (``parallel.replica_grads``)."""
    if isinstance(model, MeshModel):
        return _adamw_mesh(cfg, model, grads, state)
    step = state["count"]
    lr, corr = _step_factors(cfg, step)
    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    for name, p in model.named_parameters():
        p.copy_(_adamw_tensor(cfg, p, grads[name].float() * scale,
                              state["m"][name], state["v"][name], lr, corr)
                .to(p.dtype))
    state["count"] = step + 1
    return state, {"lr": lr, "grad_norm": gnorm}


def _slice_of(outer: tuple, inner: tuple, shape) -> tuple:
    """Where the global slice ``inner`` lies within the global slice
    ``outer`` (both per-dim slices of a tensor of ``shape``)."""
    out = []
    for o, i, n in zip(outer, inner, shape):
        o0 = o.start or 0
        out.append(slice((i.start or 0) - o0, (n if i.stop is None
                                                else i.stop) - o0))
    return tuple(out)


@torch.no_grad()
def _adamw_mesh(cfg: OptConfig, mm, grads: dict, state: dict):
    """:func:`adamw_update` on a mesh: each position updates its moments'
    slice of its parameter shard; the slices split over ``data`` are
    ``all_gather``ed back into the parameters."""
    mesh = mm.mesh
    coords = list(np.ndindex(*mesh.devices.shape))
    step = state["count"]
    lr, corr = _step_factors(cfg, step)
    params = mm.leaves()
    where = {}
    parts = np.empty(mesh.devices.shape, dtype=object)
    for c in coords:
        parts[c] = torch.zeros((), dtype=torch.float32,
                               device=mesh.devices[c])
    for n, d in mm.flat.items():
        msh = state["m"][n].sharding
        rep = [mesh.axis_names.index(a) for a in msh.replica_axes(d.shape)]
        for c in coords:
            where[n, c] = _slice_of(mm.shardings[n].index(c, d.shape),
                                    msh.index(c, d.shape), d.shape)
            if not any(c[k] for k in rep):      # the slice's one owner
                g = grads[n][c][where[n, c]].float()
                parts[c] = parts[c] + torch.sum(torch.square(g))
    gnorm = torch.sqrt(psum(parts, mesh.axis_names if len(mesh.axis_names)
                            > 1 else mesh.axis_names[0], mesh).flat[0])
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    for n, d in mm.flat.items():
        m_sh, v_sh = state["m"][n], state["v"][n]
        new = np.empty(mesh.devices.shape, dtype=object)
        for c in coords:
            dev, p = mesh.devices[c], params[n][c]
            g32 = grads[n][c][where[n, c]].float() * scale.to(dev)
            new[c] = _adamw_tensor(cfg, p[where[n, c]], g32, m_sh.shards[c],
                                   v_sh.shards[c], lr.to(dev),
                                   corr.to(dev)).to(p.dtype)
        zdim = [k for k, (a, b) in enumerate(zip(
            m_sh.sharding.local_shape(d.shape),
            mm.shardings[n].local_shape(d.shape))) if a != b]
        if zdim:
            new = all_gather(new, "data", mesh, dim=zdim[0])
        for c in coords:
            params[n][c].copy_(new[c])
    state["count"] = step + 1
    return state, {"lr": lr, "grad_norm": gnorm}

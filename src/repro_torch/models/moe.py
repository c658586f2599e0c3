"""Mixture-of-Experts: top-k router and capacity-bucketed expert compute.

Counterpart of the reference's ``repro/models/moe.py`` (``moe_defs``,
``apply_moe``, ``_aux_loss``), the dense-dispatch path; plain torch, as
the reference is plain ``jnp`` (no Pallas kernel), and the expert
products are batched matrix products.  Each ``(token, k)`` slot gets a
rank within its expert from a cumulative count over the token-major
slots; slots past the capacity are dropped (Switch-style truncation),
so the same slots drop as in the reference.  The count runs along the
one-hot's inner axis (an ``(E, t·k)`` scan): along its outer axis, as
the reference writes it, the card's scan kernel has one thread per
expert and took 95 ms a layer at granite's B4 × 8192.  The kept slots
are unique, so the buckets are filled by a copy, not by adds: the
dropped slots go to one spare row past the buckets (the reference adds
their zeros at ``(0, cap - 1)``), which is cut off, and the gather back
reads the flattened buckets with ``index_select``; neither depends on
an order of adds, so the result is deterministic on the card.

Experts are padded to a multiple of 16 (granite's 40 → 48 slots); the
phantom experts get -1e30 router logits, so they receive no token.

On a mesh (``models/parallel.py``) the MoE block runs
:func:`apply_moe_ep`, the reference's expert-parallel path: the
activations are replicated over ``model``, so each model shard buckets
the tokens of its data shard for its own ``E/n_model`` experts, and one
``psum`` over ``model`` completes the output.  Without a ``model`` axis
that splits the experts it is :func:`apply_moe` over the data shards'
tokens gathered, which is the dense dispatch's answer.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.distributed import (_axis_index, all_gather, pmean,
                                          psum, smap, unzip)
from repro_torch.models.layers import matmul
from repro_torch.models.params import ParamDef


def moe_defs(d_model: int, d_ff: int, n_experts: int, pad_to: int = 16,
             act: str = "swiglu"):
    """The MoE block's defs and its padded expert count."""
    e = ((n_experts + pad_to - 1) // pad_to) * pad_to
    defs = {
        "router": ParamDef((d_model, e), ()),      # small, replicated
        # experts over 'model', their d/f dim over 'data' (ZeRO-3):
        # gathered per layer inside the expert-parallel shard
        "w_up": ParamDef((e, d_model, d_ff), ("model", "data", None)),
        "w_down": ParamDef((e, d_ff, d_model), ("model", "data", None)),
    }
    if act in ("swiglu", "geglu"):
        defs["w_gate"] = ParamDef((e, d_model, d_ff),
                                  ("model", "data", None))
    return defs, e


def capacity(t: int, top_k: int, n_experts: int,
             capacity_factor: float = 1.25, min_capacity: int = 4) -> int:
    """Slots per expert for ``t`` tokens: ``capacity_factor·t·k/E``, at
    least ``min_capacity``, rounded up to a multiple of 256 above 256."""
    cap = max(min_capacity, int(capacity_factor * t * top_k / n_experts))
    return (cap + 255) // 256 * 256 if cap > 256 else cap


def route(logits, n_experts: int, top_k: int, cap: int):
    """Top-k routing of float32 ``logits`` (t, E_padded) with phantom
    experts masked → ``(gates, ids, e_idx, c_idx, keep)``: the gates
    renormalised over the k chosen, and each token-major slot's expert,
    rank within it (the ``cap - 1`` of expert 0 where dropped) and
    whether it is kept."""
    n_padded = logits.shape[-1]
    if n_padded > n_experts:
        phantom = torch.arange(n_padded, device=logits.device) >= n_experts
        logits = logits.masked_fill(phantom, -1e30)
    gates, ids = torch.topk(torch.softmax(logits, dim=-1), top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat_ids = ids.reshape(-1)                                  # (t*k,)
    onehot = F.one_hot(flat_ids, n_padded).T.to(torch.int32)   # (E, t*k)
    rank = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    my_rank = torch.gather(rank, 0, flat_ids[None])[0]
    keep = my_rank < cap
    e_idx = torch.where(keep, flat_ids, 0)
    c_idx = torch.where(keep, my_rank.to(flat_ids.dtype), cap - 1)
    return gates, ids, e_idx, c_idx, keep


def apply_moe(x, p, *, n_experts: int, n_padded: int, top_k: int,
              act: str = "swiglu", capacity_factor: float = 1.25,
              min_capacity: int = 4):
    """x: (B, S, d) -> ((B, S, d), aux loss).

    Static-shape dispatch: the kept ``(token, k)`` slots are scattered
    into ``(E, cap, d)`` buckets, each expert's FFN runs on its bucket,
    and the outputs are gathered back and summed over k with the gates.
    """
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    logits = matmul(xt.float(), p["router"].float())
    cap = capacity(t, top_k, n_experts, capacity_factor, min_capacity)
    gates, ids, e_idx, c_idx, keep = route(logits, n_experts, top_k, cap)

    y = _experts(xt, e_idx * cap + c_idx, keep, gates, p, n_padded, cap,
                 act)
    y = y.reshape(b, s, d).to(x.dtype)
    return y, _aux_loss(logits[:, :n_experts], ids, n_experts)


def _experts(xt, slot, keep, gates, p, n_e: int, cap: int, act: str):
    """The kept ``(token, k)`` slots through their experts → ``(t, d)``
    float32, summed over k with the gates: ``slot`` is each slot's row of
    the ``(n_e, cap, d)`` buckets.  The kept slots are copied into the
    buckets (the others onto a spare row past them, cut off), each
    expert's FFN runs on its bucket, and the rows are read back."""
    t, d = xt.shape
    top_k = gates.shape[-1]
    src = torch.repeat_interleave(xt, top_k, dim=0)             # (t*k, d)
    buckets = torch.zeros((n_e * cap + 1, d), dtype=xt.dtype,
                          device=xt.device).index_copy(
        0, torch.where(keep, slot, n_e * cap), src)
    buckets = buckets[:-1].reshape(n_e, cap, d)

    # expert FFN: (E, cap, d) x (E, d, f) -> (E, cap, f) -> (E, cap, d)
    up = matmul(buckets, p["w_up"])
    if act in ("swiglu", "geglu"):
        g = matmul(buckets, p["w_gate"])
        g = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
        up = g * up
    else:
        up = F.silu(up)
    out_b = matmul(up, p["w_down"])

    back = out_b.reshape(n_e * cap, d).index_select(
        0, torch.where(keep, slot, 0))
    back = torch.where(keep[:, None], back, torch.zeros(
        (), dtype=back.dtype, device=back.device))
    return (back.reshape(t, top_k, d).float() * gates[..., None]).sum(dim=1)


def _expert_weights(ps, mesh, d_model: int):
    """Each shard's experts whole along their d/f dim: the ZeRO-3
    ``all_gather`` over ``data`` of the leaves split there."""
    names = [n for n in ("w_up", "w_gate", "w_down")
             if n in ps.flat[0].defs]
    out = {}
    d_ff = None
    for n in names:
        w = smap(lambda p, n=n: p[n], ps)
        full = d_model if n != "w_down" else d_ff
        if w.flat[0].shape[1] != full:
            w = all_gather(w, "data", mesh, dim=1)
        if n == "w_up":
            d_ff = w.flat[0].shape[2]
        out[n] = w
    return smap(lambda *ws: dict(zip(names, ws)), *out.values())


def apply_moe_ep(xs, ps, mesh, *, n_experts: int, n_padded: int,
                 top_k: int, act: str = "swiglu",
                 capacity_factor: float = 1.25, min_capacity: int = 4,
                 dp_axes=("data",)):
    """Expert-parallel MoE over ``mesh``: ``xs`` holds each position's
    ``(B, S, d)`` tokens, replicated over ``model`` and split over
    ``dp_axes`` (``None``: replicated), ``ps`` each position's MoE
    parameters → ``(ys, auxs)``, mesh-shaped.

    Each model shard gathers its experts' d/f slices over ``data``
    (ZeRO-3), routes its data shard's tokens over every expert, keeps
    the slots of its ``E/n_model`` experts, and buckets them at the
    capacity of its *local* tokens, ``max(min_capacity, int(cf·t·k/E))``
    with no rounding to 256, so with drops the answer differs from the
    dense dispatch's by design.  One ``psum`` over ``model`` completes
    the output (float32); the aux loss is each data shard's, ``pmean``ed
    over ``dp_axes``.  When the experts are not split over ``model``
    (no such axis, size 1, or ``n_padded % n_model``), it is
    :func:`apply_moe` on the data shards' tokens gathered, each position
    keeping its own rows: the dense dispatch's answer.
    """
    d = xs.flat[0].shape[-1]
    ws = _expert_weights(ps, mesh, d)
    routers = smap(lambda p: p["router"], ps)
    e_loc = ws.flat[0]["w_up"].shape[0]
    if e_loc == n_padded:
        xg = xs if dp_axes is None else all_gather(xs, dp_axes, mesh, 0)
        kw = dict(n_experts=n_experts, n_padded=n_padded, top_k=top_k,
                  act=act, capacity_factor=capacity_factor,
                  min_capacity=min_capacity)
        out = smap(lambda x, w, r: apply_moe(x, dict(w, router=r), **kw),
                   xg, ws, routers)
        ys, auxs = unzip(out, 2)
        if dp_axes is not None:
            b = xs.flat[0].shape[0]
            ys = np.empty(xs.shape, dtype=object)
            for c in np.ndindex(*xs.shape):
                i = _axis_index(mesh, dp_axes, c)
                ys[c] = out[c][0][i * b:(i + 1) * b]
        return ys, auxs

    m_axis = mesh.axis_names.index("model")

    def shard(c):
        x, w = xs[c], ws[c]
        e0 = c[m_axis] * e_loc
        b, s, _ = x.shape
        t = b * s
        xt = x.reshape(t, d)
        logits = matmul(xt.float(), routers[c].float())
        cap = max(min_capacity, int(capacity_factor * t * top_k / n_experts))
        gates, ids, e_idx, c_idx, keep = route(logits, n_experts, top_k, cap)
        keep = keep & (e_idx >= e0) & (e_idx < e0 + e_loc)
        y = _experts(xt, (e_idx - e0) * cap + c_idx, keep, gates, w, e_loc,
                     cap, act)
        return y, _aux_loss(logits[:, :n_experts], ids, n_experts)

    out = np.empty(xs.shape, dtype=object)
    for c in np.ndindex(*xs.shape):
        out[c] = shard(c)
    ys, auxs = unzip(out, 2)
    ys = psum(ys, "model", mesh)
    ys = smap(lambda y, x: y.reshape(x.shape).to(x.dtype), ys, xs)
    if dp_axes is not None:
        auxs = pmean(auxs, dp_axes, mesh)
    return ys, auxs


def _aux_loss(logits, ids, n_experts):
    """Switch-style load-balance auxiliary loss (an id past the real
    experts counts for none, as ``jax.nn.one_hot`` gives it no hot)."""
    probs = torch.softmax(logits, dim=-1)
    hit = (ids[..., None] == torch.arange(n_experts, device=ids.device))
    frac_tokens = hit.any(dim=1).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return n_experts * torch.sum(frac_tokens * frac_probs)

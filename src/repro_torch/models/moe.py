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

The reference's expert-parallel path, ``apply_moe_ep``, returns
``apply_moe`` when there is no mesh; the port's transformer calls
:func:`apply_moe`, and the expert-parallel path comes with LM sharding
(ROADMAP Queue 1 item 8b).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import matmul
from repro_torch.models.params import ParamDef


def moe_defs(d_model: int, d_ff: int, n_experts: int, pad_to: int = 16,
             act: str = "swiglu"):
    """The MoE block's defs and its padded expert count."""
    e = ((n_experts + pad_to - 1) // pad_to) * pad_to
    defs = {
        "router": ParamDef((d_model, e)),
        "w_up": ParamDef((e, d_model, d_ff)),
        "w_down": ParamDef((e, d_ff, d_model)),
    }
    if act in ("swiglu", "geglu"):
        defs["w_gate"] = ParamDef((e, d_model, d_ff))
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

    # scatter the kept slots into (E, cap, d) buckets; the dropped ones
    # land on a spare row past them
    slot = e_idx * cap + c_idx
    src = torch.repeat_interleave(xt, top_k, dim=0)             # (t*k, d)
    buckets = torch.zeros((n_padded * cap + 1, d), dtype=x.dtype,
                          device=x.device).index_copy(
        0, torch.where(keep, slot, n_padded * cap), src)
    buckets = buckets[:-1].reshape(n_padded, cap, d)

    # expert FFN: (E, cap, d) x (E, d, f) -> (E, cap, f) -> (E, cap, d)
    up = matmul(buckets, p["w_up"])
    if act in ("swiglu", "geglu"):
        g = matmul(buckets, p["w_gate"])
        g = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
        up = g * up
    else:
        up = F.silu(up)
    out_b = matmul(up, p["w_down"])

    back = out_b.reshape(n_padded * cap, d).index_select(0, slot)
    back = torch.where(keep[:, None], back, torch.zeros(
        (), dtype=back.dtype, device=back.device))
    y = (back.reshape(t, top_k, d).float() * gates[..., None]).sum(dim=1)
    y = y.reshape(b, s, d).to(x.dtype)
    return y, _aux_loss(logits[:, :n_experts], ids, n_experts)


def _aux_loss(logits, ids, n_experts):
    """Switch-style load-balance auxiliary loss (an id past the real
    experts counts for none, as ``jax.nn.one_hot`` gives it no hot)."""
    probs = torch.softmax(logits, dim=-1)
    hit = (ids[..., None] == torch.arange(n_experts, device=ids.device))
    frac_tokens = hit.any(dim=1).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return n_experts * torch.sum(frac_tokens * frac_probs)

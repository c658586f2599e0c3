"""The online-softmax recurrence in plain PyTorch, shared by the chunked
attention path (``models/attention.flash_attention``) and the flash
kernel's plain version (``kernels/flash_attention.flash_attention_fwd_plain``).

Masked scores take the finite ``NEG_INF = -1e30``, never ``-inf``, as the
reference does: a key chunk wholly masked before a row's first valid key
adds garbage under ``m = -1e30``, which the later ``exp(m - m_new) = 0``
erases exactly; a row whose keys are all masked averages all of them.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_mask(qpos, kpos, *, causal: bool, window: int | None):
    """``(len(qpos), len(kpos))`` bool: causal ``kpos <= qpos``, window
    ``kpos > qpos - window``."""
    ok = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        ok &= kpos[None, :] > qpos[:, None] - window
    return ok


def online_softmax(q_blk, qpos, k, v, *, kv_chunk: int, causal: bool,
                   window: int | None, scale: float):
    """One query block against all keys, ``kv_chunk`` keys at a time,
    carrying ``(acc, m, l)`` in float32 from chunk to chunk.

    q_blk ``(B, Sq, KV, G, hd)`` float32 at positions ``qpos``; k and v
    ``(B, Sk, KV, hd)`` at positions ``0..Sk-1`` (cast to float32 per
    chunk).  Returns acc ``(B, KV, G, Sq, hd)`` and m, l ``(B, KV, G, Sq)``,
    unnormalised: the output is ``acc / max(l, 1e-30)``."""
    state = softmax_init(q_blk)
    for k0 in range(0, k.shape[1], kv_chunk):
        state = softmax_step(state, q_blk, qpos, k, v, k0, kv_chunk=kv_chunk,
                             causal=causal, window=window, scale=scale)
    acc, m, l, _ = state
    return acc, m, l


def softmax_init(q_blk):
    """The carry ``(acc, m, l, neg)`` before the first key chunk."""
    b, sq, kv, g, hd = q_blk.shape
    dev = q_blk.device
    neg = torch.tensor(NEG_INF, device=dev)
    m = torch.full((b, kv, g, sq), NEG_INF, device=dev)
    l = torch.zeros((b, kv, g, sq), device=dev)
    acc = torch.zeros((b, kv, g, sq, hd), device=dev)
    return acc, m, l, neg


def softmax_step(state, q_blk, qpos, k, v, k0: int, *, kv_chunk: int,
                 causal: bool, window: int | None, scale: float):
    """The carry after the key chunk at ``k0``."""
    acc, m, l, neg = state
    kc = k[:, k0:k0 + kv_chunk].float()
    vc = v[:, k0:k0 + kv_chunk].float()
    kpos = torch.arange(k0, k0 + kc.shape[1], device=q_blk.device)
    sc = torch.einsum("bqkgd,bskd->bkgqs", q_blk, kc) * scale
    ok = attention_mask(qpos, kpos, causal=causal, window=window)
    sc = torch.where(ok[None, None, None], sc, neg)
    m_new = torch.maximum(m, sc.amax(dim=-1))
    p = torch.exp(sc - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vc)
    return acc, m_new, l, neg

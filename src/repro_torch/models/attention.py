"""Attention in plain PyTorch: the dense oracle, the chunked online-softmax
path, and the cached single-token decode.

Counterpart of the reference's ``repro/models/attention.py``; none of
these is a kernel there either.  ``dense_attention`` is the oracle every
other path is held to, ``flash_attention`` the chunked impl, and the
CUDA kernel lives in ``kernels/flash_attention.py``.  Layouts are the
reference's: q ``(B, S, H, hd)``, k and v ``(B, Sk, KV, hd)``, query
head ``h`` reads kv head ``h // (H // KV)``.  Every path computes in
float32 and casts the output to q's dtype once.

Masked scores take the finite ``NEG_INF = -1e30``, never ``-inf``: a
row whose keys are all masked then averages all of them, as the
reference does, instead of giving NaN.  The mask and the online-softmax
recurrence are ``core/online_softmax.py``'s, shared with the flash
kernel's plain version.

``cache_update`` writes the caches in place (the reference returns new
arrays; its serving loop donates the old ones) and returns them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.online_softmax import (NEG_INF, attention_mask,
                                             online_softmax)


def dense_attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """Reference/small-sequence path. q:(B,S,H,hd) k,v:(B,Sk,KV,hd)."""
    b, s, h, hd = q.shape
    _, sk, kv, _ = k.shape
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    q5 = q.reshape(b, s, kv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q5.float(), k.float()) * scale
    qpos = torch.arange(s, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    ok = attention_mask(qpos, kpos, causal=causal, window=window)
    scores = torch.where(ok[None, None, None], scores,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def flash_attention(q, k, v, *, causal=True, window=None, q_chunk=512,
                    kv_chunk=1024, q_offset=0):
    """Online-softmax chunked attention; memory O(q_chunk · kv_chunk).
    Falls back to :func:`dense_attention` when ``S <= q_chunk`` or the
    chunks do not divide the sequences, as the reference does."""
    b, s, h, hd = q.shape
    _, sk, kv, _ = k.shape
    g = h // kv
    if s % q_chunk or sk % kv_chunk or s <= q_chunk:
        return dense_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    q5 = q.reshape(b, s // q_chunk, q_chunk, kv, g, hd).float()
    kf, vf = k.float(), v.float()
    outs = [q_block(q5, iq, kf, vf, kv_chunk=kv_chunk, causal=causal,
                    window=window, q_offset=q_offset)
            for iq in range(s // q_chunk)]
    return torch.stack(outs, dim=1).reshape(b, s, h, hd).to(q.dtype)


def q_block(q5, iq: int, kf, vf, *, kv_chunk: int, causal: bool,
            window: int | None, q_offset: int = 0):
    """Query block ``iq`` of :func:`flash_attention` against every key
    chunk → ``(b, qc, kv, g, hd)`` float32."""
    q_chunk, hd = q5.shape[2], q5.shape[-1]
    qpos = (iq * q_chunk + torch.arange(q_chunk, device=q5.device)
            + q_offset)
    acc, _, l = online_softmax(q5[:, iq], qpos, kf, vf, kv_chunk=kv_chunk,
                               causal=causal, window=window,
                               scale=1.0 / math.sqrt(hd))
    out = acc / torch.clamp(l[..., None], min=1e-30)
    # (b, kv, g, qc, hd) -> (b, qc, kv, g, hd)
    return out.permute(0, 3, 1, 2, 4)


def decode_attention(q, k_cache, v_cache, length, *, slot_pos=None,
                     window=None):
    """Single-token attention over a cache.

    q: (B, 1, H, hd); k/v_cache: (B, S_cache, KV, hd); length: int —
    number of valid cache entries (synchronized batch decode).
    slot_pos: (S_cache,) absolute position of each slot for rolling (SWA)
    caches; default slot i holds position i.
    """
    b, _, h, hd = q.shape
    _, sc, kv, _ = k_cache.shape
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    q4 = q.reshape(b, kv, g, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", q4.float(),
                          k_cache.float()) * scale
    pos = (torch.arange(sc, device=q.device) if slot_pos is None
           else slot_pos)
    ok = (pos < length) & (pos >= 0)
    if window is not None:
        ok &= pos > length - 1 - window
    scores = torch.where(ok[None, None, None], scores,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


def _update_at(n: int, size: int, at: int) -> int:
    """``dynamic_update_slice``'s start: clamped so ``n`` entries fit."""
    return min(max(at, 0), size - n)


def cache_update(k_cache, v_cache, k_new, v_new, pos, *, window=None):
    """Insert (B, n, KV, hd) new entries at ``pos`` (rolling when
    windowed), in place; returns ``(k_cache, v_cache)``.  Slot
    bookkeeping for windowed caches is :func:`rolling_slot_pos`."""
    sc = k_cache.shape[1]
    n = k_new.shape[1]
    at = _update_at(n, sc, pos % sc if window is not None else pos)
    k_cache[:, at:at + n] = k_new.to(k_cache.dtype)
    v_cache[:, at:at + n] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def rolling_slot_pos(slot_pos, pos, n, cache_len):
    """The absolute-position map after a rolling cache insert (a new
    tensor; ``slot_pos`` is left as it was)."""
    at = _update_at(n, slot_pos.shape[0], pos % cache_len)
    out = slot_pos.clone()
    out[at:at + n] = pos + torch.arange(n, dtype=slot_pos.dtype,
                                        device=slot_pos.device)
    return out

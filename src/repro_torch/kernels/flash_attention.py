"""Flash attention, forward, on the card: the wrapper of the CUDA kernel
(``csrc/flash_attention.cu``) and its plain PyTorch version.

Counterpart of the reference's Pallas kernels
``repro/kernels/flash_attention.py::_kernel`` (launched by
``flash_attention_pallas``) and ``::_fwd_kernel_lse`` (launched by
``flash_attention_pallas_fwd``): one CUDA source ports both, as two
instantiations on whether the per-row logsumexp is written.

    out, lse = flash_attention_fwd(q, k, v, causal=True, window=4096)

q is ``(B, S, H, hd)``, k and v ``(B, Sk, KV, hd)``; out is
``(B, S, H, hd)`` in q's dtype and lse ``(B, H, S)`` float32,
``m + log(max(l, 1e-30))`` per row (None when ``with_lse=False``).

  * On a CUDA tensor, :func:`flash_attention_fwd` launches the kernel (or
    raises) and adds one to ``flash_attention_fwd.launches``.  The kernel
    reads float32 or bfloat16, any ``head_dim`` that is a multiple of 16
    up to 256, in place through the strides (the last dim must be dense).
  * On a CPU tensor it runs :func:`flash_attention_fwd_plain`, the same
    online softmax over kv chunks in plain torch.  No CUDA tensor ever
    takes the plain version.

The reference's ``q_chunk``/``kv_chunk`` do not reach the kernel: its
tile (64 queries × 64 keys) is its own.  The chunk sizes stay in
``AttentionSpec``, whose divisibility contract the program enforces.
The backward kernel (the reference's ``_bwd_kernel``) is slice 4 of the
port (ROADMAP Queue 2 item 5).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.online_softmax import online_softmax
from repro_torch.kernels import _build

MAX_HEAD_DIM = 256      # FA_MAX_HD in csrc/flash_attention.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_head_dim(hd: int) -> None:
    if hd < 16 or hd > MAX_HEAD_DIM or hd % 16:
        raise ValueError(
            f"the CUDA flash kernel takes head_dim in multiples of 16 up "
            f"to {MAX_HEAD_DIM}; got {hd}")


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"attention inputs are rank-4 (B, S, heads, head_dim); got "
            f"q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k and v must be (B, Sk, KV, {hd}) with q's B; "
                         f"got k{tuple(k.shape)} v{tuple(v.shape)}")
    if k.shape[2] < 1 or h % k.shape[2]:
        raise ValueError(f"GQA needs kv_heads | heads: got heads={h}, "
                         f"kv_heads={k.shape[2]}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def flash_attention_fwd_plain(q, k, v, *, causal=True, window=None,
                              kv_chunk=512):
    """The plain version: online softmax over kv chunks in float32,
    carrying ``(m, l, acc)`` from chunk to chunk as the kernel carries
    them from tile to tile; returns ``(out, lse)`` as the kernel does."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    acc, m, l = online_softmax(
        q.reshape(b, s, kv, h // kv, hd).float(),
        torch.arange(s, device=q.device), k, v, kv_chunk=kv_chunk,
        causal=causal, window=window, scale=1.0 / math.sqrt(hd))
    l = torch.clamp(l, min=1e-30)
    out = (acc / l[..., None]).permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)
    lse = (m + torch.log(l)).reshape(b, h, s)
    return out.to(q.dtype), lse


def flash_attention_fwd(q, k, v, *, causal=True, window=None,
                        with_lse=True):
    """Forward flash attention → ``(out, lse)`` (lse None unless
    ``with_lse``).  CUDA tensors go to the kernel, CPU tensors to the
    plain version (see the module docstring)."""
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"sliding window must be >= 1 token, got {window}")
    if q.device.type == "cpu":
        out, lse = flash_attention_fwd_plain(q, k, v, causal=causal,
                                             window=window)
        return out, (lse if with_lse else None)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu tensors, "
                         f"got {q.device}")
    out, lse = _launch(q, k, v, causal, window, with_lse)
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, *, causal=True, window=None):
    """The output alone: the kernel's lse-off instantiation (the
    reference's ``flash_attention_pallas``)."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               with_lse=False)[0]


_ARGTYPES = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
             + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_float,
                                     ctypes.c_void_p])


def _launch(q, k, v, causal, window, with_lse):
    b, s, h, hd = q.shape
    _, sk, kv, _ = k.shape
    check_head_dim(hd)
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(
            f"the CUDA flash kernel reads float32 or bfloat16 q, k and v of "
            f"one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s head_dim must be dense (stride 1), "
                             f"got strides {x.stride()}")
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = (ctypes.c_longlong * 12)(*(
        x.stride(i) for x in (q, k, v, out) for i in range(3)))
    lib = _build.library("flash_attention")
    fn = lib.flash_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], int(with_lse), q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if with_lse else None, b, s, sk, h, kv, hd,
                 ctypes.cast(strides, ctypes.c_void_p), int(causal),
                 0 if window is None else int(window),
                 1.0 / math.sqrt(hd), stream)
    if err != 0:
        lib.flash_error_string.restype = ctypes.c_char_p
        lib.flash_error_string.argtypes = [ctypes.c_int]
        msg = lib.flash_error_string(err).decode()
        raise RuntimeError(
            f"flash_attention launch failed ({msg}): q{tuple(q.shape)} "
            f"k{tuple(k.shape)} {q.dtype} causal={causal} window={window}")
    return out, lse


def smem_bytes(hd: int) -> int:
    """Shared memory one CTA of the kernel takes at ``hd``, as the
    library computes it (builds the library if needed)."""
    fn = _build.library("flash_attention").flash_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(hd)

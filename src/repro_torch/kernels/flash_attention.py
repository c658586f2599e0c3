"""Flash attention on the card: the wrappers of the CUDA forward kernels
(``csrc/flash_attention_mma.cu`` for bfloat16,
``csrc/flash_attention_tf32.cu`` for float32) and backward kernels
(``csrc/flash_attention_bwd_mma.cu`` for bfloat16,
``csrc/flash_attention_bwd_tf32.cu`` for float32), their plain PyTorch
versions, and the autograd function that joins them.

Counterpart of the reference's Pallas kernels
``repro/kernels/flash_attention.py::_kernel`` (launched by
``flash_attention_pallas``) and ``::_fwd_kernel_lse`` (launched by
``flash_attention_pallas_fwd``): each forward source ports both, as two
instantiations on whether the per-row logsumexp is written.  All four
sources run mma.sync on the tensor cores: bfloat16 inputs
``csrc/flash_attention_mma.cu`` (p carried as a bf16 hi/lo pair),
float32 inputs ``csrc/flash_attention_tf32.cu`` (3xTF32: every operand
split into TF32 hi and lo, three mma a product).  The reference's
``::_bwd_kernel`` (``flash_attention_pallas_bwd``) becomes two
kernels, one query-major for dq and one key-major for dk and dv (summed
over each GQA group in the kernel), in two sources: bfloat16 inputs run
``csrc/flash_attention_bwd_mma.cu`` (p and ds carried as bf16 hi/lo
pairs), float32 inputs ``csrc/flash_attention_bwd_tf32.cu`` (3xTF32).
Its ``custom_vjp`` becomes :func:`flash_attention_trainable`.

    out, lse = flash_attention_fwd(q, k, v, causal=True, window=4096)

q is ``(B, S, H, hd)``, k and v ``(B, Sk, KV, hd)``; out is
``(B, S, H, hd)`` in q's dtype and lse ``(B, H, S)`` float32,
``m + log(max(l, 1e-30))`` per row (None when ``with_lse=False``).

  * On a CUDA tensor, :func:`flash_attention_fwd` launches the kernel of
    the inputs' dtype (or raises) and adds one to
    ``flash_attention_fwd.launches`` whichever source runs.  Both read any
    ``head_dim`` that is a multiple of 16 up to 256, in place through the
    strides (the last dim must be dense).  Both kernels copy rows by 16
    bytes: an input whose rows are not 16-byte aligned is copied to a
    contiguous tensor first, and each copy adds one to
    ``flash_attention_fwd.copies``.  Nothing falls back: a build or
    launch error raises.
  * On a CPU tensor it runs :func:`flash_attention_fwd_plain`, the same
    online softmax over kv chunks in plain torch.  No CUDA tensor ever
    takes the plain version.

    dq, dk, dv = flash_attention_bwd(q, k, v, do, out, lse, causal=True,
                                     window=4096)

  * On a CUDA tensor, :func:`flash_attention_bwd` makes ``delta =
    rowsum(do * out)`` in torch (as the reference does outside its
    kernel) and launches the dQ kernel (``flash_attention_bwd_dq``) and
    the dK/dV kernel (``flash_attention_bwd_dkdv``) of the inputs'
    dtype, each adding one to its own ``.launches`` whichever source
    runs.  dq, dk and dv come back in the inputs' dtype.  The kernels
    copy rows by 16 bytes: an input whose rows are not 16-byte aligned
    is copied to a contiguous tensor first, and each copy adds one to
    ``flash_attention_bwd.copies``.  Nothing falls back: a build or
    launch error raises.
  * On a CPU tensor it runs :func:`flash_attention_bwd_plain`, the same
    closed form over kv chunks in float32, with no S × Sk tensor and no
    autograd of the plain forward.

A query row that keeps no key (possible only when S >= Sk + window)
gets no gradient from the backward, as in the reference's kernel; the
dense oracle's autograd would give dv a share of its uniform average.

The reference's ``q_chunk``/``kv_chunk`` do not reach the kernels: their
tiles (:func:`fwd_tiles` and :func:`bwd_tiles`, per dtype) are their
own.  The chunk
sizes stay in ``AttentionSpec``, whose divisibility contract the program
enforces.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.online_softmax import attention_mask, online_softmax
from repro_torch.kernels import _build

MAX_HEAD_DIM = 256      # FFM_MAX_HD in csrc/flash_attention_mma.cu,
                        # FFT_MAX_HD in csrc/flash_attention_tf32.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_head_dim(hd: int) -> None:
    if hd < 16 or hd > MAX_HEAD_DIM or hd % 16:
        raise ValueError(
            f"the CUDA flash kernel takes head_dim in multiples of 16 up "
            f"to {MAX_HEAD_DIM}; got {hd}")


def launch_refusal(head_dim: int, dtype: torch.dtype) -> str | None:
    """Why the CUDA flash kernels refuse ``head_dim`` or ``dtype`` (what
    their launch would raise), or ``None`` where the forward and the
    backward kernels both launch: the limits of :func:`check_head_dim`
    and the dtypes the route tables (``_FWD_ROUTES``, ``_BWD_ROUTES``)
    hold."""
    try:
        check_head_dim(head_dim)
    except ValueError as e:
        return str(e)
    routes = [d for d in _FWD_ROUTES if d in _BWD_ROUTES]
    if dtype not in routes:
        return (f"the CUDA flash kernels read "
                f"{' or '.join(str(d).removeprefix('torch.') for d in routes)}"
                f" q, k and v; got {str(dtype).removeprefix('torch.')}")
    return None


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
    q, k, v = (_rows_aligned_or_copy(x, flash_attention_fwd)
               for x in (q, k, v))
    out, lse = _launch(q, k, v, causal, window, with_lse)
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.copies = 0


def flash_attention(q, k, v, *, causal=True, window=None):
    """The output alone: the kernel's lse-off instantiation (the
    reference's ``flash_attention_pallas``)."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               with_lse=False)[0]


# the forward kernels per dtype: (library, C entry point, its error
# string); both entry points take the same arguments
_FWD_ROUTES = {torch.bfloat16: ("flash_attention_mma", "flash_fwd_mma",
                                "flash_fwd_mma_error_string"),
               torch.float32: ("flash_attention_tf32", "flash_fwd_tf32",
                               "flash_fwd_tf32_error_string")}
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
        if not _rows_aligned(x):
            raise ValueError(
                f"the forward kernels need 16-byte aligned rows: "
                f"{name} has pointer {x.data_ptr():#x} and strides "
                f"{x.stride()} (flash_attention_fwd copies such inputs)")
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = (ctypes.c_longlong * 12)(*(
        x.stride(i) for x in (q, k, v, out) for i in range(3)))
    name, entry, errors = _FWD_ROUTES[q.dtype]
    lib = _build.library(name)
    fn = getattr(lib, entry)
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
        errstr = getattr(lib, errors)
        errstr.restype = ctypes.c_char_p
        errstr.argtypes = [ctypes.c_int]
        msg = errstr(err).decode()
        raise RuntimeError(
            f"flash_attention launch failed ({msg}): q{tuple(q.shape)} "
            f"k{tuple(k.shape)} {q.dtype} causal={causal} window={window}")
    return out, lse


def smem_bytes(hd: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory one CTA of the ``dtype`` forward kernel takes at
    ``hd``, as the library computes it (builds the library if needed)."""
    name, entry, _ = _FWD_ROUTES[dtype]
    fn = getattr(_build.library(name), entry + "_smem_bytes")
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(hd)


def hd_bound(hd: int) -> int:
    """The head-dim bound of the kernel instantiation that serves ``hd``
    in every flash source (64, 80, 128 or 256: the template argument its
    ptxas names carry); it runs every hd up to the bound."""
    return 64 if hd <= 64 else 80 if hd <= 80 else 128 if hd <= 128 else 256


def fwd_tiles(hd: int, dtype: torch.dtype = torch.bfloat16
              ) -> tuple[int, int]:
    """The ``dtype`` forward kernel's (queries, keys) tile at ``hd``, as
    its source instantiates it: the bfloat16 kernel
    (``csrc/flash_attention_mma.cu``) takes 32-key tiles above hd 128,
    where the accumulators take 128 registers a thread; the float32 one
    (``csrc/flash_attention_tf32.cu``), whose tiles take twice the bytes
    and whose split operands and accumulators twice the registers, above
    hd 80."""
    if dtype == torch.float32:
        return 64, (64 if hd_bound(hd) <= 80 else 32)
    return 64, (64 if hd_bound(hd) <= 128 else 32)


def fwd_key_tile_range(q0: int, s: int, sk: int, bq: int, bk: int, *,
                       causal: bool, window: int | None) -> tuple[int, int]:
    """The key tiles ``[t_lo, t_hi)`` the forward kernels run for the
    query tile starting at row ``q0``, as ``csrc/flash_attention_mma.cu``
    and ``csrc/flash_attention_tf32.cu`` compute them: the keys its rows keep,
    or every key tile when one of its rows keeps no key (S ≥ Sk + window),
    so that such a row averages all keys."""
    win = window or 0
    q_last = min(q0 + bq, s) - 1
    k_lo, k_hi = 0, sk
    if not (win and q_last >= sk + win - 1):
        if win:
            k_lo = max(0, q0 - win + 1)
        if causal:
            k_hi = min(sk, q_last + 1)
    return k_lo // bk, -(-k_hi // bk)


def fwd_issued_flops(s: int, sk: int, h: int, kv: int, hd: int, *,
                     causal: bool, window: int | None,
                     dtype: torch.dtype = torch.bfloat16) -> int:
    """Tensor-core flops the ``dtype`` forward kernel issues for one batch
    row: every (query, key) pair of every tile it runs, ragged edges and
    masked pairs included, over ``fwd_key_tile_range``: ``6·hd`` in
    bfloat16 (``q·kᵀ``, then ``p·v`` twice for the hi/lo pair), ``12·hd``
    in float32 (both products three times, 3xTF32).  ``kv`` does not
    change the count: each query head runs its own tiles."""
    bq, bk = fwd_tiles(hd, dtype)
    per_pair = 12 * hd if dtype == torch.float32 else 6 * hd
    tiles = 0
    for q0 in range(0, s, bq):
        t_lo, t_hi = fwd_key_tile_range(q0, s, sk, bq, bk, causal=causal,
                                        window=window)
        tiles += t_hi - t_lo
    return h * tiles * bk * bq * per_pair


# ------------------------------------------------------------- backward ----
def _check_bwd(q, k, v, do, out, lse) -> None:
    _check(q, k, v)
    b, s, h, _ = q.shape
    if do.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"do and out must match q{tuple(q.shape)}; got "
                         f"do{tuple(do.shape)} out{tuple(out.shape)}")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({b}, {h}, {s}) float32 (the "
                         f"forward's); got {tuple(lse.shape)} {lse.dtype}")
    if not (q.device == do.device == out.device == lse.device):
        raise ValueError("q, do, out and lse must be on one device")


def flash_attention_bwd_plain(q, k, v, do, out, lse, *, causal=True,
                              window=None):
    """The plain version: the reference kernel's closed form over kv
    chunks of 512 in float32 (float64 for float64 inputs) — ``p = exp(s
    - lse)`` where the mask keeps (else 0), ``ds = p·(do·vᵀ − δ)·scale``
    with ``δ = rowsum(do∘out)``, then ``dq = Σ ds·k``, ``dk = Σ dsᵀ·q``
    and ``dv = Σ pᵀ·do`` summed over each GQA group — with no S × Sk
    tensor and no autograd.  Returns ``(dq, dk, dv)`` in the inputs'
    dtypes."""
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    cd = torch.float64 if q.dtype == torch.float64 else torch.float32
    kv_chunk = 512
    qf = q.to(cd).reshape(b, s, kv, g, hd)
    dof = do.to(cd).reshape(b, s, kv, g, hd)
    delta = (dof * out.to(cd).reshape(b, s, kv, g, hd)).sum(-1)
    delta = delta.permute(0, 2, 3, 1)[..., None]           # (b, kv, g, s, 1)
    lse5 = lse.to(cd).reshape(b, kv, g, s)[..., None]
    qpos = torch.arange(s, device=dev)
    dq = torch.zeros((b, kv, g, s, hd), dtype=cd, device=dev)
    dk = torch.empty((b, sk, kv, hd), dtype=cd, device=dev)
    dv = torch.empty((b, sk, kv, hd), dtype=cd, device=dev)
    for k0 in range(0, sk, kv_chunk):
        kc = k[:, k0:k0 + kv_chunk].to(cd)
        vc = v[:, k0:k0 + kv_chunk].to(cd)
        ok = attention_mask(qpos, torch.arange(k0, k0 + kc.shape[1],
                                               device=dev),
                            causal=causal, window=window)
        sc = torch.einsum("bqkgd,bskd->bkgqs", qf, kc) * scale
        p = torch.where(ok, torch.exp(sc - lse5), 0.0)
        dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vc)
        ds = p * (dp - delta) * scale
        dq += torch.einsum("bkgqs,bskd->bkgqd", ds, kc)
        dk[:, k0:k0 + kc.shape[1]] = torch.einsum("bkgqs,bqkgd->bskd", ds,
                                                  qf)
        dv[:, k0:k0 + kc.shape[1]] = torch.einsum("bkgqs,bqkgd->bskd", p,
                                                  dof)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, do, out, lse, *, causal=True, window=None):
    """The gradients of :func:`flash_attention_fwd` at (q, k, v) against
    the cotangent ``do``, from its ``out`` and ``lse`` → ``(dq, dk, dv)``
    in the inputs' dtypes.  CUDA tensors go to the two kernels, CPU
    tensors to the plain version (see the module docstring)."""
    _check_bwd(q, k, v, do, out, lse)
    if window is not None and window < 1:
        raise ValueError(f"sliding window must be >= 1 token, got {window}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, out, lse,
                                         causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors, "
                         f"got {q.device}")
    q, k, v, do = (_rows_aligned_or_copy(x, flash_attention_bwd)
                   for x in (q, k, v, do))
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    flash_attention_bwd_dq(q, k, v, do, lse, delta, dq, causal=causal,
                           window=window)
    flash_attention_bwd_dkdv(q, k, v, do, lse, delta, dk, dv, causal=causal,
                             window=window)
    return dq, dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, dq, *, causal, window):
    """Launch the dQ kernel (CUDA tensors only) into ``dq``."""
    # the dQ kernel touches no dk/dv: dq stands in for them
    _launch_bwd(0, q, k, v, do, lse, delta, dq, dq, dq, causal, window)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, dk, dv, *, causal,
                             window):
    """Launch the dK/dV kernel (CUDA tensors only) into ``dk`` and ``dv``."""
    # the dK/dV kernel touches no dq: dk stands in for it
    _launch_bwd(1, q, k, v, do, lse, delta, dk, dk, dv, causal, window)
    flash_attention_bwd_dkdv.launches += 1
    return dk, dv


flash_attention_bwd.copies = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkdv.launches = 0

# the backward kernels per dtype: (library, C entry point); both entry
# points take the same arguments
_BWD_ROUTES = {torch.bfloat16: ("flash_attention_bwd_mma", "flash_bwd_mma"),
               torch.float32: ("flash_attention_bwd_tf32", "flash_bwd_tf32")}
_BWD_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
                 + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_float,
                                         ctypes.c_void_p])


def _rows_aligned(x) -> bool:
    """Whether the kernels' 16-byte copies reach every row of ``x`` in
    place: a 16-byte aligned pointer and (batch, seq, head) strides in
    multiples of 16 bytes (where the dim is longer than 1)."""
    return x.data_ptr() % 16 == 0 and all(
        x.stride(i) * x.element_size() % 16 == 0 or x.shape[i] == 1
        for i in range(3))


def _rows_aligned_or_copy(x, counted_in):
    """``x``, or a contiguous copy of it when its rows are not 16-byte
    aligned; each copy adds one to ``counted_in.copies`` (the wrapper
    that asked, :func:`flash_attention_fwd` or :func:`flash_attention_bwd`).
    A last dim that is not dense is left for the launch to refuse."""
    if x.stride(3) != 1 or _rows_aligned(x):
        return x
    counted_in.copies += 1
    return x.clone(memory_format=torch.contiguous_format)


def _bwd_call_args(kernel, q, k, v, do, lse, delta, dq, dk, dv, causal,
                   window, stream):
    """The C arguments of one backward kernel call; checks what the
    kernels do not take.  (The strides array is kept alive by the
    caller.)"""
    b, s, h, hd = q.shape
    _, sk, kv, _ = k.shape
    check_head_dim(hd)
    tensors = (q, k, v, do, dq, dk, dv)
    if q.dtype not in _DTYPE_CODE or any(x.dtype != q.dtype
                                         for x in tensors):
        raise ValueError(
            f"the CUDA flash kernels read float32 or bfloat16 q, k, v and do "
            f"of one dtype; got {[x.dtype for x in tensors]}")
    for name, x in zip(("q", "k", "v", "do", "dq", "dk", "dv"), tensors):
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s head_dim must be dense (stride 1), "
                             f"got strides {x.stride()}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (b, h, s) or x.dtype != torch.float32 \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({b}, {h}, {s}) "
                             f"float32 tensor")
    for name, x in zip(("q", "k", "v", "do", "dq", "dk", "dv"), tensors):
        if not _rows_aligned(x):
            raise ValueError(
                f"the backward kernels need 16-byte aligned rows: {name} "
                f"has pointer {x.data_ptr():#x} and strides {x.stride()} "
                f"(flash_attention_bwd copies such inputs)")
    strides = (ctypes.c_longlong * 21)(*(
        x.stride(i) for x in tensors for i in range(3)))
    args = (kernel, _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, sk, h, kv, hd,
            ctypes.cast(strides, ctypes.c_void_p), int(causal),
            0 if window is None else int(window), 1.0 / math.sqrt(hd), stream)
    return args, strides


def _launch_bwd(kernel, q, k, v, do, lse, delta, dq, dk, dv, causal,
                window):
    if not all(x.device.type == "cuda" for x in (q, k, v, do, lse, delta,
                                                   dq, dk, dv)):
        raise ValueError("the flash backward kernels take CUDA tensors only "
                         "(flash_attention_bwd runs the plain version on "
                         "the CPU)")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args, strides = _bwd_call_args(kernel, q, k, v, do, lse, delta, dq,
                                       dk, dv, causal, window, stream)
        name, prefix = _BWD_ROUTES[q.dtype]
        lib = _build.library(name)
        fn = getattr(lib, prefix)
        fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
        err = fn(*args)
    if err != 0:
        errstr = getattr(lib, prefix + "_error_string")
        errstr.restype = ctypes.c_char_p
        errstr.argtypes = [ctypes.c_int]
        msg = errstr(err).decode()
        raise RuntimeError(
            f"flash_attention backward launch failed ({msg}): "
            f"q{tuple(q.shape)} k{tuple(k.shape)} {q.dtype} causal={causal} "
            f"window={window}")


def bwd_smem_bytes(kernel: int, hd: int,
                   dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory one CTA of the ``dtype`` backward kernel ``kernel``
    (0 dQ, 1 dK/dV) takes at ``hd`` (builds the library if needed)."""
    name, prefix = _BWD_ROUTES[dtype]
    fn = getattr(_build.library(name), prefix + "_smem_bytes")
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return fn(kernel, hd)


def bwd_tiles(hd: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The ``dtype`` backward kernels' tiles at ``hd``, as their source
    instantiates them: dQ's (queries, keys), dK/dV's (keys, queries), and
    the dK/dV columns summed per pass (s and dp are recomputed once per
    pass).  The float32 kernels (``csrc/flash_attention_bwd_tf32.cu``),
    whose tiles take twice the bytes and whose split operands and
    accumulators twice the registers, stream shorter tiles than the
    bfloat16 ones (``csrc/flash_attention_bwd_mma.cu``)."""
    bound = hd_bound(hd)
    if dtype == torch.float32:
        return dict(dq=(64, 32 if bound <= 128 else 16),
                    dkdv=(64, 32 if bound == 64 else 16),
                    columns_per_pass=min(bound, 128))
    return dict(dq=(64, 64 if bound <= 128 else 32),
                dkdv=(64, 64 if bound <= 80 else 32),
                columns_per_pass=min(bound, 128))


def bwd_issued_flops(s: int, sk: int, h: int, kv: int, hd: int, *,
                     causal: bool, window: int | None,
                     dtype: torch.dtype = torch.bfloat16) -> int:
    """Tensor-core flops the ``dtype`` backward kernels issue for one
    batch row: every (query, key) pair of every tile they run, ragged
    edges and masked pairs included, over the kernels' own tile ranges.
    bfloat16: ``8·hd`` in dQ (s, dp, and ds·k as a hi/lo pair) and
    ``(4·passes + 8)·hd`` in dK/dV (s and dp per pass, pᵀ·do and dsᵀ·q as
    hi/lo pairs).  float32, every product three times (3xTF32): ``18·hd``
    in dQ and ``(12·passes + 12)·hd`` in dK/dV."""
    t = bwd_tiles(hd, dtype)
    win = window or 0
    (bq, bk), (ck, cq) = t["dq"], t["dkdv"]
    passes = -(-hd // t["columns_per_pass"])
    dq_pairs = 0
    for q0 in range(0, s, bq):
        k_lo = max(0, q0 - win + 1) if win else 0
        k_hi = min(sk, min(q0 + bq, s)) if causal else sk
        if k_hi > k_lo:
            dq_pairs += (-(-k_hi // bk) - k_lo // bk) * bk * bq
    dkdv_pairs = 0
    for k0 in range(0, sk, ck):
        q_lo = k0 if causal else 0
        q_hi = min(s, min(k0 + ck, sk) - 1 + win) if win else s
        if q_hi > q_lo:
            dkdv_pairs += (-(-q_hi // cq) - q_lo // cq) * cq * ck
    if dtype == torch.float32:
        return (h * dq_pairs * 18 * hd
                + h * dkdv_pairs * (12 * passes + 12) * hd)
    return (h * dq_pairs * 8 * hd
            + h * dkdv_pairs * (4 * passes + 8) * hd)


# ------------------------------------------------------------- autograd ----
class _FlashAttention(torch.autograd.Function):
    """Forward: the lse-on kernel instantiation; backward: the two
    backward kernels (the plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(3) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, do, out, lse,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_trainable(q, k, v, *, causal=True, window=None):
    """Differentiable flash attention: the counterpart of the reference's
    ``custom_vjp`` ``flash_attention_trainable``.  Saves q, k, v, out and
    lse for the backward."""
    return _FlashAttention.apply(q, k, v, causal, window)

"""``AttentionProgram``: the compile-once front door for attention.

Counterpart of the reference's ``repro/api/attention.py``.  An attention
configuration (heads, GQA groups, mask, chunking, dtype policy) is
resolved once into an immutable :class:`AttentionProgram`, memoized in a
bounded cache, and every execution surface dispatches through it:

    prog = compile_attention(heads=8, kv_heads=2, head_dim=64)
    out  = prog.apply(q, k, v)           # (B, S, H, hd), differentiable
    dq, dk, dv = prog.grad(q, k, v, do)  # its VJP against do

Implementation selection (``impl=``):

  * ``"cuda"``    — the hand-written CUDA flash kernels through
    ``kernels/flash_attention.flash_attention_trainable`` (the forward
    kernel, and the backward kernels under autograd; the reference's
    ``"pallas"``).  It refuses chunk-undivisible sequences with the
    reference's message.  On a CPU tensor the kernels' wrappers run
    their plain versions.
  * ``"chunked"`` — the plain-torch online-softmax path
    (``models/attention.flash_attention``).
  * ``"dense"``   — ``models/attention.dense_attention``, the oracle.
  * ``"auto"``    — ``"cuda"`` where the kernels launch: chunk-divisible
    shapes on a CUDA tensor, a head_dim and dtype the kernels take
    (``flash_attention.launch_refusal``); ``"chunked"`` otherwise (the
    reference picks Pallas when not in interpret mode; here the tensor's
    device decides, per call).

Semantics are the dense oracle's: causal keeps key ≤ query position, a
window keeps ``kpos > qpos - window``, query head ``h`` reads kv head
``h // (heads // kv_heads)``.  ``dtype`` is q/k/v storage; every impl
computes in float32 and casts the output back once.

``.apply`` is differentiable in q, k and v under every impl, and
``AttentionProgram.grad`` returns its VJP: for ``"cuda"`` the forward
kernel (with the lse) and the two backward kernels through
``flash_attention_trainable``, for the other impls torch autograd of the
plain path.  Importing this module initializes no CUDA context.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.api.program import ProgramCache

IMPLS = ("auto", "cuda", "chunked", "dense")

ATTN_PROGRAM_CACHE = ProgramCache(64, "attention_programs")


def attention_cache_stats() -> dict:
    """Hit/miss/size counters of the program cache.  (The reference also
    keeps a cache of jitted runners; eager torch has nothing to jit.)"""
    return {ATTN_PROGRAM_CACHE.name: ATTN_PROGRAM_CACHE.stats()}


def clear_attention_caches() -> None:
    ATTN_PROGRAM_CACHE.clear()


# ============================================================ AttentionSpec ==
@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """The structural identity of an attention configuration.  Hashable
    (part of the program cache key)."""
    heads: int
    kv_heads: int
    head_dim: int
    causal: bool = True
    window: int | None = None
    q_chunk: int = 256
    kv_chunk: int = 512

    @property
    def groups(self) -> int:
        """GQA group size: query heads per kv head."""
        return self.heads // self.kv_heads

    @property
    def signature(self) -> tuple:
        return (self.heads, self.kv_heads, self.head_dim, self.causal,
                self.window, self.q_chunk, self.kv_chunk)


def _validate_spec(spec: AttentionSpec) -> None:
    if spec.heads < 1 or spec.kv_heads < 1 or spec.head_dim < 1:
        raise ValueError(
            f"heads/kv_heads/head_dim must be >= 1, got "
            f"({spec.heads}, {spec.kv_heads}, {spec.head_dim})")
    if spec.heads % spec.kv_heads:
        raise ValueError(
            f"GQA needs kv_heads | heads: got heads={spec.heads}, "
            f"kv_heads={spec.kv_heads} — pick kv_heads from the divisors "
            f"of {spec.heads}")
    if spec.window is not None and spec.window < 1:
        raise ValueError(f"sliding window must be >= 1 token, got "
                         f"{spec.window} (None disables windowing)")
    if spec.q_chunk < 1 or spec.kv_chunk < 1:
        raise ValueError(
            f"q_chunk/kv_chunk must be >= 1, got "
            f"({spec.q_chunk}, {spec.kv_chunk})")


def spec_from_arch(cfg, *, causal: bool = True) -> AttentionSpec:
    """An :class:`AttentionSpec` from an ``ArchConfig``-shaped object."""
    return AttentionSpec(heads=cfg.n_heads, kv_heads=cfg.kv_heads,
                         head_dim=cfg.head_dim, causal=causal,
                         window=cfg.swa_window, q_chunk=cfg.q_chunk,
                         kv_chunk=cfg.kv_chunk)


# ========================================================= AttentionProgram ==
class AttentionProgram:
    """An immutable compiled attention configuration.  Construct via
    :func:`compile_attention`; ``apply`` dispatches each call to the
    impl it resolves for the call's shapes and device."""

    def __init__(self, spec: AttentionSpec, dtype, compute_dtype,
                 impl: str):
        self.spec = spec
        self.dtype = dtype
        self.compute_dtype = compute_dtype
        self.impl = impl

    # ------------------------------------------------------------ checks ----
    def _check(self, q, k, v):
        sp = self.spec
        if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
            raise ValueError(
                f"attention inputs are rank-4 (B, S, heads, head_dim); got "
                f"q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
        b, s, h, hd = q.shape
        bk, sk, kv, hdk = k.shape
        if k.shape != v.shape:
            raise ValueError(f"k and v must share a shape; got "
                             f"k{tuple(k.shape)} v{tuple(v.shape)}")
        if h != sp.heads or kv != sp.kv_heads or hd != sp.head_dim \
                or hdk != sp.head_dim or b != bk:
            raise ValueError(
                f"program compiled for heads={sp.heads}, "
                f"kv_heads={sp.kv_heads}, head_dim={sp.head_dim}; got "
                f"q{tuple(q.shape)} k{tuple(k.shape)} — compile_attention "
                "a new program for a new head layout")
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.dtype != self.dtype:
                raise ValueError(
                    f"program compiled for dtype {_name(self.dtype)}; "
                    f"{name} is {_name(x.dtype)} — cast the operand or "
                    f"compile_attention(dtype={_name(x.dtype)})")

    def _resolve_impl(self, s: int, sk: int, device: torch.device) -> str:
        """The impl a (s, sk) call dispatches: 'auto' picks the CUDA
        kernel only where it can launch (chunk-divisible shapes on a CUDA
        tensor, and a head_dim and dtype the kernels take); explicit
        'cuda' refuses what it cannot launch with the limit and the fix
        spelled out."""
        from repro_torch.kernels.flash_attention import launch_refusal

        sp = self.spec
        qc, kc = min(sp.q_chunk, s), min(sp.kv_chunk, sk)
        divisible = (s % qc == 0) and (sk % kc == 0)
        refusal = (launch_refusal(sp.head_dim, self.dtype)
                   if device.type == "cuda" else None)
        if self.impl == "cuda":
            if not divisible:
                raise ValueError(
                    f"impl='cuda' needs chunk-divisible sequences: "
                    f"S={s} %% q_chunk({qc}) or Sk={sk} %% kv_chunk({kc}) "
                    "!= 0 — pad the sequence, change q_chunk/kv_chunk, or "
                    "compile impl='chunked'")
            if refusal is not None:
                raise ValueError(f"impl='cuda' cannot launch here: "
                                 f"{refusal} — compile impl='chunked' (or "
                                 "'auto')")
            return "cuda"
        if self.impl == "auto":
            return ("cuda" if divisible and device.type == "cuda"
                    and refusal is None else "chunked")
        return self.impl

    # ----------------------------------------------------------- runners ----
    def _fn(self, impl: str):
        """The callable for ``impl``, closed over the program's static
        configuration, taking only (q, k, v)."""
        sp = self.spec
        if impl == "cuda":
            from repro_torch.kernels.flash_attention import (
                flash_attention_trainable)

            def fn(q, k, v):
                return flash_attention_trainable(q, k, v, causal=sp.causal,
                                                 window=sp.window)
        elif impl == "chunked":
            from repro_torch.models.attention import flash_attention

            def fn(q, k, v):
                return flash_attention(q, k, v, causal=sp.causal,
                                       window=sp.window,
                                       q_chunk=sp.q_chunk,
                                       kv_chunk=sp.kv_chunk)
        elif impl == "dense":
            from repro_torch.models.attention import dense_attention

            def fn(q, k, v):
                return dense_attention(q, k, v, causal=sp.causal,
                                       window=sp.window)
        else:  # pragma: no cover — impl validated at compile
            raise ValueError(impl)
        return fn

    def apply(self, q, k, v):
        """Forward attention: q ``(B, S, H, hd)``, k/v ``(B, Sk, KV,
        hd)`` → ``(B, S, H, hd)`` in the program's storage dtype;
        differentiable in q, k and v."""
        self._check(q, k, v)
        impl = self._resolve_impl(q.shape[1], k.shape[1], q.device)
        return self._fn(impl)(q, k, v)

    def grad(self, q, k, v, do):
        """The VJP of :meth:`apply` at (q, k, v) against the cotangent
        ``do`` → ``(dq, dk, dv)`` in the inputs' dtypes.  For
        ``impl='cuda'`` this runs the forward kernel (with the lse) and
        the two backward kernels; other impls differentiate the plain
        path.  Matches the gradient of the dense oracle (tested)."""
        self._check(q, k, v)
        if do.shape != q.shape:
            raise ValueError(f"cotangent must match q: got do"
                             f"{tuple(do.shape)} vs q{tuple(q.shape)}")
        impl = self._resolve_impl(q.shape[1], k.shape[1], q.device)
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            out = self._fn(impl)(*leaves)
            return torch.autograd.grad(out, leaves, do.to(out.dtype))

    # ----------------------------------------------------- introspection ----
    def hbm_bytes(self, b: int, s: int, sk: int) -> int:
        """Kernel-model device-memory traffic for one forward call: q, k,
        v read once and o written once."""
        from repro_torch.core.roofline import attention_hbm_bytes
        return attention_hbm_bytes(b, s, sk, self.spec.heads,
                                   self.spec.kv_heads, self.spec.head_dim,
                                   bytes_per_el=self.dtype.itemsize)

    def cache_stats(self) -> dict:
        return attention_cache_stats()

    def __repr__(self) -> str:
        sp = self.spec
        return (f"AttentionProgram(heads={sp.heads}, kv_heads={sp.kv_heads},"
                f" head_dim={sp.head_dim}, causal={sp.causal}, "
                f"window={sp.window}, chunks=({sp.q_chunk}, {sp.kv_chunk}), "
                f"impl={self.impl!r}, dtype={_name(self.dtype)}/"
                f"{_name(self.compute_dtype)})")


def _name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


# ========================================================= compile_attention ==
def compile_attention(cfg=None, *, heads: int | None = None,
                      kv_heads: int | None = None,
                      head_dim: int | None = None, causal: bool = True,
                      window: int | None = None, q_chunk: int | None = None,
                      kv_chunk: int | None = None, dtype=torch.float32,
                      compute_dtype=None,
                      impl: str = "auto") -> AttentionProgram:
    """Compile an attention configuration to an immutable
    :class:`AttentionProgram` — the LM twin of ``compile_stencil``.

    ``cfg`` may be an :class:`AttentionSpec` or an ``ArchConfig``-shaped
    object; explicit keywords override its fields.  ``impl`` ∈
    ``{"auto", "cuda", "chunked", "dense"}``.  ``dtype`` is q/k/v
    storage; compute is float32 (``compute_dtype`` may restate it; other
    compute dtypes are refused).  Recompiling with identical arguments
    returns the same handle.
    """
    if isinstance(cfg, AttentionSpec):
        base = cfg
    elif cfg is not None:
        base = spec_from_arch(cfg, causal=causal)
        if window is None:
            window = base.window
        if q_chunk is None:
            q_chunk = base.q_chunk
        if kv_chunk is None:
            kv_chunk = base.kv_chunk
    else:
        base = None
    if base is not None:
        heads = base.heads if heads is None else heads
        kv_heads = base.kv_heads if kv_heads is None else kv_heads
        head_dim = base.head_dim if head_dim is None else head_dim
        if isinstance(cfg, AttentionSpec):
            causal = base.causal
            window = base.window if window is None else window
            q_chunk = base.q_chunk if q_chunk is None else q_chunk
            kv_chunk = base.kv_chunk if kv_chunk is None else kv_chunk
    if heads is None or head_dim is None:
        raise ValueError(
            "compile_attention needs heads and head_dim — pass them as "
            "keywords or hand in an AttentionSpec / ArchConfig")
    spec = AttentionSpec(heads=heads,
                         kv_heads=heads if kv_heads is None else kv_heads,
                         head_dim=head_dim, causal=causal, window=window,
                         q_chunk=256 if q_chunk is None else q_chunk,
                         kv_chunk=512 if kv_chunk is None else kv_chunk)
    _validate_spec(spec)
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"attention dtype must be floating, got {dtype}")
    cd = torch.float32 if compute_dtype is None else compute_dtype
    if cd != torch.float32:
        raise ValueError(
            f"attention computes in float32 (softmax + dots are f32 in "
            f"every impl); got compute_dtype={_name(cd)} — drop it or pass "
            "float32")
    key = (spec, _name(dtype), _name(cd), impl)
    return ATTN_PROGRAM_CACHE.get_or_build(
        key, lambda: AttentionProgram(spec, dtype, cd, impl))


def attention_program_for(cfg, *, causal: bool = True,
                          dtype=None) -> AttentionProgram:
    """The program an ``ArchConfig`` resolves to — the one mapping from
    config-level ``attention_impl`` names to program impls:
    ``flash_jnp`` → ``"chunked"`` and ``flash_pallas`` → ``"cuda"``, so a
    config means the same in both packages.  ``dtype`` defaults to
    ``cfg.activ_dtype``; the model passes the post-projection q dtype."""
    impl = {"flash_jnp": "chunked", "flash_pallas": "cuda"}.get(
        cfg.attention_impl)
    if impl is None:
        raise ValueError(
            f"attention_impl {cfg.attention_impl!r} has no program "
            "mapping (boundary_stub is inlined by the model, not "
            "compiled) — use 'flash_jnp' or 'flash_pallas'")
    return compile_attention(
        cfg, causal=causal,
        dtype=cfg.activ_dtype if dtype is None else dtype, impl=impl)

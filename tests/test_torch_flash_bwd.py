"""The port's flash-attention backward against the JAX reference, on the CPU.

The same numpy-seeded q, k, v and cotangent do go through the gradient of
the reference's dense oracle (``repro.models.attention.dense_attention``)
and of its chunked online-softmax path (``flash_attention``, 16-token
chunks, so it really chunks), and through the port's:

  * ``flash_attention_bwd_plain`` (from the plain forward's out and lse),
  * ``flash_attention_trainable`` under torch autograd on CPU tensors (the
    forward and backward kernels' plain versions),
  * ``AttentionProgram.grad`` for impl ``cuda``, ``chunked`` and ``dense``.

The reference's Pallas ``flash_attention_trainable`` cannot be the oracle:
its kernels need ``pltpu.TPUCompilerParams``, which this jax lacks.

Grid: GQA groups {1, 2, 4} × causal/bidirectional × window {None, 24} ×
head_dim {16, 80} × float32/bfloat16.  The reference gradients are one
``jax.vjp`` per case under ``jax.jit``; the chunked oracle runs at head_dim
16 (its scan costs a compile per case).  In bfloat16 the oracle is the
float32 program on the bf16-rounded inputs and cotangent with its
gradients rounded to bf16: exactly what the oracle does on bf16 inputs,
since it computes in float32 between its input and output casts.
Tolerances: 2e-5 for forward outputs, 1e-4 for gradients in float32, 0.06
in bfloat16 (the reference suite's).

``emulate_bwd_tf32_tiles`` replays the float32 CUDA kernels
(``csrc/flash_attention_bwd_tf32.cu``): their tile schedule (query-major
dQ; key-major dK/dV with the GQA group loop and both tile skips, at
their own tiles) and their 3xTF32 rounding, ``cvt.rna`` emulated bit for
bit (``tests/tf32_ref.py``); it is held within 1e-4 of the plain version
and of ``jax.vjp`` of the reference's dense oracle, and the one-pass
TF32 replay is the control the limit must refuse.  ``emulate_bwd_mma_tiles``
replays the bfloat16 tensor-core kernels' schedule (their own tiles) and
rounding (bf16 tiles, p and ds as bf16 hi/lo pairs into float32 sums) and
is held against the plain version within the bf16 limit 1e-4 +
2^-6·|want| per element.  The kernels themselves are held against the
plain version on the card in ``test_torch_cuda.py``.
"""
import functools
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as rattn
from repro_torch.api import attention as tapi
from repro_torch.core import roofline as trl
from repro_torch.core.online_softmax import attention_mask
from repro_torch.kernels import flash_attention as tfa
from tf32_ref import mm

B, S, KV, CHUNK = 2, 64, 2, 16
GROUPS = [1, 2, 4]
MASKS = [(True, None), (False, None), (True, 24), (False, 24)]
MASK_IDS = ["causal", "bidir", "causal-swa24", "bidir-swa24"]
HEAD_DIMS = [16, 80]
DTYPES = ["float32", "bfloat16"]
FWD, GRAD, BF16 = 2e-5, 1e-4, 0.06
PORT_PATHS = ["plain", "trainable", "grad-cuda", "grad-chunked",
              "grad-dense"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps this module
    from oversubscribing the CPU the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_round(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def inputs(g, hd, dtype, s=S, sk=S):
    """numpy float32 q, k, v, do (bf16-representable for bf16 cases)."""
    rng = np.random.default_rng(11 * g + hd + s + sk)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((B, s, KV * g, hd), (B, sk, KV, hd),
                          (B, sk, KV, hd), (B, s, KV * g, hd))]
    return [_bf16_round(a) if dtype == "bfloat16" else a for a in arrs]


@functools.lru_cache(maxsize=None)
def _ref_vjp(oracle, causal, window):
    if oracle == "dense":
        def fn(q, k, v):
            return rattn.dense_attention(q, k, v, causal=causal,
                                         window=window)
    else:
        def fn(q, k, v):
            return rattn.flash_attention(q, k, v, causal=causal,
                                         window=window, q_chunk=CHUNK,
                                         kv_chunk=CHUNK)

    @jax.jit
    def vjp(q, k, v, do):
        out, pull = jax.vjp(fn, q, k, v)
        return (out,) + pull(do)
    return vjp


@functools.lru_cache(maxsize=None)
def reference(oracle, g, hd, causal, window, dtype, s=S, sk=S):
    """(out, dq, dk, dv) of the reference ``oracle`` as float32 numpy."""
    res = _ref_vjp(oracle, causal, window)(
        *[jnp.asarray(a) for a in inputs(g, hd, dtype, s, sk)])
    res = [np.array(r) for r in res]
    return [_bf16_round(r) if dtype == "bfloat16" else r for r in res]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def port(path, g, hd, causal, window, dtype):
    """(dq, dk, dv) of one of the port's paths as float32 numpy."""
    q, k, v, do = _torch(inputs(g, hd, dtype), dtype)
    if path == "plain":
        out, lse = tfa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                 window=window)
        grads = tfa.flash_attention_bwd_plain(q, k, v, do, out, lse,
                                              causal=causal, window=window)
    elif path == "trainable":
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = tfa.flash_attention_trainable(*leaves, causal=causal,
                                            window=window)
        grads = torch.autograd.grad(out, leaves, do)
    else:
        prog = tapi.compile_attention(
            heads=KV * g, kv_heads=KV, head_dim=hd, causal=causal,
            window=window, q_chunk=CHUNK, kv_chunk=CHUNK,
            dtype=getattr(torch, dtype), impl=path.split("-")[1])
        grads = prog.grad(q, k, v, do)
    for x, want in zip(grads, (q, k, v)):
        assert x.dtype == want.dtype and x.shape == want.shape
    return [x.float().numpy() for x in grads]


CASES = list(itertools.product(GROUPS, MASKS, HEAD_DIMS, DTYPES))
CASE_IDS = [f"g{g}-{MASK_IDS[MASKS.index(m)]}-hd{hd}-{dt}"
            for g, m, hd, dt in CASES]


@pytest.mark.parametrize("path", PORT_PATHS)
@pytest.mark.parametrize("g,mask,hd,dtype", CASES, ids=CASE_IDS)
def test_backward_matches_reference(path, g, mask, hd, dtype):
    causal, window = mask
    tol = GRAD if dtype == "float32" else BF16
    got = port(path, g, hd, causal, window, dtype)
    oracles = ["dense"] + (["chunked"] if hd == 16 else [])
    for oracle in oracles:
        want = reference(oracle, g, hd, causal, window, dtype)[1:]
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a, b, atol=tol, rtol=tol,
                                       err_msg=f"{name} vs {oracle}")


@pytest.mark.parametrize("g,mask", list(itertools.product(GROUPS, MASKS)),
                         ids=[f"g{g}-{i}" for g in GROUPS for i in MASK_IDS])
def test_trainable_forward_matches_reference(g, mask):
    """The autograd function's forward is the lse-on forward's output."""
    causal, window = mask
    q, k, v, _ = _torch(inputs(g, 80, "float32"), "float32")
    out = tfa.flash_attention_trainable(q, k, v, causal=causal,
                                        window=window)
    want = reference("dense", g, 80, causal, window, "float32")[0]
    np.testing.assert_allclose(out.numpy(), want, atol=FWD, rtol=FWD)


def test_rows_that_keep_no_key_get_no_gradient():
    """S >= Sk + window leaves the last query rows with no key.  The
    backward (the reference kernel's closed form, kept by the port's
    plain version, kernels and autograd function) gives such a row no
    gradient at all.  ``jax.grad`` of the dense oracle differs in dv
    only: the row's softmax over the all-masked (finite -1e30) scores is
    uniform, so each of its heads adds ``do / Sk`` to every key's dv.
    The port's ``dense`` and ``chunked`` programs differentiate the plain
    path and so agree with ``jax.grad``."""
    g, hd, s, sk, window = 2, 16, 48, 16, 8
    q, k, v, do = _torch(inputs(g, hd, "float32", s, sk), "float32")
    _, rdq, rdk, rdv = reference("dense", g, hd, True, window, "float32", s,
                                 sk)
    dead = np.arange(s) >= sk + window - 1          # rows with no key
    assert dead.sum() == s - (sk + window - 1) > 0
    out, lse = tfa.flash_attention_fwd_plain(q, k, v, causal=True,
                                             window=window)
    got = tfa.flash_attention_bwd_plain(q, k, v, do, out, lse, causal=True,
                                        window=window)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got_t = torch.autograd.grad(tfa.flash_attention_trainable(
        *leaves, causal=True, window=window), leaves, do)
    # the dead rows' uniform share of dv, summed over their group's heads
    share = do.numpy()[:, dead].reshape(B, -1, KV, g, hd).sum((1, 3)) / sk
    for dq, dk, dv in (got, got_t):
        assert (dq.numpy()[:, dead] == 0).all()
        np.testing.assert_allclose(dq.numpy(), rdq, atol=GRAD, rtol=GRAD)
        np.testing.assert_allclose(dk.numpy(), rdk, atol=GRAD, rtol=GRAD)
        np.testing.assert_allclose(dv.numpy() + share[:, None], rdv,
                                   atol=GRAD, rtol=GRAD)
        assert np.abs(dv.numpy() - rdv).max() > 100 * GRAD
    for impl in ("dense", "chunked"):
        prog = tapi.compile_attention(heads=KV * g, kv_heads=KV,
                                      head_dim=hd, window=window,
                                      q_chunk=CHUNK, kv_chunk=CHUNK,
                                      impl=impl)
        for a, b in zip(prog.grad(q, k, v, do), (rdq, rdk, rdv)):
            np.testing.assert_allclose(a.numpy(), b, atol=GRAD, rtol=GRAD)


# --------------------------------------------- the float32 kernels ----
LOG2E = 1.4426950408889634


def emulate_bwd_tf32_tiles(q, k, v, do, out, lse, *, causal, window,
                           passes=3):
    """Replay the float32 kernels (``csrc/flash_attention_bwd_tf32.cu``)
    in float32 torch, every (batch, head) at once, at the tiles
    ``bwd_tiles(hd, float32)`` gives: the dQ kernel's query tiles over
    the key tiles their rows keep; the dK/dV kernel's key tiles over the
    G heads of each group and the query tiles that keep some key of the
    tile.  The ranges are the kernels' own formulas, so a tile they skip
    wrongly shows up as a gradient that differs from the plain version.
    Every product is 3xTF32 (``passes=1``: one TF32 pass) with
    ``cvt.rna`` emulated bit for bit; p = 2^(s·scale·log2 e − lse·log2 e)
    where the mask keeps, ds = p·(dp − δ)·scale.  Returns ``(dq, dk, dv,
    issued_flops)``, the flops counted over every pair of every tile
    run, as the kernels issue them."""
    b, s, h, hd = q.shape
    sk, kvh_n = k.shape[1], k.shape[2]
    grp = h // kvh_n
    tiles = tfa.bwd_tiles(hd, torch.float32)
    (dq_bq, dq_bk), (kv_bk, kv_bq) = tiles["dq"], tiles["dkdv"]
    col_passes = -(-hd // tiles["columns_per_pass"])
    f32 = torch.float32
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=f32)
    c = scale * torch.tensor(LOG2E, dtype=f32)     # the kernels' scale_log2
    qf, dof = (x.float().permute(0, 2, 1, 3) for x in (q, do))  # (b,h,s,d)
    kf, vf = (x.float().permute(0, 2, 1, 3) for x in (k, v))  # (b,kv,sk,d)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1)  # (b,h,s)
    lse2 = lse.float() * torch.tensor(LOG2E, dtype=f32)
    dq, dk, dv = (torch.zeros(x.shape) for x in (qf, kf, vf))
    win = window if window is not None else 0
    flops = 0

    def tile(heads, q0, bq, k0, bk):
        """p and ds of one (query tile, key tile) pair for ``heads``."""
        qs, ks = slice(q0, min(q0 + bq, s)), slice(k0, min(k0 + bk, sk))
        kr, vr = (x[:, heads // grp, ks] for x in (kf, vf))
        sc = mm(qf[:, heads, qs], kr.transpose(-1, -2), passes)
        dp = mm(dof[:, heads, qs], vr.transpose(-1, -2), passes)
        ok = attention_mask(torch.arange(s)[qs], torch.arange(sk)[ks],
                            causal=causal, window=window)
        p = torch.where(ok, torch.exp2(sc * c - lse2[:, heads, qs, None]),
                        0.0)
        ds = p * (dp - delta[:, heads, qs, None]) * scale
        return qs, ks, kr, p, ds

    every = torch.arange(h)
    for q0 in range(0, s, dq_bq):
        q_last = min(q0 + dq_bq, s) - 1
        k_lo = max(0, q0 - win + 1) if win > 0 else 0
        k_hi = min(sk, q_last + 1) if causal else sk
        t_lo = k_lo // dq_bk
        t_hi = -(-k_hi // dq_bk) if k_hi > k_lo else t_lo
        for kt in range(t_lo, t_hi):
            qs, _, kr, _, ds = tile(every, q0, dq_bq, kt * dq_bk, dq_bk)
            dq[:, :, qs] += mm(ds, kr, passes)
            flops += b * h * dq_bq * dq_bk * 18 * hd
    for k0 in range(0, sk, kv_bk):
        k_last = min(k0 + kv_bk, sk) - 1
        q_lo = k0 if causal else 0
        q_hi = min(s, k_last + win) if win > 0 else s
        t_lo = q_lo // kv_bq
        t_hi = -(-q_hi // kv_bq) if q_hi > q_lo else t_lo
        for gg, qt in itertools.product(range(grp), range(t_lo, t_hi)):
            heads = torch.arange(kvh_n) * grp + gg    # one of each group
            qs, ks, _, p, ds = tile(heads, qt * kv_bq, kv_bq, k0, kv_bk)
            dv[:, :, ks] += mm(p.transpose(-1, -2), dof[:, heads, qs],
                               passes)
            dk[:, :, ks] += mm(ds.transpose(-1, -2), qf[:, heads, qs],
                               passes)
            flops += b * kvh_n * kv_bq * kv_bk * (12 * col_passes + 12) * hd
    return (dq.permute(0, 2, 1, 3), dk.permute(0, 2, 1, 3),
            dv.permute(0, 2, 1, 3), flops)


SCHEDULES = [  # (s, sk, heads, kv, hd, causal, window)
    (193, 193, 4, 1, 16, True, None),   # a last query tile of one row
    (200, 200, 4, 4, 16, False, None),
    (200, 200, 8, 2, 16, True, 50),
    (200, 200, 4, 2, 16, False, 70),
    (200, 200, 4, 2, 16, True, 65),     # windows on the tile edges: the
    (200, 200, 4, 1, 16, False, 66),    # first and last tile each keeps one
    (150, 40, 4, 1, 16, True, 30),      # rows that keep no key
    (100, 100, 2, 1, 144, True, 33),    # 16-row tiles above hd 128
]


def _f32_inputs(s, sk, h, kv, hd, causal, window):
    rng = np.random.default_rng(s + sk + h + hd)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape,
                                                        dtype=np.float32))
                   for shape in ((1, s, h, hd), (1, sk, kv, hd),
                                 (1, sk, kv, hd), (1, s, h, hd)))
    out, lse = tfa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                             window=window)
    return q, k, v, do, out, lse


@pytest.mark.parametrize("s,sk,h,kv,hd,causal,window", SCHEDULES)
def test_kernel_tile_schedule_matches_plain(s, sk, h, kv, hd, causal,
                                            window):
    """The float32 kernels' schedule and 3xTF32 rounding hold every
    gradient within 1e-4 of the plain version, and issue the flops that
    ``bwd_issued_flops`` counts for float32."""
    args = _f32_inputs(s, sk, h, kv, hd, causal, window)
    want = tfa.flash_attention_bwd_plain(*args, causal=causal, window=window)
    *got, flops = emulate_bwd_tf32_tiles(*args, causal=causal, window=window)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD, rtol=0)
    assert flops == tfa.bwd_issued_flops(s, sk, h, kv, hd, causal=causal,
                                         window=window, dtype=torch.float32)


SCHEDULES_TF32 = [  # (s, sk, heads, kv, hd, causal, window)
    (200, 200, 8, 2, 80, True, 64),     # GQA 4; dQ's 32-key and dK/dV's
    (200, 200, 4, 1, 80, False, 33),    # 16-query tiles, windows on edges
    (150, 40, 4, 2, 80, True, 30),      # rows that keep no key
    (130, 130, 4, 2, 64, False, 33),    # dK/dV's 32-query tiles at hd 64
    (100, 100, 4, 1, 256, True, 17),    # 16-row tiles, two dK/dV passes
]


def test_bwd_tf32_tiles():
    """The float32 kernels' tiles: the streamed tile (dQ's keys, dK/dV's
    queries) 32, or 16 (dQ above hd 128, dK/dV above hd 64), so that the
    float32 tiles fit 227 KB and the registers do not spill; two dK/dV
    column passes above hd 128."""
    for hd in range(16, 257, 16):
        t = tfa.bwd_tiles(hd, torch.float32)
        dq = 32 if hd <= 128 else 16
        dkdv = 32 if hd <= 64 else 16
        assert (t["dq"], t["dkdv"]) == ((64, dq), (64, dkdv)), hd
        assert -(-hd // t["columns_per_pass"]) == (1 if hd <= 128 else 2)


@pytest.mark.parametrize("s,sk,h,kv,hd,causal,window", SCHEDULES_TF32)
def test_bwd_tf32_schedule_at_its_tile_edges(s, sk, h, kv, hd, causal,
                                             window):
    """The replay at the float32 kernels' own tile edges, every gradient
    within 1e-4 of the plain version (a row that keeps no key gets no
    gradient from either)."""
    args = _f32_inputs(s, sk, h, kv, hd, causal, window)
    want = tfa.flash_attention_bwd_plain(*args, causal=causal, window=window)
    *got, flops = emulate_bwd_tf32_tiles(*args, causal=causal, window=window)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD, rtol=0)
    if window is not None and s >= sk + window:
        assert (got[0][:, sk + window - 1:] == 0).all()
    assert flops == tfa.bwd_issued_flops(s, sk, h, kv, hd, causal=causal,
                                         window=window, dtype=torch.float32)


@pytest.mark.parametrize("g,mask,hd", [(1, (True, None), 16),
                                       (4, (True, 24), 80),
                                       (2, (False, 24), 80),
                                       (4, (False, None), 16)],
                         ids=["g1-causal-hd16", "g4-causal-swa24-hd80",
                              "g2-bidir-swa24-hd80", "g4-bidir-hd16"])
def test_bwd_tf32_replay_matches_the_reference(g, mask, hd):
    """The replay against ``jax.vjp`` of the reference's dense oracle in
    float32 on the same inputs and cotangent, from the plain forward's
    out and lse, every gradient within 1e-4."""
    causal, window = mask
    q, k, v, do = _torch(inputs(g, hd, "float32"), "float32")
    out, lse = tfa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                             window=window)
    *got, _ = emulate_bwd_tf32_tiles(q, k, v, do, out, lse, causal=causal,
                                     window=window)
    want = reference("dense", g, hd, causal, window, "float32")[1:]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=GRAD, rtol=0,
                                   err_msg=name)


def test_bwd_one_tf32_pass_misses_the_limit():
    """The control: the replay with one TF32 pass a product misses the
    1e-4 limit that 3xTF32 keeps, at an h2o-danube-like head (hd 80, GQA
    4) cut small.  Prints both errors (``pytest -s``)."""
    args = _f32_inputs(256, 256, 8, 2, 80, True, 128)
    want = tfa.flash_attention_bwd_plain(*args, causal=True, window=128)
    errs = {}
    for passes in (3, 1):
        got = emulate_bwd_tf32_tiles(*args, causal=True, window=128,
                                     passes=passes)[:3]
        errs[passes] = [float((a - b).abs().max())
                        for a, b in zip(got, want)]
    print(f"max |err| (dq, dk, dv) against the plain version: 3xTF32 "
          f"{errs[3]}, one TF32 pass {errs[1]}")
    assert max(errs[3]) < GRAD
    assert min(errs[1]) > GRAD


# ------------------------------------ the bfloat16 kernels' schedule ----
BF16_ATOL, BF16_RTOL = 1e-4, 2.0 ** -6


def _bf16(x):
    return x.bfloat16().float()


def emulate_bwd_mma_tiles(q, k, v, do, out, lse, *, causal, window,
                          pairs=True):
    """Replay the bfloat16 tensor-core kernels in float32 torch, at the
    tiles ``bwd_tiles`` gives: the dQ kernel's query tiles over its key
    tiles; the dK/dV kernel's key tiles over the G heads of the group and
    its query tiles.  s and dp are products of the bf16
    tiles summed in float32; p and ds enter the next products as the
    pair bf16(x) + bf16(x - bf16(x)) (``pairs=False``: bf16(x) alone);
    the sums are float32 and the outputs are rounded to bf16 once.
    Returns ``(dq, dk, dv, issued_flops)``, the flops counted over every
    pair of every tile run, as the kernels issue them."""
    b, s, h, hd = q.shape
    sk, kvh_n = k.shape[1], k.shape[2]
    grp = h // kvh_n
    tiles = tfa.bwd_tiles(hd)
    (dq_bq, dq_bk), (kv_bk, kv_bq) = tiles["dq"], tiles["dkdv"]
    passes = -(-hd // tiles["columns_per_pass"])
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    delta = (dof * out.float()).sum(-1)                    # (b, s, h)
    dq, dk, dv = (torch.zeros(x.shape) for x in (qf, kf, vf))
    win = window if window is not None else 0
    flops = 0

    def split(x):
        hi = _bf16(x)
        return (hi, _bf16(x - hi)) if pairs else (hi,)

    def tile(bi, hh, q0, bq, k0, bk):
        """p and ds of one (query tile, key tile) pair, (qt, kt)."""
        kvh = hh // grp
        qs, ks = slice(q0, min(q0 + bq, s)), slice(k0, min(k0 + bk, sk))
        sc = qf[bi, qs, hh] @ kf[bi, ks, kvh].T
        ok = attention_mask(torch.arange(s)[qs], torch.arange(sk)[ks],
                            causal=causal, window=window)
        p = torch.where(ok, torch.exp(sc * scale - lse[bi, hh, qs, None]),
                        0.0)
        dp = dof[bi, qs, hh] @ vf[bi, ks, kvh].T
        ds = p * (dp - delta[bi, qs, hh, None]) * scale
        return qs, ks, kvh, p, ds

    for bi, hh, t in itertools.product(range(b), range(h),
                                       range(-(-s // dq_bq))):
        q0 = t * dq_bq
        q_last = min(q0 + dq_bq, s) - 1
        k_lo = max(0, q0 - win + 1) if win > 0 else 0
        k_hi = min(sk, q_last + 1) if causal else sk
        t_lo = k_lo // dq_bk
        t_hi = -(-k_hi // dq_bk) if k_hi > k_lo else t_lo
        for kt in range(t_lo, t_hi):
            qs, ks, kvh, _, ds = tile(bi, hh, q0, dq_bq, kt * dq_bk, dq_bk)
            for part in split(ds):
                dq[bi, qs, hh] += part @ kf[bi, ks, kvh]
            flops += dq_bq * dq_bk * 8 * hd
    for bi, kvh, t in itertools.product(range(b), range(kvh_n),
                                        range(-(-sk // kv_bk))):
        k0 = t * kv_bk
        k_last = min(k0 + kv_bk, sk) - 1
        q_lo = k0 if causal else 0
        q_hi = min(s, k_last + win) if win > 0 else s
        t_lo = q_lo // kv_bq
        t_hi = -(-q_hi // kv_bq) if q_hi > q_lo else t_lo
        for gg, qt in itertools.product(range(grp), range(t_lo, t_hi)):
            hh = kvh * grp + gg
            qs, ks, _, p, ds = tile(bi, hh, qt * kv_bq, kv_bq, k0, kv_bk)
            for part in split(p):
                dv[bi, ks, kvh] += part.T @ dof[bi, qs, hh]
            for part in split(ds):
                dk[bi, ks, kvh] += part.T @ qf[bi, qs, hh]
            flops += kv_bq * kv_bk * (4 * passes + 8) * hd
    return _bf16(dq), _bf16(dk), _bf16(dv), flops


def _bf16_inputs(s, sk, h, kv, hd, causal, window):
    rng = np.random.default_rng(s + 3 * sk + h + hd)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).bfloat16()
        for shape in ((1, s, h, hd), (1, sk, kv, hd), (1, sk, kv, hd),
                      (1, s, h, hd)))
    out, lse = tfa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                             window=window)
    return q, k, v, do, out, lse


def _share_of_bf16_limit(got, want):
    """The largest share of its element's limit 1e-4 + 2^-6·|want| that
    any element of (dq, dk, dv) takes."""
    return max(float(((a.double() - b.double()).abs()
                      / (BF16_ATOL + BF16_RTOL * b.double().abs())).max())
               for a, b in zip(got, want))


SCHEDULES_BF16 = [  # (s, sk, heads, kv, hd, causal, window)
    (193, 193, 4, 1, 16, True, None),   # a last query tile of one row
    (200, 200, 4, 4, 16, False, None),
    (200, 200, 8, 2, 16, True, 50),
    (200, 200, 4, 2, 80, False, 70),
    (200, 200, 4, 2, 16, True, 65),     # windows on the 64-row tile edges:
    (200, 200, 4, 1, 80, False, 66),    # the first and last tile keep one
    (150, 40, 4, 1, 16, True, 30),      # rows that keep no key
    (130, 130, 2, 1, 96, True, 33),     # 32-query dK/dV tiles above hd 80,
    (130, 130, 2, 1, 112, False, 34),   # windows on their edges
    (100, 100, 2, 1, 144, True, 33),    # 32-key dQ tiles above hd 128
    (100, 100, 2, 2, 256, True, 34),    # two dK/dV passes
]


def test_bf16_schedules_sit_on_the_kernels_tile_edges():
    """The window-edge cases of ``SCHEDULES_BF16`` are written for these
    tiles (the card test holds ``bwd_tiles`` against the library's shared
    memory)."""
    for hd, dq, dkdv in [(16, (64, 64), (64, 64)), (80, (64, 64), (64, 64)),
                         (96, (64, 64), (64, 32)), (112, (64, 64), (64, 32)),
                         (144, (64, 32), (64, 32)),
                         (256, (64, 32), (64, 32))]:
        t = tfa.bwd_tiles(hd)
        assert (t["dq"], t["dkdv"]) == (dq, dkdv), hd
    assert -(-256 // tfa.bwd_tiles(256)["columns_per_pass"]) == 2


@pytest.mark.parametrize("s,sk,h,kv,hd,causal,window", SCHEDULES_BF16)
def test_bf16_kernel_schedule_matches_plain(s, sk, h, kv, hd, causal,
                                            window):
    """The bfloat16 kernels' schedule and rounding hold every gradient
    within the bf16 limit of the plain version, and issue the flops that
    ``bwd_issued_flops`` counts."""
    args = _bf16_inputs(s, sk, h, kv, hd, causal, window)
    want = tfa.flash_attention_bwd_plain(*args, causal=causal, window=window)
    *got, flops = emulate_bwd_mma_tiles(*args, causal=causal, window=window)
    assert _share_of_bf16_limit(got, want) <= 1.0
    assert flops == tfa.bwd_issued_flops(s, sk, h, kv, hd, causal=causal,
                                         window=window)


def test_bf16_hi_lo_pairs_beat_one_rounding():
    """p and ds rounded once to bf16 before the gradient products, against
    the hi/lo pairs the kernels carry, at one 4096-token-window-like
    shape cut small: the pair stays within the limit and closer than the
    single rounding.  Prints both shares (``pytest -s``)."""
    s, h, kv, hd, window = 320, 4, 1, 80, 200
    args = _bf16_inputs(s, s, h, kv, hd, True, window)
    want = tfa.flash_attention_bwd_plain(*args, causal=True, window=window)
    shares = {}
    for pairs in (True, False):
        got = emulate_bwd_mma_tiles(*args, causal=True, window=window,
                                    pairs=pairs)[:3]
        shares["hi/lo pairs" if pairs else "one rounding"] = \
            _share_of_bf16_limit(got, want)
    print(f"share of the bf16 limit, S{s} H{h} KV{kv} hd{hd} window "
          f"{window}: {shares}")
    assert shares["hi/lo pairs"] <= 1.0
    assert shares["hi/lo pairs"] < shares["one rounding"]


@pytest.mark.parametrize("counted_in", ["flash_attention_fwd",
                                        "flash_attention_bwd"])
def test_bf16_unaligned_rows_are_copied_and_counted(counted_in):
    """The bfloat16 kernels copy rows by 16 bytes: an input whose pointer
    or strides break that is copied (and counted in the calling wrapper's
    ``copies``, no other's) before the launch; an aligned one, strided or
    not, is read in place."""
    wrappers = (tfa.flash_attention_fwd, tfa.flash_attention_bwd)
    counter = getattr(tfa, counted_in)
    base = torch.zeros(2 * 40 * 3 * 4 * 32 + 8, dtype=torch.bfloat16)
    fused = base[8:].view(2, 40, 3, 4, 32)
    q = fused[:, :, 0]                      # strided, rows aligned
    odd = base[1:1 + 2 * 40 * 4 * 32].view(2, 40, 4, 32)   # 2-byte offset
    narrow = torch.zeros(2, 40, 4, 36, dtype=torch.bfloat16)[..., :32]
    before = [w.copies for w in wrappers]
    assert tfa._rows_aligned_or_copy(q, counter) is q
    for x in (odd, narrow):
        y = tfa._rows_aligned_or_copy(x, counter)
        assert y is not x and y.is_contiguous() and torch.equal(y, x)
    assert [w.copies for w in wrappers] == [
        n + 2 * (w is counter) for n, w in zip(before, wrappers)]


def test_ptxas_usage_reads_registers_and_spills():
    """The card tests and chip_smoke read spills per kernel instantiation
    from the build's ``-Xptxas -v`` output."""
    from repro_torch.kernels import _build

    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z13fbm_dq_kernelILi80ELi64EEv7FbmArgs' for 'sm_90a'
ptxas info    : Function properties for _Z13fbm_dq_kernelILi80ELi64EEv7FbmArgs
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 167 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z7k_spillv' for 'sm_90a'
ptxas info    : Function properties for _Z7k_spillv
    24 bytes stack frame, 24 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 128 registers, used 0 barriers
"""
    assert _build.ptxas_usage(log) == {
        "_Z13fbm_dq_kernelILi80ELi64EEv7FbmArgs": (167, 0),
        "_Z7k_spillv": (128, 24)}


# ------------------------------------------------------------- contracts ----
def test_backward_refusals():
    q, k, v, do = _torch(inputs(2, 16, "float32"), "float32")
    out, lse = tfa.flash_attention_fwd_plain(q, k, v)
    with pytest.raises(ValueError, match="must match q"):
        tfa.flash_attention_bwd(q, k, v, do[:, :8], out, lse)
    with pytest.raises(ValueError, match="lse must be"):
        tfa.flash_attention_bwd(q, k, v, do, out, lse[:, :1])
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tfa.flash_attention_bwd_dq(q, k, v, do, lse, lse, q, causal=True,
                                   window=None)
    prog = tapi.compile_attention(heads=KV * 2, kv_heads=KV, head_dim=16)
    with pytest.raises(ValueError, match="cotangent must match q"):
        prog.grad(q, k, v, do[:, :8])
    before = (tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkdv.launches)
    tfa.flash_attention_bwd(q, k, v, do, out, lse)       # plain on the CPU
    assert (tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkdv.launches) == before


def test_attention_bwd_bound_counts_ten_hd_flops_per_kept_pair():
    """Operations: 10·hd per kept (query, key) pair per batch row and
    head; bytes: q, o, do, k, v read and dq, dk, dv written in the
    storage type, lse read in float32.  At h2o-danube-1.8b's training
    layer (B 1, S 8192, H 32, KV 8, hd 80, window 4096, bf16) the bound
    is set by the operations: 0.6515 ms at 989 TFLOP/s."""
    fwd = trl.attention_bound(1, 8192, 8192, 32, 8, 80, causal=True,
                              window=4096, bytes_per_el=2)
    bwd = trl.attention_bwd_bound(1, 8192, 8192, 32, 8, 80, causal=True,
                                  window=4096, bytes_per_el=2)
    assert bwd["pairs_per_head"] == fwd["pairs_per_head"] == 25167872
    assert bwd["flops"] == 10 * 80 * 25167872 * 32 == 2.5 * fwd["flops"]
    assert bwd["bytes"] == 2 * (4 * 8192 * 32 * 80 + 4 * 8192 * 8 * 80) \
        + 4 * 32 * 8192
    assert bwd["bound_by"] == "operations"
    assert abs(bwd["bound_ms"] - 0.6514636) < 1e-6
    small = trl.attention_bwd_bound(2, 64, 96, 4, 1, 16, causal=False,
                                    window=None, bytes_per_el=4)
    assert small["flops"] == 10 * 16 * 64 * 96 * 2 * 4

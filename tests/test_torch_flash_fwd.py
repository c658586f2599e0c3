"""The flash-attention forward kernels' schedules and rounding, replayed
on the CPU.

``csrc/flash_attention_mma.cu`` runs on the tensor cores and cannot run
here, so ``emulate_fwd_mma_tiles`` replays it in float32 torch: the same
query tiles, key tiles (``fwd_tiles``) and tile ranges (the kernel's
formulas: a query tile with a row that keeps no key runs every key tile),
the online softmax per key tile against the running max in log2 units
with the reference's finite -1e30 for masked scores, p entering ``p·v``
as the pair bf16(p) + bf16(p - bf16(p)) (``pairs=False``: bf16(p) alone),
float32 sums, and one rounding of the output to bf16.  It is held
against the kernel's plain version (``flash_attention_fwd_plain``, what
the wrapper runs on a CPU tensor) within the port's bf16 limit 1e-4 +
2^-6·|want| per element (two units in the last place) and lse within
1e-4, and its count of issued flops against ``fwd_issued_flops``.  One
case holds it against the reference's dense attention
(``repro.models.attention.dense_attention``) at the reference suite's
bf16 tolerance, 0.06.

The float32 kernel, ``csrc/flash_attention_tf32.cu``, is replayed by
``emulate_fwd_tf32_tiles``: its own tiles (``fwd_tiles(hd, float32)``),
the same tile ranges and online softmax, and both products in 3xTF32
with ``cvt.rna`` emulated bit for bit (``tests/tf32_ref.py``).  It is
held within the port's float32 limits (out 2e-5, lse 1e-4) of the plain
version and of the reference's ``dense_attention`` in float32, and the
one-pass TF32 replay is the control those limits must refuse.  The
kernels themselves are held against the plain version on the card in
``test_torch_cuda.py``.
"""
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as rattn
from repro_torch.core.online_softmax import NEG_INF, attention_mask
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from tf32_ref import mm, tf32_rna

BF16_ATOL, BF16_RTOL = 1e-4, 2.0 ** -6
LSE_TOL = 1e-4
F32_OUT_TOL = 2e-5
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread keeps this module
    from oversubscribing the CPU the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _bf16(x):
    return x.bfloat16().float()


def emulate_fwd_mma_tiles(q, k, v, *, causal, window, pairs=True):
    """Replay the bfloat16 forward kernel in float32 torch, every (batch,
    head) at once: its 64-query tiles over the key tiles of ``fwd_tiles``
    in its tile ranges, the online softmax per key tile with m in log2
    units, p as a hi/lo pair into ``p·v`` (one rounding when
    ``pairs=False``), l the sum of the float32 p, the output rounded once
    to bf16.  Returns ``(out, lse, issued_flops)``, the flops counted over
    every pair of every tile run, as the kernel issues them."""
    b, s, h, hd = q.shape
    sk, kvh_n = k.shape[1], k.shape[2]
    grp = h // kvh_n
    bq, bk = tfa.fwd_tiles(hd)
    c = _f32(1.0 / math.sqrt(hd)) * _f32(LOG2E)    # the kernel's scale_log2
    neg = _f32(NEG_INF)
    qf = q.float().permute(0, 2, 1, 3)                        # (b, h, s, hd)
    kf, vf = (x.float().repeat_interleave(grp, dim=2).permute(0, 2, 1, 3)
              for x in (k, v))
    out = torch.empty(b, h, s, hd)
    lse = torch.empty(b, h, s)
    flops = 0
    for q0 in range(0, s, bq):
        rows = slice(q0, min(q0 + bq, s))
        qpos = torch.arange(s)[rows]
        m = torch.full((b, h, len(qpos)), NEG_INF)
        l = torch.zeros((b, h, len(qpos)))
        acc = torch.zeros((b, h, len(qpos), hd))
        for t in range(*tfa.fwd_key_tile_range(q0, s, sk, bq, bk,
                                               causal=causal,
                                               window=window)):
            ks = slice(t * bk, min(t * bk + bk, sk))   # keys past Sk: none
            sc = qf[:, :, rows] @ kf[:, :, ks].transpose(-1, -2)
            ok = attention_mask(qpos, torch.arange(sk)[ks], causal=causal,
                                window=window)
            mx = torch.where(ok, sc, -torch.inf).amax(-1)
            m_new = torch.maximum(m, mx * c)
            corr = torch.exp2(m - m_new)
            p = torch.where(ok, torch.exp2(sc * c - m_new[..., None]),
                            torch.exp2(neg - m_new)[..., None])
            l = l * corr + p.sum(-1)
            hi = _bf16(p)
            parts = (hi, _bf16(p - hi)) if pairs else (hi,)
            acc = acc * corr[..., None]
            for part in parts:
                acc = acc + part @ vf[:, :, ks]
            m = m_new
            flops += b * h * bq * bk * (2 + 2 * len(parts)) * hd
        l = torch.clamp(l, min=1e-30)
        out[:, :, rows] = acc / l[..., None]
        lse[:, :, rows] = torch.where(m == neg, neg, m * _f32(LN2)) \
            + torch.log(l)
    return out.permute(0, 2, 1, 3).bfloat16(), lse, flops


def bf16_qkv(s, sk, h, kv, hd, b=1):
    rng = np.random.default_rng(s + 3 * sk + h + 5 * kv + hd)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            .bfloat16() for shape in ((b, s, h, hd), (b, sk, kv, hd),
                                      (b, sk, kv, hd))]


def share_of_bf16_limit(got, want):
    """The largest share of its element's limit 1e-4 + 2^-6·|want| that
    any element of ``got`` takes."""
    d = (got.double() - want.double()).abs()
    return float((d / (BF16_ATOL + BF16_RTOL * want.double().abs())).max())


SCHEDULES = [  # (s, sk, heads, kv, hd, causal, window)
    (193, 193, 4, 1, 16, True, None),   # ragged last query and key tiles
    (200, 200, 4, 4, 16, False, None),  # bidirectional, GQA 1
    (200, 200, 8, 2, 80, True, 50),     # GQA 4
    (200, 200, 4, 2, 16, True, 64),     # windows on the 64-row tile edges
    (200, 200, 4, 1, 80, False, 65),
    (200, 200, 4, 1, 80, True, 47),     # a warp's 16 rows on a window edge
    (256, 256, 8, 1, 16, True, 128),    # GQA 8
    (150, 40, 4, 1, 16, True, 30),      # rows that keep no key
    (150, 40, 4, 2, 96, False, 30),     # the same, bidirectional
    (130, 130, 2, 1, 96, True, 33),
    (100, 100, 2, 1, 144, True, 32),    # 32-key tiles above hd 128,
    (100, 100, 4, 2, 256, False, 33),   # windows on their edges
]


def test_fwd_schedules_sit_on_the_kernels_tile_edges():
    """The window-edge cases of ``SCHEDULES`` are written for these tiles
    (the card test holds ``fwd_tiles`` against the library's shared
    memory)."""
    for hd in range(16, 257, 16):
        assert tfa.fwd_tiles(hd) == (64, 64 if hd <= 128 else 32), hd
    assert 64 % tfa.fwd_tiles(80)[1] == 0
    assert 32 % tfa.fwd_tiles(144)[1] == 0 and 32 % tfa.fwd_tiles(256)[1] == 0


@pytest.mark.parametrize("s,sk,h,kv,hd,causal,window", SCHEDULES)
def test_fwd_mma_schedule_matches_plain(s, sk, h, kv, hd, causal, window):
    """The kernel's schedule and rounding hold out within the bf16 limit
    and lse within 1e-4 of the plain version, and issue the flops that
    ``fwd_issued_flops`` counts."""
    q, k, v = bf16_qkv(s, sk, h, kv, hd)
    want, want_lse = tfa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                   window=window)
    got, lse, flops = emulate_fwd_mma_tiles(q, k, v, causal=causal,
                                            window=window)
    assert got.dtype == want.dtype == torch.bfloat16
    assert share_of_bf16_limit(got, want) <= 1.0
    torch.testing.assert_close(lse, want_lse, atol=LSE_TOL, rtol=0)
    assert flops == tfa.fwd_issued_flops(s, sk, h, kv, hd, causal=causal,
                                         window=window)


def test_fwd_rows_that_keep_no_key_average_every_key():
    """S >= Sk + window: the last rows keep no key, and (as the
    reference's finite sentinel makes them) average every key, with the
    lse -1e30 + log Sk = -1e30."""
    s, sk, window = 150, 40, 30
    q, k, v = bf16_qkv(s, sk, 4, 1, 16)
    got, lse, _ = emulate_fwd_mma_tiles(q, k, v, causal=True, window=window)
    dead = slice(sk + window - 1, s)
    mean = v.float().mean(1, keepdim=True).repeat_interleave(4, dim=2)
    assert share_of_bf16_limit(got[:, dead], mean.bfloat16().expand_as(
        got[:, dead])) <= 1.0
    assert (lse[:, :, dead] == NEG_INF).all()


def test_fwd_mma_replay_matches_the_reference_dense_attention():
    """The replay against the reference's dense oracle on the same bf16
    inputs, at the reference suite's bf16 tolerance."""
    q, k, v = bf16_qkv(200, 200, 8, 2, 80, b=2)
    got, _, _ = emulate_fwd_mma_tiles(q, k, v, causal=True, window=50)
    want = rattn.dense_attention(*(jnp.asarray(x.float().numpy())
                                   .astype(jnp.bfloat16) for x in (q, k, v)),
                                 causal=True, window=50)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=0.06, rtol=0.06)


def test_fwd_bf16_hi_lo_pair_beats_one_rounding():
    """p rounded once to bf16 before ``p·v``, against the hi/lo pair the
    kernel carries, at a 4096-token-window-like shape cut small: the pair
    stays within the limit and closer than the single rounding.  Prints
    both shares (``pytest -s``)."""
    s, h, kv, hd, window = 1024, 4, 1, 80, 512
    q, k, v = bf16_qkv(s, s, h, kv, hd)
    want, _ = tfa.flash_attention_fwd_plain(q, k, v, causal=True,
                                            window=window)
    shares = {}
    for pairs in (True, False):
        got = emulate_fwd_mma_tiles(q, k, v, causal=True, window=window,
                                    pairs=pairs)[0]
        shares["hi/lo pair" if pairs else "one rounding"] = \
            share_of_bf16_limit(got, want)
    print(f"share of the bf16 limit, S{s} H{h} KV{kv} hd{hd} window "
          f"{window}: {shares}")
    assert shares["hi/lo pair"] <= 1.0
    assert shares["hi/lo pair"] < shares["one rounding"]


def test_fwd_issued_flops_at_the_prefill_shape():
    """At h2o-danube-1.8b's layer (S 8192, H 32, KV 8, hd 80, window
    4096) the kernel issues 6·hd flops per computed pair, about 1.03
    computed pairs per kept one at the 64 × 64 tile edges."""
    issued = tfa.fwd_issued_flops(8192, 8192, 32, 8, 80, causal=True,
                                  window=4096)
    kept = 25167872 * 32
    assert issued % (6 * 80 * 64 * 64) == 0
    assert 6 * 80 < issued / kept < 1.05 * 6 * 80


# ----------------------------------------------- the float32 kernel ----
def emulate_fwd_tf32_tiles(q, k, v, *, causal, window, passes=3):
    """Replay the float32 forward kernel in float32 torch, every (batch,
    head) at once: its 64-query tiles over the key tiles of ``fwd_tiles(hd,
    float32)`` in its tile ranges, both products 3xTF32 (``passes=1``: one
    TF32 pass), the online softmax per key tile with m in log2 units, l
    the sum of the float32 p.  Returns ``(out, lse, issued_flops)``, the
    flops counted over every pair of every tile run, as the kernel issues
    them."""
    b, s, h, hd = q.shape
    sk, kvh_n = k.shape[1], k.shape[2]
    grp = h // kvh_n
    bq, bk = tfa.fwd_tiles(hd, torch.float32)
    c = _f32(1.0 / math.sqrt(hd)) * _f32(LOG2E)    # the kernel's scale_log2
    neg = _f32(NEG_INF)
    qf = q.float().permute(0, 2, 1, 3)                        # (b, h, s, hd)
    kf, vf = (x.float().repeat_interleave(grp, dim=2).permute(0, 2, 1, 3)
              for x in (k, v))
    out = torch.empty(b, h, s, hd)
    lse = torch.empty(b, h, s)
    flops = 0
    for q0 in range(0, s, bq):
        rows = slice(q0, min(q0 + bq, s))
        qpos = torch.arange(s)[rows]
        m = torch.full((b, h, len(qpos)), NEG_INF)
        l = torch.zeros((b, h, len(qpos)))
        acc = torch.zeros((b, h, len(qpos), hd))
        for t in range(*tfa.fwd_key_tile_range(q0, s, sk, bq, bk,
                                               causal=causal,
                                               window=window)):
            ks = slice(t * bk, min(t * bk + bk, sk))   # keys past Sk: none
            sc = mm(qf[:, :, rows], kf[:, :, ks].transpose(-1, -2), passes)
            ok = attention_mask(qpos, torch.arange(sk)[ks], causal=causal,
                                window=window)
            mx = torch.where(ok, sc, -torch.inf).amax(-1)
            m_new = torch.maximum(m, mx * c)
            corr = torch.exp2(m - m_new)
            p = torch.where(ok, torch.exp2(sc * c - m_new[..., None]),
                            torch.exp2(neg - m_new)[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + mm(p, vf[:, :, ks], passes)
            m = m_new
            flops += b * h * bq * bk * 4 * passes * hd
        l = torch.clamp(l, min=1e-30)
        out[:, :, rows] = acc / l[..., None]
        lse[:, :, rows] = torch.where(m == neg, neg, m * _f32(LN2)) \
            + torch.log(l)
    return out.permute(0, 2, 1, 3), lse, flops


def f32_qkv(s, sk, h, kv, hd, b=1):
    rng = np.random.default_rng(7 * s + sk + 3 * h + kv + hd)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            for shape in ((b, s, h, hd), (b, sk, kv, hd), (b, sk, kv, hd))]


SCHEDULES_TF32 = [  # (s, sk, heads, kv, hd, causal, window)
    (193, 193, 4, 1, 16, True, None),   # ragged last query and key tiles
    (200, 200, 8, 2, 80, True, 64),     # GQA 4, a window on the 64-key edge
    (200, 200, 4, 1, 80, False, 47),    # a warp's 16 rows on a window edge
    (150, 40, 4, 1, 16, True, 30),      # rows that keep no key
    (130, 130, 4, 4, 96, True, 32),     # 32-key tiles above hd 80
    (100, 100, 4, 2, 256, False, 33),
]


def test_fwd_tf32_rounding_is_cvt_rna():
    """The replay's TF32 rounding: to nearest, ties away from zero, at 10
    mantissa bits, on both signs and across a binade."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 1.5 * ulp, 2 - ulp / 4, 3.0e-3, 0.0])
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 2.0,
                         3.0e-3, 0.0])
    got = tf32_rna(x)
    assert torch.equal(got[:5], want[:5]) and got[6] == 0
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    assert abs(float(got[5]) - 3.0e-3) <= 3.0e-3 * 2 ** -11


@pytest.mark.parametrize("s,sk,h,kv,hd,causal,window", SCHEDULES_TF32)
def test_fwd_tf32_schedule_matches_plain(s, sk, h, kv, hd, causal, window):
    """The float32 kernel's schedule and 3xTF32 rounding hold out within
    2e-5 and lse within 1e-4 of the plain version, and issue the flops
    that ``fwd_issued_flops`` counts for float32."""
    q, k, v = f32_qkv(s, sk, h, kv, hd)
    want, want_lse = tfa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                   window=window)
    got, lse, flops = emulate_fwd_tf32_tiles(q, k, v, causal=causal,
                                             window=window)
    torch.testing.assert_close(got, want, atol=F32_OUT_TOL, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=LSE_TOL, rtol=0)
    assert flops == tfa.fwd_issued_flops(s, sk, h, kv, hd, causal=causal,
                                         window=window, dtype=torch.float32)


@pytest.mark.parametrize("s,h,kv,hd,causal,window", [
    (200, 8, 2, 80, True, 64), (256, 4, 4, 16, False, None),
    (100, 4, 1, 256, True, 33)])
def test_fwd_tf32_replay_matches_the_reference(s, h, kv, hd, causal,
                                               window):
    """The replay against the reference's dense oracle in float32 on the
    same inputs, at the port's float32 limit 2e-5."""
    q, k, v = f32_qkv(s, s, h, kv, hd, b=2)
    got, _, _ = emulate_fwd_tf32_tiles(q, k, v, causal=causal, window=window)
    want = rattn.dense_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                 causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=F32_OUT_TOL, rtol=0)


def test_fwd_one_tf32_pass_misses_the_limit():
    """The control: the same replay with one TF32 pass a product (10
    mantissa bits an operand) misses the 2e-5 limit on out that 3xTF32
    keeps, at an h2o-danube-like head (hd 80, GQA 4) cut small.  Prints
    both errors (``pytest -s``)."""
    q, k, v = f32_qkv(256, 256, 8, 2, 80)
    want, want_lse = tfa.flash_attention_fwd_plain(q, k, v, causal=True,
                                                   window=128)
    errs = {}
    for passes in (3, 1):
        got, lse, _ = emulate_fwd_tf32_tiles(q, k, v, causal=True,
                                             window=128, passes=passes)
        errs[passes] = (float((got - want).abs().max()),
                        float((lse - want_lse).abs().max()))
    print(f"max |err| (out, lse) against the plain version: 3xTF32 "
          f"{errs[3]}, one TF32 pass {errs[1]}")
    assert errs[3][0] < F32_OUT_TOL and errs[3][1] < LSE_TOL
    assert errs[1][0] > F32_OUT_TOL


def test_fwd_tf32_issued_flops_at_the_prefill_shape():
    """At h2o-danube-1.8b's layer (S 8192, H 32, KV 8, hd 80, window 4096)
    the float32 kernel issues 12·hd flops per computed pair on the same
    64 × 64 tiles as the bfloat16 one: twice its count."""
    args = (8192, 8192, 32, 8, 80)
    issued = tfa.fwd_issued_flops(*args, causal=True, window=4096,
                                  dtype=torch.float32)
    kept = 25167872 * 32
    assert tfa.fwd_tiles(80, torch.float32) == tfa.fwd_tiles(80)
    assert 12 * 80 < issued / kept < 1.02 * 12 * 80
    assert issued == 2 * tfa.fwd_issued_flops(*args, causal=True,
                                              window=4096)
    for hd in range(16, 257, 16):
        assert tfa.fwd_tiles(hd, torch.float32) == (64, 64 if hd <= 80
                                                    else 32), hd


# ------------------------------------------------------------ the wrapper ----
def test_fwd_dispatch_by_dtype_without_building():
    """CUDA bf16 inputs go to the bf16 tensor-core source, float32 to the
    3xTF32 source; both C entry points take the same arguments (read from
    the sources, nothing built).  CPU tensors of either dtype take the
    plain version: no launch, no copy."""
    routes = tfa._FWD_ROUTES
    assert set(routes) == {torch.bfloat16, torch.float32}
    assert routes[torch.bfloat16][:2] == ("flash_attention_mma",
                                          "flash_fwd_mma")
    assert routes[torch.float32][:2] == ("flash_attention_tf32",
                                         "flash_fwd_tf32")
    signatures = set()
    for lib, entry, errors in routes.values():
        src = (_build.CSRC / _build.SOURCES[lib]).read_text()
        found = re.search(rf"\nint {entry}\(([^)]*)\)", src)
        assert found and f"const char* {errors}(int err)" in src
        signatures.add(" ".join(found.group(1).split()))
    assert len(signatures) == 1
    assert len(signatures.pop().split(",")) == len(tfa._ARGTYPES)
    before = (tfa.flash_attention_fwd.launches, tfa.flash_attention_fwd.copies)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (x.to(dtype) for x in bf16_qkv(70, 70, 4, 2, 16))
        out, lse = tfa.flash_attention_fwd(q, k, v, causal=True, window=24)
        want, want_lse = tfa.flash_attention_fwd_plain(q, k, v, causal=True,
                                                       window=24)
        assert out.dtype == dtype and torch.equal(out, want)
        assert torch.equal(lse, want_lse)
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_fwd.copies) == before

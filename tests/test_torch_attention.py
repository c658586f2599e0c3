"""The port's attention against the JAX reference, on the CPU.

The same numpy-seeded q, k and v go through ``repro.models.attention`` /
``repro.api.attention`` and through their counterparts in
``repro_torch``: the dense oracle, the chunked online-softmax path, the
single-token decode over a (rolling) cache, and the compiled programs.
The CUDA flash kernel's plain version (what its wrapper runs on a CPU
tensor) is held against the dense oracle for its output and against the
logsumexp of the masked scores for its lse.

The reference's ``impl="pallas"`` cannot run here: the installed jax has
no ``pltpu.TPUCompilerParams``, which the Pallas flash kernels use
unconditionally (ROADMAP Queue 3, "Reference caveats").  So the Pallas
interpret-mode check is replaced by the reference's dense and chunked
oracles, which the reference suite itself holds the Pallas kernel to.

Matrix: GQA groups {1, 2, 4} × causal/bidirectional × window {None, 24}
× head_dim {16, 80}.  Tolerances are the reference suite's: 2e-5 in
float32, 0.06 in bfloat16.  The kernel itself is held against the plain
version on the card in ``test_torch_cuda.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import attention as rapi
from repro.models import attention as rattn
from repro_torch.api import attention as tapi
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattn

B, S, KV = 2, 64, 2
CHUNK = 16                     # S / CHUNK = 4 chunks: the chunked paths chunk
GROUPS = [1, 2, 4]
MASKS = [(True, None), (False, None), (True, 24), (False, 24)]
MASK_IDS = ["causal", "bidir", "causal-swa24", "bidir-swa24"]
HEAD_DIMS = [16, 80]
F32, BF16 = 2e-5, 0.06


@functools.lru_cache(maxsize=None)
def qkv_np(g, hd, s=S, sk=S, seed=0):
    rng = np.random.default_rng(seed + 7 * g + hd)
    q = rng.standard_normal((B, s, KV * g, hd), dtype=np.float32)
    k = rng.standard_normal((B, sk, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, sk, KV, hd), dtype=np.float32)
    return q, k, v


def as_jax(arrs, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrs]


def as_torch(arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def ref_program(g, hd, causal, window, impl):
    """The reference program's output on the ``(g, hd)`` inputs: its
    ``chunked`` impl is ``models.attention.flash_attention`` and its
    ``dense`` impl ``models.attention.dense_attention``, under one jit
    (one compile per case instead of one per eager op)."""
    kw = dict(heads=KV * g, kv_heads=KV, head_dim=hd, causal=causal,
              window=window, q_chunk=CHUNK, kv_chunk=CHUNK)
    q, k, v = as_jax(qkv_np(g, hd))
    return to_np(rapi.compile_attention(impl=impl, interpret=True,
                                        **kw).apply(q, k, v))


def ref_dense(g, hd, causal, window):
    return ref_program(g, hd, causal, window, "dense")


def ref_chunked(g, hd, causal, window):
    return ref_program(g, hd, causal, window, "chunked")


def masked_lse(g, hd, causal, window):
    """logsumexp over keys of the masked, scaled scores: (B, H, S)."""
    q, k, _ = qkv_np(g, hd)
    s = np.einsum("bqkgd,bskd->bkgqs",
                  q.reshape(B, S, KV, g, hd).astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(hd)
    qpos, kpos = np.arange(S)[:, None], np.arange(S)[None, :]
    ok = np.ones((S, S), bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    s = np.where(ok, s, -np.inf)
    mx = s.max(axis=-1, keepdims=True)
    lse = (mx + np.log(np.exp(s - mx).sum(axis=-1, keepdims=True)))[..., 0]
    return lse.reshape(B, KV * g, S)


matrix = pytest.mark.parametrize(
    "g,hd,causal,window",
    [(g, hd, c, w) for g in GROUPS for hd in HEAD_DIMS for c, w in MASKS],
    ids=[f"g{g}-hd{hd}-{mid}" for g in GROUPS for hd in HEAD_DIMS
         for mid in MASK_IDS])


# ============================================================ functions ==
@matrix
def test_dense_matches_reference(g, hd, causal, window):
    q, k, v = as_torch(qkv_np(g, hd))
    got = tattn.dense_attention(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(to_np(got), ref_dense(g, hd, causal, window),
                               atol=F32, rtol=F32)


@matrix
def test_chunked_matches_reference(g, hd, causal, window):
    q, k, v = as_torch(qkv_np(g, hd))
    got = tattn.flash_attention(q, k, v, causal=causal, window=window,
                                q_chunk=CHUNK, kv_chunk=CHUNK)
    np.testing.assert_allclose(to_np(got), ref_chunked(g, hd, causal, window),
                               atol=F32, rtol=F32)


@matrix
def test_kernel_plain_version_matches_oracle(g, hd, causal, window):
    """The kernel's plain version: out against the dense oracle, lse
    against the logsumexp of the masked scores; on a CPU tensor the
    wrapper runs it and launches nothing."""
    q, k, v = as_torch(qkv_np(g, hd))
    before = tfa.flash_attention_fwd.launches
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=causal,
                                       window=window)
    assert tfa.flash_attention_fwd.launches == before
    np.testing.assert_allclose(to_np(out), ref_dense(g, hd, causal, window),
                               atol=F32, rtol=F32)
    assert lse.shape == (B, KV * g, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), masked_lse(g, hd, causal,
                                                       window),
                               atol=1e-4, rtol=1e-5)
    plain, _ = tfa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                             window=window, kv_chunk=24)
    np.testing.assert_allclose(to_np(plain), to_np(out), atol=F32, rtol=F32)
    assert tfa.flash_attention(q, k, v, causal=causal,
                               window=window).shape == out.shape


@pytest.mark.parametrize("s,sk,causal,window",
                         [(96, 40, True, 16), (40, 96, False, 8),
                          (50, 50, True, 1)])
def test_kernel_plain_version_ragged_and_fully_masked_rows(s, sk, causal,
                                                           window):
    """Sequences no tile divides, and rows with no valid key at all
    (S >= Sk + window): those average every key, as the reference's
    finite -1e30 sentinel makes its dense oracle do."""
    q, k, v = as_torch(qkv_np(2, 16, s=s, sk=sk, seed=3))
    out, _ = tfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    qj, kj, vj = as_jax(qkv_np(2, 16, s=s, sk=sk, seed=3))
    want = jax.jit(functools.partial(rattn.dense_attention, causal=causal,
                                     window=window))(qj, kj, vj)
    np.testing.assert_allclose(to_np(out), to_np(want), atol=F32, rtol=F32)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, 24)])
def test_q_offset_matches_reference(causal, window):
    """Queries placed at absolute positions ``q_offset + i`` (a prompt
    continued after a prefix), in the dense and chunked paths."""
    q, k, v = as_torch(qkv_np(2, 16))
    qj, kj, vj = as_jax(qkv_np(2, 16))
    q, qj = q[:, :32], qj[:, :32]
    for tf, rf, kw in ((tattn.dense_attention, rattn.dense_attention, {}),
                       (tattn.flash_attention, rattn.flash_attention,
                        dict(q_chunk=8, kv_chunk=16))):
        got = tf(q, k, v, causal=causal, window=window, q_offset=32, **kw)
        want = rf(qj, kj, vj, causal=causal, window=window, q_offset=32,
                  **kw)
        np.testing.assert_allclose(to_np(got), to_np(want), atol=F32,
                                   rtol=F32)


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("window", [None, 8])
def test_decode_attention_and_rolling_cache_match_reference(g, window):
    """Write a few tokens into a (rolling, when windowed) cache with
    ``cache_update``/``rolling_slot_pos`` and attend over it, on both
    sides, step by step."""
    hd, sc = 16, 12
    rng = np.random.default_rng(g)
    kc = np.zeros((B, sc, KV, hd), np.float32)
    slot = np.full((sc,), -1, np.int32)
    tk, tv, ts = torch.from_numpy(kc.copy()), torch.from_numpy(kc.copy()), \
        torch.from_numpy(slot.copy())
    jk, jv, js = jnp.asarray(kc), jnp.asarray(kc), jnp.asarray(slot)
    steps = 20 if window else sc
    for pos in range(steps):
        q = rng.standard_normal((B, 1, KV * g, hd), dtype=np.float32)
        kn = rng.standard_normal((B, 1, KV, hd), dtype=np.float32)
        vn = rng.standard_normal((B, 1, KV, hd), dtype=np.float32)
        jk, jv = rattn.cache_update(jk, jv, jnp.asarray(kn), jnp.asarray(vn),
                                    pos, window=window)
        js = rattn.rolling_slot_pos(js, pos, 1, sc)
        tk, tv = tattn.cache_update(tk, tv, torch.from_numpy(kn),
                                    torch.from_numpy(vn), pos, window=window)
        ts = tattn.rolling_slot_pos(ts, pos, 1, sc)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        want = rattn.decode_attention(jnp.asarray(q), jk, jv, pos + 1,
                                      slot_pos=js, window=window)
        got = tattn.decode_attention(torch.from_numpy(q), tk, tv, pos + 1,
                                     slot_pos=ts, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32,
                                   rtol=F32)


def test_multi_token_cache_insert_clamps_like_dynamic_update_slice():
    """An insert that would run past the cache's end starts earlier, as
    ``lax.dynamic_update_slice`` clamps it."""
    kc = np.zeros((1, 8, 1, 4), np.float32)
    new = np.arange(12, dtype=np.float32).reshape(1, 3, 1, 4) + 1
    jk, _ = rattn.cache_update(jnp.asarray(kc), jnp.asarray(kc),
                               jnp.asarray(new), jnp.asarray(new), 14,
                               window=8)
    tk, _ = tattn.cache_update(torch.from_numpy(kc.copy()),
                               torch.from_numpy(kc.copy()),
                               torch.from_numpy(new), torch.from_numpy(new),
                               14, window=8)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    js = rattn.rolling_slot_pos(jnp.zeros((8,), jnp.int32), 14, 3, 8)
    ts = tattn.rolling_slot_pos(torch.zeros(8, dtype=torch.int32), 14, 3, 8)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ============================================================= programs ==
@pytest.mark.parametrize("impl", ["cuda", "chunked", "dense", "auto"])
@matrix
def test_program_matches_reference_programs(g, hd, causal, window, impl):
    """``compile_attention(...).apply`` for every port impl against the
    reference's chunked and dense programs (``cuda`` runs the kernel's
    plain version on these CPU tensors; ``auto`` resolves to chunked)."""
    kw = dict(heads=KV * g, kv_heads=KV, head_dim=hd, causal=causal,
              window=window, q_chunk=CHUNK, kv_chunk=CHUNK)
    q, k, v = as_torch(qkv_np(g, hd))
    prog = tapi.compile_attention(impl=impl, **kw)
    assert prog._resolve_impl(S, S, q.device) == (
        "chunked" if impl == "auto" else impl)
    got = to_np(prog.apply(q, k, v))
    for ref_impl in ("chunked", "dense"):
        np.testing.assert_allclose(
            got, ref_program(g, hd, causal, window, ref_impl), atol=F32,
            rtol=F32)


@pytest.mark.parametrize("impl", ["cuda", "chunked", "dense"])
@pytest.mark.parametrize("g", GROUPS)
def test_program_bf16_matches_reference(g, impl):
    kw = dict(heads=KV * g, kv_heads=KV, head_dim=80, causal=True,
              window=24, q_chunk=CHUNK, kv_chunk=CHUNK)
    q, k, v = as_torch(qkv_np(g, 80), torch.bfloat16)
    got = tapi.compile_attention(impl=impl, dtype=torch.bfloat16,
                                 **kw).apply(q, k, v)
    assert got.dtype == torch.bfloat16
    qj, kj, vj = as_jax(qkv_np(g, 80), jnp.bfloat16)
    want = rapi.compile_attention(impl="chunked", dtype=jnp.bfloat16,
                                  interpret=True, **kw).apply(qj, kj, vj)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=BF16,
                               rtol=BF16)


def test_spec_signature_groups_and_arch_mapping():
    import repro.configs as RC
    import repro_torch.configs as TC

    assert TC.list_archs() == RC.list_archs()
    # stencil-suite (no heads, no model) is the dry run's, not attention's
    for name in (a for a in TC.list_archs() if a != "stencil-suite"):
        for impl in ("flash_jnp", "flash_pallas"):
            r = rapi.spec_from_arch(RC.get_config(name))
            t = tapi.spec_from_arch(TC.get_config(name))
            assert t.signature == r.signature and t.groups == r.groups
    cfg = TC.get_config("h2o-danube-1.8b")
    import dataclasses
    prog = tapi.attention_program_for(
        dataclasses.replace(cfg, attention_impl="flash_pallas"))
    assert prog.impl == "cuda" and prog.dtype == torch.bfloat16
    assert prog.spec.window == 4096 and prog.spec.groups == 4
    assert tapi.attention_program_for(cfg).impl == "chunked"
    assert tapi.compile_attention(cfg, impl="cuda") is tapi.compile_attention(
        cfg, impl="cuda")
    assert prog.hbm_bytes(4, 8192, 8192) == 419430400


BAD_SPECS = [dict(heads=6, kv_heads=4, head_dim=16),
             dict(heads=4, kv_heads=2, head_dim=16, window=0),
             dict(heads=4, kv_heads=2, head_dim=16, q_chunk=0),
             dict(heads=0, kv_heads=1, head_dim=16)]


@pytest.mark.parametrize("kw", BAD_SPECS,
                         ids=["groups", "window", "chunk", "heads"])
def test_bad_spec_refused_with_reference_message(kw):
    with pytest.raises(ValueError) as want:
        rapi.compile_attention(**kw)
    with pytest.raises(ValueError) as got:
        tapi.compile_attention(**kw)
    assert str(got.value) == str(want.value)


def test_cuda_refuses_undivisible_chunks_with_reference_message():
    kw = dict(heads=4, kv_heads=2, head_dim=16, q_chunk=16, kv_chunk=16)
    q, k, v = as_torch(qkv_np(2, 16, s=40, sk=40))
    with pytest.raises(ValueError) as got:
        tapi.compile_attention(impl="cuda", **kw).apply(q, k, v)
    with pytest.raises(ValueError) as want:
        rapi.compile_attention(impl="pallas", interpret=True,
                               **kw)._resolve_impl(40, 40)
    assert str(got.value) == str(want.value).replace("pallas", "cuda")
    # auto takes the chunked path on such shapes instead
    out = tapi.compile_attention(impl="auto", **kw).apply(q, k, v)
    np.testing.assert_allclose(
        to_np(out), to_np(tattn.dense_attention(q, k, v)), atol=F32,
        rtol=F32)


def test_other_refusals():
    with pytest.raises(ValueError, match="unknown impl"):
        tapi.compile_attention(heads=4, head_dim=16, impl="pallas")
    with pytest.raises(ValueError, match="computes in float32"):
        tapi.compile_attention(heads=4, head_dim=16,
                               compute_dtype=torch.bfloat16)
    prog = tapi.compile_attention(heads=4, kv_heads=2, head_dim=16)
    q, k, v = as_torch(qkv_np(2, 16))
    with pytest.raises(ValueError, match="compiled for dtype float32"):
        prog.apply(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert prog.apply(q.requires_grad_(), k, v).requires_grad   # no refusal
    with pytest.raises(ValueError, match="cotangent must match q"):
        prog.grad(q, k, v, q[:, :8])
    with pytest.raises(ValueError, match="multiples of 16"):
        tfa.check_head_dim(72)


def test_attention_bound_copies_reference_traffic_and_counts_the_mask():
    """``core.roofline``'s attention bytes are the reference's
    ``attention_hbm_bytes``; the valid pairs are the mask's own count; at
    h2o-danube-1.8b's prefill layer (B 4, S 8192, H 32, KV 8, hd 80,
    window 4096, bf16) the bound is 1.042 ms, set by the flops."""
    from repro.kernels.flash_attention import attention_hbm_bytes as ref_b
    from repro_torch.core import roofline as trl

    for args in [(4, 8192, 8192, 32, 8, 80), (2, 64, 96, 4, 1, 16)]:
        for el in (2, 4):
            assert trl.attention_hbm_bytes(*args, el) == ref_b(*args, el)
    for s, sk, causal, window in [(64, 64, True, None), (64, 64, False, 24),
                                  (96, 40, True, 16), (40, 96, False, 8)]:
        qpos, kpos = np.arange(s)[:, None], np.arange(sk)[None, :]
        ok = np.ones((s, sk), bool)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        assert trl.attention_valid_pairs(s, sk, causal=causal,
                                         window=window) == ok.sum()
    b = trl.attention_bound(4, 8192, 8192, 32, 8, 80, causal=True,
                            window=4096, bytes_per_el=2)
    assert b["pairs_per_head"] == 25_167_872
    assert b["flops"] == 4 * 80 * 25_167_872 * 4 * 32
    assert b["bytes"] == 419_430_400
    assert b["bound_by"] == "operations"
    assert abs(b["bound_ms"] - 1.0423) < 1e-4


CUDA = torch.device("cuda", 0)      # resolution reads the device, no card
REFUSED = [(72, torch.float32, "multiples of 16"),
           (8, torch.float32, "multiples of 16"),
           (64, torch.float16, "float16"),
           (64, torch.float64, "float64"),
           (320, torch.bfloat16, "up to 256")]


@pytest.mark.parametrize("hd,dtype,limit", REFUSED,
                         ids=[f"{hd}-{str(d)[6:]}" for hd, d, _ in REFUSED])
def test_auto_takes_chunked_where_the_kernel_refuses(hd, dtype, limit):
    """``impl="auto"`` on a CUDA tensor takes the kernel only where it
    launches: a head_dim the kernels take and a dtype with a route (the
    kernel module's own ``check_head_dim`` and route tables, read through
    ``launch_refusal``).  Otherwise it takes ``"chunked"``, as the
    reference's "auto" promises; an explicit ``"cuda"`` refuses and names
    the limit it hit."""
    kw = dict(heads=4, kv_heads=2, head_dim=hd, dtype=dtype)
    auto = tapi.compile_attention(impl="auto", **kw)
    assert auto._resolve_impl(128, 128, CUDA) == "chunked"
    assert auto._resolve_impl(128, 128, torch.device("cpu")) == "chunked"
    with pytest.raises(ValueError, match=limit) as got:
        tapi.compile_attention(impl="cuda", **kw)._resolve_impl(128, 128,
                                                                CUDA)
    assert "impl='chunked'" in str(got.value)
    assert limit in tfa.launch_refusal(hd, dtype)
    # on the CPU the kernels' wrappers run their plain versions: no refusal
    assert tapi.compile_attention(impl="cuda", **kw)._resolve_impl(
        128, 128, torch.device("cpu")) == "cuda"


@pytest.mark.parametrize("hd,dtype", [(16, torch.float32),
                                      (80, torch.bfloat16),
                                      (256, torch.bfloat16)])
def test_auto_takes_the_kernel_where_it_launches(hd, dtype):
    """The control: a head_dim and dtype both kernels take resolve to the
    kernel on a CUDA tensor; undivisible sequences still do not."""
    assert tfa.launch_refusal(hd, dtype) is None
    auto = tapi.compile_attention(heads=4, kv_heads=2, head_dim=hd,
                                  dtype=dtype, q_chunk=64, kv_chunk=64)
    assert auto._resolve_impl(128, 128, CUDA) == "cuda"
    assert auto._resolve_impl(96, 96, CUDA) == "chunked"
    assert set(tfa._FWD_ROUTES) == set(tfa._BWD_ROUTES) == set(
        tfa._DTYPE_CODE)
    # each dtype's route is a tensor-core library the build knows: bf16
    # pairs, float32 3xTF32
    libs = {dt: (tfa._FWD_ROUTES[dt][0], tfa._BWD_ROUTES[dt][0])
            for dt in tfa._DTYPE_CODE}
    assert libs == {torch.bfloat16: ("flash_attention_mma",
                                     "flash_attention_bwd_mma"),
                    torch.float32: ("flash_attention_tf32",
                                    "flash_attention_bwd_tf32")}
    assert {x for pair in libs.values() for x in pair} == set(
        _build.SOURCES)

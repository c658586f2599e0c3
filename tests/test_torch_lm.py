"""The port's dense LM serving path against the JAX reference, on the CPU.

Weights are the reference's own ``tree_init`` at ``reduced()`` size,
carried across with ``params_from_jax``; tokens are numpy-seeded.  Then:

  * the ten LM configs' fields, reduced fields, shape support and
    parameter counts (all and active) against the reference registry;
  * ``rms_norm``, RoPE, and the SwiGLU and GeGLU MLPs against
    ``repro.models.layers``;
  * ``prefill`` logits and cache, one ``decode_step``, and
    ``greedy_generate`` against ``repro.models.transformer`` /
    ``repro.serve.serve_step``.

``q_chunk = kv_chunk = 32`` with a 128-token prompt, so the chunked and
kernel paths really chunk (at 48 tokens the reference falls back to
dense); one h2o-danube case with ``swa_window=16`` makes ``_to_cache``
and the decode cache roll.  The port runs both ``flash_pallas`` (the CUDA
kernel's plain version on these CPU tensors) and ``flash_jnp``; the
reference runs ``flash_jnp``, because its Pallas path cannot run on this
jax (ROADMAP Queue 3).  Tolerances: greedy tokens equal and logits
within 1e-4 in float32 (the reference's own prefill-vs-forward
tolerance, ``tests/test_arch_smoke.py``), caches within 2e-5; logits
within 0.06 in bfloat16.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as TC
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.models.params import tree_init
from repro.serve import serve_step as RS
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.params import (ParamModule, init_params,
                                       params_from_jax)
from repro_torch.serve import serve_step as TS

DENSE = ["gemma-7b", "h2o-danube-1.8b", "minicpm-2b", "qwen3-14b"]
# the reference's ten LM configs (its eleventh, stencil-suite, is the dry
# run's and builds no model)
LM_ARCHS = sorted(DENSE + ["granite-moe-3b-a800m", "hubert-xlarge",
                           "internvl2-1b", "mamba2-130m",
                           "qwen3-moe-235b-a22b", "zamba2-2.7b"])
PROMPT, MAX_NEW, BATCH = 128, 4, 2
CACHE_LEN = PROMPT + MAX_NEW + 8
F32 = 2e-5


def _dtype_name(d):
    return str(d).removeprefix("torch.") if isinstance(d, torch.dtype) \
        else jnp.dtype(d).name


# ============================================================== configs ==
@pytest.mark.parametrize("name", LM_ARCHS)
def test_config_matches_reference_registry(name):
    assert TC.list_archs() == RC.list_archs()
    assert [a for a in RC.list_archs() if a != "stencil-suite"] == LM_ARCHS
    for r, t in ((RC.get_config(name), TC.get_config(name)),
                 (RC.get_config(name).reduced(),
                  TC.get_config(name).reduced())):
        for f in dataclasses.fields(r):
            rv, tv = getattr(r, f.name), getattr(t, f.name)
            if f.name.endswith("_dtype"):
                assert _dtype_name(tv) == _dtype_name(rv), f.name
            else:
                assert tv == rv, f.name
        assert [f.name for f in dataclasses.fields(t)] == \
            [f.name for f in dataclasses.fields(r)]
        for shape in TC.SHAPES:
            assert t.supports(shape) == r.supports(shape)
        assert t.n_params() == r.n_params()
        assert t.n_active_params() == r.n_active_params()
    assert TC.SHAPES == RC.SHAPES


# =============================================================== layers ==
def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_reference(dtype):
    tol = F32 if dtype == "float32" else 0.06
    x, scale = _x((2, 8, 4, 16)), _x((16,), 1) + 1
    jx, tx = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch,
                                                                   dtype))
    want = RL.rms_norm(jx, jnp.asarray(scale, dtype))
    got = TL.rms_norm(tx, torch.from_numpy(scale).to(tx.dtype))
    assert _dtype_name(got.dtype) == jnp.dtype(want.dtype).name
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    pos = np.arange(8)[None].repeat(2, 0)
    jc, js = RL.rope_cos_sin(jnp.asarray(pos), 16, 1e6)
    tc, ts = TL.rope_cos_sin(torch.from_numpy(pos), 16, 1e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    want = RL.apply_rope(jx, jc, js)
    got = TL.apply_rope(tx, tc, ts)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    tol = F32 if dtype == "float32" else 0.06
    x, scale, bias = _x((3, 7, 32)) * 3 + 1, _x((32,), 1), _x((32,), 2)
    want = RL.apply_norm(jnp.asarray(x, dtype), {
        "scale": jnp.asarray(scale, dtype), "bias": jnp.asarray(bias, dtype)},
        "ln")
    tdt = getattr(torch, dtype)
    got = TL.apply_norm(torch.from_numpy(x).to(tdt), {
        "scale": torch.from_numpy(scale).to(tdt),
        "bias": torch.from_numpy(bias).to(tdt)}, "ln")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "silu"])
def test_mlp_matches_reference(act):
    """GeGLU/GELU need the tanh approximation, jax.nn.gelu's default."""
    d, f = 16, 40
    p = {"w_up": _x((d, f), 1) * 0.5, "w_down": _x((f, d), 2) * 0.5,
         "w_gate": _x((d, f), 3) * 0.5}
    x = _x((2, 5, d)) * 2
    want = RL.apply_mlp(jnp.asarray(x), {k: jnp.asarray(v)
                                         for k, v in p.items()}, act)
    got = TL.apply_mlp(torch.from_numpy(x),
                       {k: torch.from_numpy(v) for k, v in p.items()}, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32,
                               rtol=F32)


# ================================================================ model ==
def _cfgs(name, dtype="float32", **kw):
    kw = dict(q_chunk=32, kv_chunk=32, **kw)
    if dtype != "float32":
        kw.update(activ_dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    r = dataclasses.replace(RC.get_config(name).reduced(),
                            attention_impl="flash_jnp", **kw)
    if dtype != "float32":
        kw.update(activ_dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    t = dataclasses.replace(TC.get_config(name).reduced(), **kw)
    return r, t


@functools.lru_cache(maxsize=None)
def reference_run(name, dtype="float32", window=None):
    """Reference prefill (logits, cache), one decode step, and greedy
    tokens, on numpy-seeded tokens; with the reference's parameters."""
    extra = {} if window is None else {"swa_window": window}
    rcfg, _ = _cfgs(name, dtype, **extra)
    params = tree_init(RT.param_defs(rcfg), jax.random.PRNGKey(3),
                       rcfg.param_dtype)
    toks = np.random.default_rng(5).integers(0, rcfg.vocab,
                                             (BATCH, PROMPT), np.int32)
    logits, cache = RT.prefill(rcfg, params, {"tokens": jnp.asarray(toks)},
                               CACHE_LEN)
    nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    l1, cache1 = RT.decode_step(rcfg, params, cache, nxt[:, None],
                                jnp.int32(PROMPT))
    greedy = RS.greedy_generate(rcfg, params, jnp.asarray(toks), MAX_NEW,
                                CACHE_LEN)
    as_np = functools.partial(jax.tree.map, lambda a: np.asarray(
        a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a))
    return dict(params=jax.tree.map(np.asarray, params), toks=toks,
                logits=as_np(logits), cache=as_np(cache),
                nxt=np.asarray(nxt), l1=as_np(l1), cache1=as_np(cache1),
                greedy=np.asarray(greedy))


def _port_model(name, impl, dtype="float32", window=None):
    extra = {} if window is None else {"swa_window": window}
    _, tcfg = _cfgs(name, dtype, **extra)
    tcfg = dataclasses.replace(tcfg, attention_impl=impl)
    ref = reference_run(name, dtype, window)
    model = TT.build_model(tcfg, "cpu")
    model.load_state_dict(params_from_jax(ref["params"]))   # strict
    return tcfg, model, ref


def _check_cache(got, want, tol):
    for i, layer in enumerate(got["attn"]):
        for key in ("k", "v", "slot_pos"):
            np.testing.assert_allclose(
                layer[key].float().numpy(), want["attn"][key][i],
                atol=tol, rtol=tol, err_msg=f"layer {i} {key}")


CASES = [(n, None) for n in DENSE] + [("h2o-danube-1.8b", 16)]


@pytest.mark.parametrize("impl", ["flash_pallas", "flash_jnp"])
@pytest.mark.parametrize("name,window", CASES,
                         ids=[f"{n}-swa{w}" if w else n for n, w in CASES])
def test_prefill_decode_and_greedy_match_reference(name, window, impl):
    tcfg, model, ref = _port_model(name, impl, window=window)
    toks = torch.from_numpy(ref["toks"])
    logits, cache = TT.prefill(tcfg, model, {"tokens": toks}, CACHE_LEN)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=1e-4,
                               rtol=1e-4)
    _check_cache(cache, ref["cache"], F32)
    if window:
        assert cache["attn"][0]["k"].shape[1] == window   # it rolled
    nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    np.testing.assert_array_equal(nxt.numpy(), ref["nxt"])
    l1, cache1 = TT.decode_step(tcfg, model, cache, nxt[:, None], PROMPT)
    np.testing.assert_allclose(l1.numpy(), ref["l1"], atol=1e-4, rtol=1e-4)
    _check_cache(cache1, ref["cache1"], F32)
    greedy = TS.greedy_generate(tcfg, model, toks, MAX_NEW, CACHE_LEN)
    assert greedy.dtype == torch.int32
    np.testing.assert_array_equal(greedy.numpy(), ref["greedy"])


@pytest.mark.parametrize("impl", ["flash_pallas", "flash_jnp"])
def test_prefill_bf16_matches_reference(impl):
    tcfg, model, ref = _port_model("h2o-danube-1.8b", impl, "bfloat16")
    assert model.blocks[0].attn.wq.dtype == torch.bfloat16
    logits, cache = TT.prefill(tcfg, model,
                               {"tokens": torch.from_numpy(ref["toks"])},
                               CACHE_LEN)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=0.06,
                               rtol=0.06)
    _check_cache(cache, ref["cache"], 0.06)


def test_params_tree_and_init():
    """Parameter names are the reference tree's paths; init_params uses
    its scales (normal/sqrt(fan_in), embedding 0.02, norms ones)."""
    cfg = TC.get_config("qwen3-14b").reduced()
    model = TT.build_model(cfg, "cpu")
    names = {k: p.detach() for k, p in model.named_parameters()}
    ref = params_from_jax(jax.tree.map(
        lambda d: np.zeros(d.shape, np.float32),
        RT.param_defs(RC.get_config("qwen3-14b").reduced()),
        is_leaf=lambda d: hasattr(d, "fan_in")))
    assert sorted(names) == sorted(ref)
    assert {"blocks.1.attn.q_norm", "embed.table", "head", "ln_f.scale",
            "blocks.0.mlp.w_gate"} <= set(names)
    assert names["blocks.0.attn.wq"].shape == (cfg.d_model,
                                               cfg.n_heads * cfg.head_dim)
    init_params(model, torch.Generator().manual_seed(0))
    assert float(names["ln_f.scale"].min()) == 1.0
    assert abs(float(names["embed.table"].std()) - 0.02) < 2e-3
    wq = names["blocks.0.attn.wq"]
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert isinstance(model.blocks, torch.nn.ModuleList)
    assert isinstance(model.blocks[0], ParamModule)


@pytest.mark.parametrize("impl", ["flash_pallas", "flash_jnp"])
def test_prefill_matches_forward_and_cache_defs(impl):
    """prefill's last-token logits are logits_fn of forward_hidden's last
    row, and its caches have the shapes and dtypes ``cache_defs``
    declares (the rolling window caps them at the window)."""
    tcfg, model, ref = _port_model("h2o-danube-1.8b", impl, window=16)
    batch = {"tokens": torch.from_numpy(ref["toks"])}
    logits, cache = TT.prefill(tcfg, model, batch, CACHE_LEN)
    with torch.no_grad():
        hidden, aux = TT.forward_hidden(tcfg, model, batch)
        last = TT.logits_fn(tcfg, model, hidden[:, -1:])
    assert aux == 0.0
    np.testing.assert_allclose(last.numpy(), logits.numpy(), atol=1e-5,
                               rtol=1e-5)
    defs = TT.cache_defs(tcfg, BATCH, CACHE_LEN)["attn"]
    assert len(defs) == len(cache["attn"]) == tcfg.n_layers
    for d, c in zip(defs, cache["attn"]):
        for key in ("k", "v", "slot_pos"):
            assert tuple(c[key].shape) == d[key].shape
        assert c["slot_pos"].dtype == d["slot_pos"].dtype == torch.int32
    assert defs[0]["k"].shape[1] == 16


def test_other_families_refused():
    """Every LM family is ported; the stencil family (the reference's
    stencil-suite, the dry run's arch) and an unknown one raise, as the
    reference's ``block_defs`` does, and the stencil-suite config is the
    reference's, field for field."""
    for family in ("stencil", "rnn"):
        cfg = dataclasses.replace(TC.get_config("h2o-danube-1.8b").reduced(),
                                  family=family)
        with pytest.raises(ValueError, match=family):
            TT.param_defs(cfg)
        with pytest.raises(ValueError, match=family):
            TT.forward_hidden(cfg, None, {})
    r, t = RC.get_config("stencil-suite"), TC.get_config("stencil-suite")
    assert (t.family, t.n_layers, t.d_model, t.source) == (
        r.family, r.n_layers, r.d_model, r.source) == (
        "stencil", 0, 0, "ICS'23 EBISU Table 2")


def test_launch_serve_runs_on_cpu():
    out = tserve.run("h2o-danube-1.8b", batch=2, prompt_len=64, max_new=3,
                     repeats=1, device="cpu", attention_impl="flash_pallas")
    assert out.tokens.shape == (2, 3) and out.tokens.dtype == torch.int32
    assert int(out.tokens.min()) >= 0 and int(out.tokens.max()) < 256
    assert out.kernel_launches_per_prefill == 0      # plain version on CPU
    assert out.decode_steps == 2 and out.prefill_ms > 0
    assert out.device == "cpu"
    sharded = tserve.run("h2o-danube-1.8b", batch=2, prompt_len=64,
                         max_new=3, repeats=1, device="cpu",
                         attention_impl="flash_pallas", n_data=2, n_model=2)
    assert torch.equal(sharded.tokens, out.tokens)   # the same greedy run


def test_launch_serve_refuses_bad_attention_impl_before_init(monkeypatch):
    def no_init(*a, **k):
        raise AssertionError("weights were made before the impl was checked")

    monkeypatch.setattr(tserve, "init_params", no_init)
    with pytest.raises(ValueError, match="has no program mapping"):
        tserve.run("h2o-danube-1.8b", device="cpu", attention_impl="pallas")

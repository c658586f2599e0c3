"""The port's other LM families against the JAX reference, on the CPU:
serving.  mamba2-130m (SSM), zamba2-2.7b (hybrid), granite-moe-3b-a800m
and qwen3-moe-235b-a22b (MoE, dense dispatch), hubert-xlarge (encoder)
and internvl2-1b (VLM), each at ``reduced()`` size, with the reference's
``tree_init`` weights carried across by ``params_from_jax``
(``tests/families_ref.py`` holds the configs, inputs and the reference's
runs; ``tests/test_torch_families_train.py`` the training half):

  * the parameter trees (the hybrid's unstacked ``shared_attn``, the MoE
    experts' leading ``E`` inside each block, ``patch_proj``,
    ``mask_embed``, the encoder's head and its empty ``embed_in``);
  * prefill logits and caches, two decode steps and the greedy tokens
    (the encoder: its last frame's logits and an empty cache); prefill
    of a hybrid whose layers are no multiple of ``attn_every`` (ceil(4/3)
    = 2 shared invocations) and of a MoE at ``capacity_factor=1.0``,
    where slots drop; bfloat16 prefills;
  * decode equal to the forward (``tests/test_arch_smoke.py``'s check),
    the cache shapes ``cache_defs`` declares, and ``launch.serve.run``
    (which refuses the encoder).

Tolerances: 2e-5 for forwards, 0.06 for bfloat16.  The hybrid's caches
are held at 1e-4, the reference suite's prefill-and-decode tolerance
(``tests/test_arch_smoke.py``), and only its first mamba layer's and
first shared invocation's at 2e-5 (0.06 in bfloat16): at the reference's
init each mamba layer about doubles a rounding difference in its input
(relative error 5e-7 at the first layer's state, 5e-6 at the fourth's in
float32; 1.2e-2 and 6.6e-2 in bfloat16), so the states and the shared
block's k and v behind them differ by up to 8e-5 in float32 while the
logits stay within 2e-5.
"""
import jax
import numpy as np
import pytest
import torch

from families_ref import (BATCH, CACHE_LEN, DECODERS, F32, FAMILIES, NEW,
                          SEQ, cfgs, port, serve_reference, to_torch)
from repro.models import transformer as RT
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.models.params import params_from_jax
from repro_torch.serve import serve_step as TS

# prefill only: a hybrid with a partial last group, a MoE that drops slots
VARIANTS = [("zamba2-2.7b", (("attn_every", 3),)),
            ("granite-moe-3b-a800m", (("moe_capacity", 1.0),))]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps this module
    from oversubscribing the CPU the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(name, extra=(), dtype="float32", **kw):
    ref = serve_reference(name, extra, dtype)
    return (*port(name, ref, extra, dtype, **kw), ref)


def _check_cache(got, want, tol, what):
    assert sorted(got) == sorted(want), what
    for part, layers in got.items():
        for i, layer in enumerate(layers):
            assert sorted(layer) == sorted(want[part]), (what, part)
            for key, t in layer.items():
                np.testing.assert_allclose(
                    t.float().numpy(), want[part][key][i], atol=tol,
                    rtol=tol, err_msg=f"{what}: {part}[{i}].{key}")


def _front(got, want):
    """The hybrid's caches in front of the amplification (module
    docstring): the first mamba layer's and the first shared
    invocation's."""
    return ({part: layers[:1] for part, layers in got.items()},
            {part: {key: a[:1] for key, a in parts.items()}
             for part, parts in want.items()})


# ------------------------------------------------------------- params ----
@pytest.mark.parametrize("name", FAMILIES)
def test_params_tree_matches_reference(name):
    rcfg, tcfg = cfgs(name)
    model = TT.build_model(tcfg, "cpu")
    got = {k: tuple(p.shape) for k, p in model.named_parameters()}
    want = {k: tuple(v.shape) for k, v in params_from_jax(jax.tree.map(
        lambda d: np.zeros(d.shape, np.float32), RT.param_defs(rcfg),
        is_leaf=lambda d: hasattr(d, "fan_in"))).items()}
    assert got == want
    assert tcfg.n_params() == rcfg.n_params()
    assert tcfg.n_active_params() == rcfg.n_active_params()
    fam = tcfg.family
    if fam == "hybrid":
        assert "shared_attn.attn.wq" in got and "blocks.0.ssm.A_log" in got
    if fam == "moe":
        assert got["blocks.1.moe.w_up"] == (16, tcfg.d_model, tcfg.d_ff)
        assert got["blocks.0.moe.router"] == (tcfg.d_model, 16)
    if fam == "encoder":
        assert {"mask_embed", "head"} <= set(got)
        assert not any(k.startswith(("embed", "embed_in")) for k in got)
    if fam == "vlm":
        assert got["patch_proj"] == (tcfg.vlm_patch_dim, tcfg.d_model)


# ------------------------------------------------------------ serving ----
@pytest.mark.parametrize("name", DECODERS)
def test_prefill_decode_and_greedy_match_reference(name):
    tcfg, model, ref = _port(name)
    prompt = to_torch(ref["prompt"])
    cl = CACHE_LEN
    logits, cache = TT.prefill(tcfg, model, prompt, cl)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=F32,
                               rtol=F32)
    hybrid = tcfg.family == "hybrid"
    tol = 1e-4 if hybrid else F32
    _check_cache(cache, ref["cache"], tol, "prefill cache")
    if hybrid:
        _check_cache(*_front(cache, ref["cache"]), F32, "prefill cache, "
                     "layer 0")
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    for i, (want_l, want_c) in enumerate(ref["steps"]):
        lg, cache = TT.decode_step(tcfg, model, cache, tok[:, None], SEQ + i)
        np.testing.assert_allclose(lg.numpy(), want_l, atol=F32, rtol=F32)
        _check_cache(cache, want_c, tol, f"decode step {i}")
        if hybrid:
            _check_cache(*_front(cache, want_c), F32, f"decode step {i}, "
                         "layer 0")
        tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)
    greedy = TS.greedy_generate(tcfg, model, prompt, NEW, cl)
    np.testing.assert_array_equal(greedy.numpy(), ref["greedy"])


@pytest.mark.parametrize("name,extra", VARIANTS,
                         ids=[f"{n}-{k}{v}" for n, ((k, v),) in VARIANTS])
def test_prefill_variants_match_reference(name, extra):
    """The hybrid with shared invocations at layers 0 and 3 of 4 (the
    cache slot ``layer // attn_every``), and the MoE at capacity 1.0."""
    tcfg, model, ref = _port(name, extra)
    logits, cache = TT.prefill(tcfg, model, to_torch(ref["prompt"]),
                               CACHE_LEN)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=F32,
                               rtol=F32)
    _check_cache(cache, ref["cache"], 1e-4 if tcfg.family == "hybrid"
                 else F32, "prefill cache")
    if tcfg.family == "hybrid":
        _check_cache(*_front(cache, ref["cache"]), F32, "prefill cache, "
                     "layer 0")
        assert len(cache["shared_attn"]) == -(-tcfg.n_layers
                                              // tcfg.attn_every) == 2


def test_encoder_prefill_matches_reference():
    tcfg, model, ref = _port("hubert-xlarge")
    logits, cache = TT.prefill(tcfg, model, to_torch(ref["prompt"]), 0)
    assert cache == {} and ref["cache"] == {}
    assert logits.shape == (BATCH, 1, tcfg.vocab)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=F32,
                               rtol=F32)


@pytest.mark.parametrize("name", ["zamba2-2.7b", "internvl2-1b"])
def test_prefill_bf16_matches_reference(name):
    """Logits within 0.06; the caches too, except the hybrid's behind its
    first mamba layer and first shared invocation, where the mamba layers
    amplify bf16's one-unit input roundings past 0.06 (module docstring;
    its caches are held in float32 above)."""
    tcfg, model, ref = _port(name, dtype="bfloat16")
    assert model.blocks[0].ln1.scale.dtype == torch.bfloat16
    logits, cache = TT.prefill(tcfg, model, to_torch(ref["prompt"]),
                               CACHE_LEN)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=0.06,
                               rtol=0.06)
    if tcfg.family == "hybrid":
        assert cache["ssm"][0]["conv"].dtype == torch.bfloat16
        assert cache["ssm"][0]["state"].dtype == torch.float32
        _check_cache(*_front(cache, ref["cache"]), 0.06,
                     "bf16 prefill cache, layer 0")
    else:
        _check_cache(cache, ref["cache"], 0.06, "bf16 prefill cache")


@pytest.mark.parametrize("name,extra", [(n, ()) for n in DECODERS]
                         + [VARIANTS[0]],
                         ids=DECODERS + ["zamba2-2.7b-attn_every3"])
def test_decode_matches_forward_and_cache_defs(name, extra):
    """prefill(S) + decode(1) logits == forward(S + 1) logits, and the
    prefill cache has the shapes and dtypes ``cache_defs`` declares.
    Chunked attention: S + 1 is no multiple of the kernel's chunks."""
    tcfg, model, ref = _port(name, extra, attention_impl="flash_jnp")
    prompt = to_torch(ref["prompt"])
    s = prompt["tokens"].shape[1]
    nxt = torch.from_numpy(np.array(ref["prompt"]["tokens"][:, :1]))
    logits, cache = TT.prefill(tcfg, model, prompt, CACHE_LEN)
    defs = TT.cache_defs(tcfg, BATCH, CACHE_LEN)
    assert sorted(defs) == sorted(cache)
    for part, layers in defs.items():
        assert len(layers) == len(cache[part])
        for d, c in zip(layers, cache[part]):
            for key, dd in d.items():
                assert tuple(c[key].shape) == dd.shape, (part, key)
                assert c[key].dtype == (dd.dtype or tcfg.activ_dtype)
    l1, _ = TT.decode_step(tcfg, model, cache, nxt, SEQ)
    longer = dict(prompt, tokens=torch.cat([prompt["tokens"], nxt], dim=1))
    with torch.no_grad():
        for batch, want in ((prompt, logits), (longer, l1)):
            hidden, _ = TT.forward_hidden(tcfg, model, batch)
            full = TT.logits_fn(tcfg, model, hidden)
            assert hidden.shape[1] == batch["tokens"].shape[1] == s + (
                batch is longer)
            np.testing.assert_allclose(full[:, -1].numpy(),
                                       want[:, 0].numpy(), atol=1e-4,
                                       rtol=1e-4)


# ----------------------------------------------------------- training ----
@pytest.mark.parametrize("name", FAMILIES)
def test_launch_serve_runs_on_cpu(name):
    if name == "hubert-xlarge":
        with pytest.raises(ValueError, match="encoder-only"):
            tserve.run(name, device="cpu")
        return
    out = tserve.run(name, batch=2, prompt_len=32, max_new=3, repeats=1,
                     device="cpu", attention_impl="flash_pallas")
    assert out.tokens.shape == (2, 3) and out.tokens.dtype == torch.int32
    assert 0 <= int(out.tokens.min()) and int(out.tokens.max()) < 256
    assert out.kernel_launches_per_prefill == 0   # plain version on CPU

"""The port's training path against the JAX reference, on the CPU.

Reduced h2o-danube-1.8b (2 layers, window cut to 48 so it binds at 128
tokens) and reduced minicpm-2b (the WSD schedule), float32.  The
reference's parameters and optimizer state (``tree_init``, carried across
with ``params_from_jax``) and numpy-seeded token batches go through

  * ``transformer.train_loss`` and its gradients (loss and every gradient
    leaf within 1e-4), with and without remat, through the flash kernels'
    plain versions (``flash_pallas``) and the chunked path
    (``flash_jnp``); the loss chunk (48) leaves a remainder chunk;
  * one and two ``make_train_step`` steps with ``microbatches`` 1 and 2
    (parameters within 2e-4, the reference's own microbatch tolerance,
    ``tests/test_arch_smoke.py``), and a step from the reference's
    second-step state (moments and count carried across);
  * ``schedule_lr`` at every step of 100-step cosine, WSD and constant
    horizons (float32 on both sides, within one float32 unit in the last
    place of the peak LR: the libraries' ``cos`` may round differently),
    ``batch_for_step`` bit for bit, ``Prefetcher`` order.

The reference runs ``flash_jnp``: its Pallas path cannot run on this jax.
Each reference train step is compiled once, in a module-scoped fixture.
Then the port's own trainer: ten steps straight equal five, a resume and
five more, bit for bit (the reference's contract, ``tests/
test_train_driver.py``, is allclose at 2e-3); the checkpoint refusals of
``tests/test_checkpoint.py``; and a regression test for the reference
writer's race between an async and a blocking save of one step.
"""
import dataclasses
import functools
import json
import os

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
from repro.train import data as RD
from repro.train import optimizer as ropt
from repro.train import train_step as RTS
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.params import params_from_jax
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import data as TD
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as TTS

BATCH, SEQ = 4, 128
LOSS, GRAD, PARAMS = 1e-4, 1e-4, 2e-4
ARCHS = {"h2o-danube-1.8b": dict(swa_window=48),
         "minicpm-2b": {}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps this module
    from oversubscribing the CPU the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, microbatches=1):
    kw = dict(ARCHS[arch], q_chunk=32, kv_chunk=32, loss_chunk=48,
              microbatches=microbatches)
    r = dataclasses.replace(RC.get_config(arch).reduced(),
                            attention_impl="flash_jnp", **kw)
    t = dataclasses.replace(TC.get_config(arch).reduced(), **kw)
    return r, t


def _ocfg(mod, arch):
    return mod.OptConfig(lr=1e-3, warmup=1, total_steps=100,
                         schedule=RC.get_config(arch).schedule)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


@functools.lru_cache(maxsize=None)
def reference(arch, microbatches):
    """The reference's init, batch, loss and grads at init (one jit), and
    two jitted train steps (one compile)."""
    rcfg, _ = _cfgs(arch, microbatches)
    key = jax.random.PRNGKey(3)
    defs = RT.param_defs(rcfg)
    params = tree_init(defs, key, rcfg.param_dtype)
    state = tree_init(ropt.opt_state_defs(defs, data_size=1), key)
    toks = np.random.default_rng(5).integers(0, rcfg.vocab, (BATCH, SEQ),
                                             np.int32)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    out = dict(params0=_np_tree(params), state0=_np_tree(state), toks=toks)
    if microbatches == 1:
        loss, grads = jax.jit(jax.value_and_grad(functools.partial(
            RTS.loss_fn, rcfg)))(params, batch)
        out.update(loss=float(loss), grads=_np_tree(grads))
    step = jax.jit(RTS.make_train_step(rcfg, _ocfg(ropt, arch)))
    for i in (1, 2):
        params, state, metrics = step(params, state, batch)
        out[f"params{i}"], out[f"state{i}"] = _np_tree(params), \
            _np_tree(state)
        out[f"metrics{i}"] = {k: float(v) for k, v in metrics.items()}
    return out


def _port(arch, impl, microbatches=1, remat=False, at=0):
    """The port's model and optimizer state loaded from the reference's
    step ``at``, and its batch."""
    ref = reference(arch, microbatches)
    _, tcfg = _cfgs(arch, microbatches)
    tcfg = dataclasses.replace(tcfg, attention_impl=impl, remat=remat)
    model = TT.build_model(tcfg, "cpu")
    model.load_state_dict(params_from_jax(ref[f"params{at}"]))   # strict
    st = ref[f"state{at}"]
    state = {"m": params_from_jax(st["m"]), "v": params_from_jax(st["v"]),
             "count": torch.tensor(int(st["count"]), dtype=torch.int32)}
    toks = torch.from_numpy(ref["toks"])
    return tcfg, model, state, {"tokens": toks, "labels": toks}, ref


def _check_params(model, want, tol, what):
    got = {k: p.detach().numpy() for k, p in model.named_parameters()}
    want = {k: v.numpy() for k, v in params_from_jax(want).items()}
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=tol,
                                   err_msg=f"{what}: {k}")


IMPLS = ["flash_pallas", "flash_jnp"]


@pytest.mark.parametrize("remat", [False, True], ids=["noremat", "remat"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_loss_and_grads_match_reference(arch, impl, remat):
    cfg, model, _, batch, ref = _port(arch, impl, remat=remat)
    loss = TTS.loss_fn(cfg, model, batch)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - ref["loss"]) < LOSS
    want = params_from_jax(ref["grads"])
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=GRAD,
                                   rtol=GRAD, err_msg=n)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_steps_match_reference(arch, impl, microbatches):
    """Two AdamW steps from the reference's init, and one from its
    first-step state, carried across with its moments and count."""
    cfg, model, state, batch, ref = _port(arch, impl, microbatches,
                                          remat=True)
    step = TTS.make_train_step(cfg, _ocfg(topt, arch))
    for i in (1, 2):
        model, state, metrics = step(model, state, batch)
        want = ref[f"metrics{i}"]
        assert abs(float(metrics["loss"]) - want["loss"]) < LOSS
        assert abs(float(metrics["grad_norm"]) - want["grad_norm"]) \
            < 1e-4 * max(1.0, want["grad_norm"])
        assert float(metrics["lr"]) == want["lr"]
        assert int(state["count"]) == i
        _check_params(model, ref[f"params{i}"], PARAMS, f"step {i}")
    cfg, model, state, batch, ref = _port(arch, impl, microbatches, at=1)
    model, state, _ = TTS.make_train_step(cfg, _ocfg(topt, arch))(
        model, state, batch)
    _check_params(model, ref["params2"], PARAMS, "step 2 from step 1")
    for mom in ("m", "v"):
        want = params_from_jax(ref["state2"][mom])
        for k, t in state[mom].items():
            assert t.dtype == torch.float32
            np.testing.assert_allclose(t.numpy(), want[k].numpy(),
                                       atol=PARAMS, rtol=PARAMS,
                                       err_msg=f"{mom} {k}")


def test_microbatched_grads_accumulate_in_float32(monkeypatch):
    """With microbatches > 1 the step adds each slice's gradients into
    float32 buffers: bf16 parameters' gradients are never summed in
    bf16."""
    _, cfg = _cfgs("h2o-danube-1.8b", 2)
    cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16,
                              activ_dtype=torch.bfloat16)
    model = TT.build_model(cfg, "cpu")
    from repro_torch.models.params import init_params
    init_params(model, torch.Generator().manual_seed(0))
    seen = {}
    real = topt.adamw_update

    def spy(ocfg, params, grads, state):
        seen.update({k: g.dtype for k, g in grads.items()})
        return real(ocfg, params, grads, state)

    monkeypatch.setattr(topt, "adamw_update", spy)
    toks = torch.from_numpy(reference("h2o-danube-1.8b", 1)["toks"])
    state = topt.init_state(model)
    TTS.make_train_step(cfg, topt.OptConfig())(
        model, state, {"tokens": toks, "labels": toks})
    assert set(seen.values()) == {torch.float32}
    assert model.blocks[0].attn.wq.dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in state["m"].values())


# ------------------------------------------------------------ pieces ----
@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_schedule_lr_matches_reference(schedule):
    kw = dict(lr=3e-4, warmup=10, total_steps=100, schedule=schedule)
    rc, tc = ropt.OptConfig(**kw), topt.OptConfig(**kw)
    want = np.array([float(ropt.schedule_lr(rc, jnp.int32(s)))
                     for s in range(100)], np.float32)
    got = np.array([float(topt.schedule_lr(tc, s)) for s in range(100)],
                   np.float32)
    # float32 on both sides; the libraries' cos may round differently,
    # which shows near the end of the cosine, where 1 + cos is small
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -23 * 3e-4)


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 12)])
def test_batch_for_step_matches_reference(seed, step):
    rcfg, tcfg = _cfgs("h2o-danube-1.8b")
    shapes = {"tokens": jax.ShapeDtypeStruct((3, 40), jnp.int32),
              "labels": jax.ShapeDtypeStruct((3, 40), jnp.int32)}
    want = RD.batch_for_step(rcfg, "train_4k", step, seed, shapes)
    got = TD.batch_for_step(tcfg, "train_4k", step, seed,
                            {k: v.shape for k, v in shapes.items()},
                            device="cpu")
    for k in want:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    pf = TD.Prefetcher(tcfg, "train_4k", start_step=step, seed=seed,
                       reduced_shapes={k: v.shape for k, v in
                                       shapes.items()})
    try:
        for i in range(step, step + 3):
            j, b = pf.next()
            assert j == i
            ref = RD.batch_for_step(rcfg, "train_4k", i, seed, shapes)
            np.testing.assert_array_equal(b["tokens"].numpy(),
                                          np.asarray(ref["tokens"]))
    finally:
        pf.close()


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_ce_loss_matches_reference(masked):
    """Chunks of 48 over 100 tokens: two full chunks and a remainder."""
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((2, 100, 16), dtype=np.float32)
    table = rng.standard_normal((50, 16), dtype=np.float32)
    labels = rng.integers(0, 50, (2, 100), np.int32)
    mask = (rng.random((2, 100)) < 0.7).astype(np.float32) if masked \
        else None
    want = RL.chunked_ce_loss(jnp.asarray(hidden), jnp.asarray(table),
                              jnp.asarray(labels),
                              None if mask is None else jnp.asarray(mask),
                              chunk=48, logit_pspec=(None, None, None))
    h = torch.from_numpy(hidden).requires_grad_()
    got = TL.chunked_ce_loss(h, torch.from_numpy(table),
                             torch.from_numpy(labels),
                             None if mask is None else torch.from_numpy(mask),
                             chunk=48)
    assert abs(float(got.detach()) - float(want)) < LOSS
    got.backward()
    assert torch.isfinite(h.grad).all()


# ----------------------------------------------------------- trainer ----
def _run(tmp, steps, **kw):
    return tlaunch.train("h2o-danube-1.8b", steps=steps, batch=4, seq=32,
                         ckpt_dir=str(tmp), ckpt_every=5, lr=1e-2, seed=3,
                         schedule_steps=10, device="cpu", **kw)


def test_resume_is_bit_exact(tmp_path):
    """Ten steps straight == five, a crash, a resume and five more, bit
    for bit: parameters, moments and losses."""
    p_a, s_a, l_straight = _run(tmp_path / "a", 10)
    _run(tmp_path / "b", 5)
    assert tckpt.latest_step(str(tmp_path / "b")) == 5
    p_b, s_b, l_resumed = _run(tmp_path / "b", 10)
    assert len(l_resumed) == 5
    assert l_resumed == l_straight[5:]
    np.testing.assert_allclose(l_straight[5:], l_resumed, rtol=2e-3,
                               atol=2e-3)
    for (n, a), (_, b) in zip(p_a.named_parameters(), p_b.named_parameters()):
        assert torch.equal(a, b), n
    assert int(s_a["count"]) == int(s_b["count"]) == 10
    for mom in ("m", "v"):
        for k in s_a[mom]:
            assert torch.equal(s_a[mom][k], s_b[mom][k]), (mom, k)
    assert l_straight[-1] < l_straight[0]
    assert tlaunch.train.last_stats.device == "cpu"


def test_launch_train_cli_and_refusals(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "h2o-danube-1.8b", "--steps", "2", "--batch",
        "2", "--seq", "32", "--device", "cpu"])
    tlaunch.main()
    out = capsys.readouterr().out
    assert "[train] step 1 loss" in out and "tok/s" in out
    _, _, one = tlaunch.train("h2o-danube-1.8b", steps=2, batch=2, seq=32,
                              device="cpu")
    _, _, mesh = tlaunch.train("h2o-danube-1.8b", steps=2, batch=2, seq=32,
                               device="cpu", n_data=2, n_model=2)
    np.testing.assert_allclose(mesh, one, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="has no program mapping"):
        tlaunch.train("h2o-danube-1.8b", device="cpu",
                      attention_impl="pallas")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            tlaunch.train("h2o-danube-1.8b", steps=1)


# -------------------------------------------------------- checkpoints ----
def _tree(step: int) -> dict:
    return {"w": torch.full((8, 8), float(step)),
            "b": torch.arange(4, dtype=torch.float32) * step}


def test_latest_step_skips_corrupt_manifest(tmp_path):
    tckpt.save(str(tmp_path), 1, _tree(1), block=True)
    tckpt.save(str(tmp_path), 2, _tree(2), block=True)
    with open(tmp_path / "step_2" / "manifest.json", "w") as f:
        f.write('{"step": 2, "leav')          # truncated mid-write
    assert tckpt.latest_step(str(tmp_path)) == 1
    got = tckpt.restore(str(tmp_path), 1, _tree(0))
    assert (got["w"] == 1.0).all()


def test_restore_refuses_corrupt_manifest(tmp_path):
    tckpt.save(str(tmp_path), 3, _tree(3), block=True)
    with open(tmp_path / "step_3" / "manifest.json", "w") as f:
        f.write("not json at all")
    with pytest.raises(ValueError, match="corrupt|manifest"):
        tckpt.restore(str(tmp_path), 3, _tree(3))


def test_restore_refuses_manifest_without_leaves(tmp_path):
    tckpt.save(str(tmp_path), 3, _tree(3), block=True)
    tckpt.save(str(tmp_path), 4, _tree(4), block=True)
    with open(tmp_path / "step_4" / "manifest.json", "w") as f:
        json.dump({"step": 4}, f)             # parses, but no leaves table
    with pytest.raises(ValueError, match="corrupt"):
        tckpt.restore(str(tmp_path), 4, _tree(4))
    assert tckpt.latest_step(str(tmp_path)) == 3   # skipped by resume


def test_tmp_dirs_invisible_to_latest_step(tmp_path):
    tckpt.save(str(tmp_path), 5, _tree(5), block=True)
    os.makedirs(tmp_path / "step_9.tmp12345")
    with open(tmp_path / "step_9.tmp12345" / "manifest.json", "w") as f:
        json.dump({"step": 9, "leaves": {}}, f)
    assert tckpt.latest_step(str(tmp_path)) == 5


def test_async_then_blocking_save_of_one_step_never_loses_leaves(tmp_path):
    """The reference's race: an async save of step N still running when a
    blocking save of N returns can remove and re-create ``step_N`` under
    the restore that follows, and then leave its own, older tree there.
    Here the blocking save joins every pending writer first: 20 times in
    a row, the restore right after it finds every leaf with the values
    it wrote, and so does a restore once all writers are done.  The
    async tree carries an extra 8 MB leaf, so its writer is the slower."""
    big = {"w": torch.zeros((512, 512)), "b": torch.zeros(4),
           "h": torch.zeros((64, 64), dtype=torch.bfloat16)}
    for i in range(20):
        tree = {k: v + i for k, v in big.items()}
        older = {k: v - 1 for k, v in tree.items()}
        older["pad"] = torch.zeros(1 << 21)
        tckpt.save(str(tmp_path), 7, older)
        tckpt.save(str(tmp_path), 7, tree, block=True)
        for when in ("at once", "after every writer"):
            got = tckpt.restore(str(tmp_path), 7, big)
            for k in big:
                assert torch.equal(got[k], tree[k]), (i, when, k)
                assert got[k].dtype == big[k].dtype
            tckpt.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_7"]

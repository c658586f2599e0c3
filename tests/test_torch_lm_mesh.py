"""LM-side parallelism of the port on meshes of CPU shards.

``models/parallel.py`` runs every LM family tensor-parallel over
``model``, data-parallel over ``data`` and the MoE expert-parallel, one
process driving a mesh of CPU shards (``launch/mesh.py``); the
optimizer's moments are ZeRO-sharded and checkpoints restore onto
another mesh.  Held here, at ``reduced()`` size, float32:

  * every family's prefill, two decode steps and the greedy tokens on
    ``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` meshes against the port's
    unsharded path (logits within 2e-5, tokens equal; the unsharded path
    is held to the reference by ``test_torch_families.py`` and
    ``test_torch_lm.py``), and the dense and MoE families on ``(2, 2)``
    against the reference's own runs (``families_ref.serve_reference``);
  * train steps of the dense, MoE and SSM families on ``(2, 1)`` and
    ``(2, 2)`` against the unsharded step at ``test_torch_train.py``'s
    tolerances (loss and gradients 1e-4, parameters after two AdamW steps
    2e-4, lr 1e-3);
  * ``apply_moe_ep`` at ``capacity_factor`` 64 (the reference's case)
    and 1.0 (with drops) against the reference's ``apply_moe`` on each
    data shard, the aux loss within 5 % of the global one;
  * the elastic restart of ``tests/test_train_driver.py``: mamba2, six
    steps on one device, resumed on ``(2, 1)`` to nine;
  * ``with_mesh``, ``input_specs``/``input_pspecs``, the parameter and
    cache specs, ``fsdp_transform``, ``zero_pspec``/``opt_state_defs``
    and ``make_production_mesh`` spec for spec against the reference,
    for every config;
  * the exact collective counts and flash calls per shard, and the
    refusal of ``sharding="fsdp"``.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import families_ref as FR
import repro.configs as RC
import repro_torch.configs as TC
from repro.launch import mesh as RM
from repro.models import moe as RMOE
from repro.models import transformer as RT
from repro.models.params import is_def, map_stacked as rmap_stacked
from repro.train import optimizer as ropt
from repro_torch.core import distributed as D
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import moe as TMOE
from repro_torch.models import parallel as TP
from repro_torch.models import transformer as TT
from repro_torch.models.params import (NamedSharding, ParamModule,
                                       flat_defs, fsdp_transform,
                                       init_params, map_stacked,
                                       params_from_jax, tree_shardings)
from repro_torch.serve import serve_step as TS
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import loss_fn, make_train_step

MESHES = [(2, 2), (1, 4), (4, 1)]
ALL = FR.FAMILIES + ["h2o-danube-1.8b"]
ARCHS = [n for n in RC.list_archs() if n != "stencil-suite"]
B, S, NEW = 4, 48, 3
F32 = 2e-5
LOSS, GRAD, PARAMS = 1e-4, 1e-4, 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps this module
    from oversubscribing the CPU the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    return tmesh.make_host_mesh(*shape, devices=tmesh.ensure_fake_devices(
        math.prod(shape)))


def _cfg(name, **kw):
    return dataclasses.replace(TC.get_config(name).reduced(),
                               attention_impl="flash_pallas",
                               **dict(FR.KW, **kw))


def _prompt(cfg, batch=B):
    rng = np.random.default_rng(7)
    if cfg.family == "encoder":
        return {"frames": torch.from_numpy(rng.standard_normal(
            (batch, S, cfg.d_model), dtype=np.float32))}
    s = S - (cfg.vlm_patches if cfg.family == "vlm" else 0)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (batch, s),
                                                   np.int32))}
    if cfg.family == "vlm":
        out["patches"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.vlm_patches, cfg.vlm_patch_dim), dtype=np.float32))
    return out


@functools.lru_cache(maxsize=None)
def _unsharded(name):
    """The port's unsharded model, its prefill logits and its greedy
    tokens and decode logits (``NEW`` tokens)."""
    cfg = _cfg(name)
    model = init_params(TT.build_model(cfg, "cpu"),
                        torch.Generator().manual_seed(0))
    return cfg, model, _serve(cfg, model, _prompt(cfg))


def _serve(cfg, params, prompt):
    """Prefill logits, then greedy decode → (prefill logits, [decode
    logits], tokens)."""
    cache_len = S + NEW + 8
    logits, cache = TT.prefill(cfg, params, prompt, cache_len)
    if cfg.family == "encoder":
        return logits, [], None
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    toks, steps = [tok], []
    for i in range(NEW - 1):
        lg, cache = TT.decode_step(cfg, params, cache, tok[:, None], S + i)
        steps.append(lg)
        tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)
        toks.append(tok)
    return logits, steps, torch.stack(toks, dim=1)


# ------------------------------------------------------------ serving ----
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ALL)
def test_mesh_serving_matches_unsharded(name, shape):
    """Prefill, decode and greedy tokens of every family on a mesh equal
    the unsharded path's (the VLM's positions count its patches in both,
    so decode starts at ``S``)."""
    cfg, model, (want, want_steps, want_toks) = _unsharded(name)
    mesh = _mesh(shape)
    mcfg = cfg.with_mesh(mesh)
    mm = TP.MeshModel(mcfg, mesh, model)
    got, steps, toks = _serve(mcfg, mm, _prompt(cfg))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32, rtol=F32)
    for g, w in zip(steps, want_steps):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=F32, rtol=F32)
    if toks is not None:
        assert torch.equal(toks, want_toks)


@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "granite-moe-3b-a800m"])
def test_mesh_serving_matches_reference(name):
    """The dense and MoE families on a (2, 2) mesh against the
    reference's prefill, decode steps and greedy tokens, with its
    weights carried across (batch 2: one row a data shard)."""
    ref = FR.serve_reference(name)
    cfg, model = FR.port(name, ref)
    mesh = _mesh((2, 2))
    mcfg = cfg.with_mesh(mesh)
    mm = TP.MeshModel(mcfg, mesh, model)
    prompt = FR.to_torch(ref["prompt"])
    logits, cache = TT.prefill(mcfg, mm, prompt, FR.CACHE_LEN)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=F32,
                               rtol=F32)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    toks = [tok]
    for i, (want, _) in enumerate(ref["steps"]):
        lg, cache = TT.decode_step(mcfg, mm, cache, tok[:, None], FR.SEQ + i)
        np.testing.assert_allclose(lg.numpy(), want, atol=F32, rtol=F32)
        tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)
        toks.append(tok)
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(),
                                  ref["greedy"])


def test_serve_steps_and_launcher_on_a_mesh(capsys):
    """``serve_step.greedy_generate`` takes a ``MeshModel`` as it takes a
    module, and ``launch.serve`` accepts ``--n-data 2 --n-model 2`` and
    prints the collectives a prefill took."""
    cfg, model, (_, _, want) = _unsharded("internvl2-1b")
    mesh = _mesh((2, 2))
    mcfg = cfg.with_mesh(mesh)
    got = TS.greedy_generate(mcfg, TP.MeshModel(mcfg, mesh, model),
                             _prompt(cfg), NEW, S + NEW + 8)
    assert torch.equal(got, want)
    res = tserve.run("granite-moe-3b-a800m", batch=4, prompt_len=16,
                     max_new=2, repeats=1, device="cpu", n_data=2,
                     n_model=2, attention_impl="flash_pallas")
    out = capsys.readouterr().out
    assert "on a (2, 2) mesh of cpux4" in out
    assert "collectives per prefill: 14" in out
    assert res.collectives_per_prefill == {
        "psum": {"model": 5}, "pmean": {"data": 2},
        "all_gather": {"model": 1, "data": 6}}
    assert res.tokens.shape == (4, 2)


# ------------------------------------------------------------- counts ----
def _want_counts(cfg, shape):
    """The collectives one prefill takes on a ``(data, model)`` mesh."""
    nd, nm = shape
    n_inv = TT.n_shared_invocations(cfg)
    attn = cfg.kv_heads % nm == 0 and nm > 1
    mlp = cfg.d_ff % nm == 0 and nm > 1
    emb = cfg.d_model % nm == 0 and nm > 1
    ssm = 2 * cfg.n_layers * (nm > 1 and cfg.ssm_heads % nm == 0)
    psum = {"ssm": ssm, "hybrid": ssm + n_inv * (attn + mlp)}.get(
        cfg.family, cfg.n_layers * attn)
    if cfg.family in ("dense", "vlm", "encoder"):
        psum += cfg.n_layers * mlp
    out = {}
    if cfg.family == "moe":
        ep = nm > 1 and cfg.n_experts_padded % nm == 0
        psum += cfg.n_layers * ep
        gathers = 3 * cfg.n_layers if nd > 1 else 0
        if not ep and nd > 1:
            gathers += cfg.n_layers                  # the tokens
        if gathers:
            out.setdefault("all_gather", {})["data"] = gathers
        if ep and nd > 1:
            out["pmean"] = {"data": cfg.n_layers}
    psum += emb                                      # the logits
    if psum:
        out["psum"] = {"model": psum}
    if emb and cfg.family != "encoder":
        out.setdefault("all_gather", {})["model"] = 1
    return out


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ALL)
def test_prefill_collectives_and_flash_calls(name, shape, monkeypatch):
    """A prefill's collectives, counted per axis, are exactly those the
    layout predicts, and the flash wrapper runs once per attending layer
    per shard at the shard's heads and rows (on CPU tensors its plain
    version: the card's launches are counted by ``chip_smoke.py``)."""
    cfg, model, _ = _unsharded(name)
    mesh = _mesh(shape)
    mcfg = cfg.with_mesh(mesh)
    mm = TP.MeshModel(mcfg, mesh, model)
    calls = []
    plain = fa.flash_attention_fwd_plain

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return plain(q, k, v, **kw)

    monkeypatch.setattr(fa, "flash_attention_fwd_plain", spy)
    D.reset_collectives()
    TT.prefill(mcfg, mm, _prompt(cfg), S + 8)
    assert D.collective_counts() == _want_counts(cfg, shape)
    nd, nm = shape
    heads_split = cfg.kv_heads % nm == 0
    h = cfg.n_heads // nm if heads_split else cfg.n_heads
    kv = cfg.kv_heads // nm if heads_split else cfg.kv_heads
    rows = B // nd
    n_attn = {"ssm": 0, "hybrid": TT.n_shared_invocations(cfg)}.get(
        cfg.family, cfg.n_layers)
    assert calls == [((rows, S, h, cfg.head_dim),
                      (rows, S, kv, cfg.head_dim))] * (n_attn * nd * nm)


# ------------------------------------------------------------ training ----
TRAIN = [("h2o-danube-1.8b", (2, 1), 1, False),
         ("h2o-danube-1.8b", (2, 2), 2, True),
         ("granite-moe-3b-a800m", (2, 1), 1, False),
         ("granite-moe-3b-a800m", (2, 2), 1, False),
         ("mamba2-130m", (2, 1), 1, False),
         ("mamba2-130m", (2, 2), 2, True)]


def _train_batch(cfg):
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (B, S), np.int32))
    return {"tokens": toks, "labels": toks}


def _ep_aux_oracle(n_data):
    """The dense dispatch with the expert-parallel aux semantics: the
    output of ``apply_moe`` on all rows, and as aux loss the mean of
    ``apply_moe``'s aux on each data shard's rows (``apply_moe_ep``'s
    ``pmean`` over ``data``).  Differentiable through both, so the
    router's gradient from the aux loss is the mesh's by construction."""
    dense = TMOE.apply_moe

    def apply_moe(x, p, **kw):
        y, _ = dense(x, p, **kw)
        aux = [dense(xd, p, **kw)[1] for xd in x.chunk(n_data)]
        return y, sum(aux) / n_data
    return apply_moe


@pytest.mark.parametrize("name,shape,micro,remat", TRAIN)
def test_mesh_train_steps_match_unsharded(name, shape, micro, remat,
                                          monkeypatch):
    """Loss and every gradient leaf at init, then two AdamW steps with
    ZeRO-sharded moments, on a mesh against the unsharded step.  On
    ``(2, 2)`` the MoE runs expert-parallel, whose aux loss (weighed
    0.01 as everywhere) is the mean of the data shards' by design: there
    the unsharded step runs ``_ep_aux_oracle``, so the aux loss's
    backward through the ``pmean`` into the router is held too."""
    cfg = _cfg(name, microbatches=micro, remat=remat, moe_aux_weight=0.01)
    ep = name.startswith("granite") and shape[1] > 1
    _train_matches_unsharded(cfg, cfg, shape, ep, monkeypatch)


def _train_matches_unsharded(cfg, mesh_cfg, shape, ep, monkeypatch):
    """Loss and gradients at init, then two AdamW steps of ``mesh_cfg``
    on a ``shape`` mesh against ``cfg``'s unsharded step (``ep``: the
    unsharded step runs ``_ep_aux_oracle``)."""
    def unsharded(fn, *args):
        with monkeypatch.context() as m:
            if ep:
                m.setattr(TMOE, "apply_moe", _ep_aux_oracle(shape[0]))
            return fn(*args)
    ocfg = topt.OptConfig(lr=1e-3, warmup=1, total_steps=100,
                          schedule=cfg.schedule)
    model = init_params(TT.build_model(cfg, "cpu"),
                        torch.Generator().manual_seed(0))
    mesh = _mesh(shape)
    mcfg = mesh_cfg.with_mesh(mesh)
    mm = TP.MeshModel(mcfg, mesh, model)
    batch = _train_batch(cfg)

    names, leaves = zip(*model.named_parameters())
    loss = unsharded(loss_fn, cfg, model, batch)
    want = dict(zip(names, torch.autograd.grad(loss, leaves)))
    shards = mm.leaves()
    keys = [(n, c) for n in shards for c in np.ndindex(*mesh.devices.shape)]
    mloss = loss_fn(mcfg, mm, batch)
    gs = torch.autograd.grad(mloss, [shards[n][c] for n, c in keys],
                             allow_unused=True)
    grads = {n: np.empty(mesh.devices.shape, dtype=object) for n in shards}
    for (n, c), g in zip(keys, gs):
        grads[n][c] = torch.zeros_like(shards[n][c]) if g is None else g
    grads = TP.replica_grads(mm, grads)
    assert abs(float(mloss.detach()) - float(loss.detach())) < LOSS
    for n in names:
        got = mm.shardings[n].gather(grads[n], mm.flat[n].shape, "cpu")
        np.testing.assert_allclose(got.numpy(), want[n].numpy(), atol=GRAD,
                                   rtol=GRAD, err_msg=n)

    step, mstep = make_train_step(cfg, ocfg), make_train_step(mcfg, ocfg)
    state, mstate = topt.init_state(model), topt.init_state(mm)
    for _ in range(2):
        _, state, m = unsharded(step, model, state, batch)
        _, mstate, mm_metrics = mstep(mm, mstate, batch)
        assert abs(float(mm_metrics["loss"]) - float(m["loss"])) < LOSS
        assert abs(float(mm_metrics["grad_norm"]) - float(m["grad_norm"])) \
            < GRAD * max(1.0, float(m["grad_norm"]))
    got = mm.state_dict()
    for n, p in model.named_parameters():
        np.testing.assert_allclose(got[n].numpy(), p.detach().numpy(),
                                   atol=PARAMS, rtol=PARAMS, err_msg=n)
    for k in ("m", "v"):
        for n, t in state[k].items():
            np.testing.assert_allclose(mstate[k][n].gather("cpu").numpy(),
                                       t.numpy(), atol=PARAMS, rtol=PARAMS,
                                       err_msg=f"{k} {n}")
    assert int(mstate["count"]) == 2


def test_zero_moments_hold_each_element_once():
    """On (2, 2) every moment splits a free dim over ``data`` where one
    divides: the shards of all moments together hold each logical
    element once per model replica of the leaf, and the update puts the
    parameters back whole (one ``all_gather`` over ``data`` per such
    leaf), so the global norm counts each element once."""
    cfg = _cfg("h2o-danube-1.8b")
    mesh = _mesh((2, 2))
    mm = TP.MeshModel(cfg.with_mesh(mesh), mesh)
    state = topt.init_state(mm)
    zero = 0
    for n, d in mm.flat.items():
        m = state["m"][n]
        assert m.shape == d.shape
        local = math.prod(m.sharding.local_shape(d.shape))
        reps = math.prod(mesh.shape[a] for a in
                         m.sharding.replica_axes(d.shape))
        assert local * mesh.size == math.prod(d.shape) * reps
        if m.sharding.local_shape(d.shape) != \
                mm.shardings[n].local_shape(d.shape):
            zero += 1
    assert zero == sum(1 for d in mm.flat.values()
                       if any(n % 2 == 0 for n in d.shape))
    mstep = make_train_step(cfg.with_mesh(mesh), topt.OptConfig(lr=1e-3))
    D.reset_collectives()
    mstep(mm, state, _train_batch(cfg))
    assert D.all_gather.by_axis[("data",)] == zero
    assert D.psum.by_axis[("data", "model")] == 1 + sum(
        1 for n, d in mm.flat.items() if not any(
            a for e in d.pspec if e for a in ((e,) if isinstance(e, str)
                                              else e)))


# ---------------------------------------------------------------- MoE ----
@functools.lru_cache(maxsize=None)
def _ref_moe(**kw):
    """The reference's ``apply_moe``, jitted once per setting."""
    return jax.jit(functools.partial(RMOE.apply_moe, **kw))


@pytest.mark.parametrize("cf", [64.0, 1.0])
@pytest.mark.parametrize("shape", [(2, 4), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_apply_moe_ep(shape, cf):
    """``apply_moe_ep`` against the reference's EP semantics.

    Each model shard ranks its data shard's slots within their expert by
    the count of earlier slots routed there (``moe.py:170-200`` of the
    reference), which is the rank ``apply_moe`` gives the same slots, and
    buckets them at ``max(min_capacity, int(cf·t_local·k/E))`` with no
    rounding to 256.  ``apply_moe`` on the data shard alone computes the
    same capacity wherever it stays ≤ 256 or is a multiple of 256 (else
    it rounds up), so on each data shard the reference's ``apply_moe``
    of that shard's tokens is the oracle, with drops (cf 1.0: 8 or 4
    slots) and without (cf 64: 512 or 256, where it also equals the
    global ``apply_moe``).  The aux loss is the mean of the
    data shards' (``pmean``), within 5 % of the global one, as the
    reference's ``tests/multidev_moe_child.py`` accepts."""
    defs, e_pad = TMOE.moe_defs(64, 128, 8)
    p = init_params(ParamModule(defs), torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 16, 64), dtype=np.float32))
    kw = dict(n_experts=8, n_padded=e_pad, top_k=2, act="swiglu",
              capacity_factor=cf)
    t_local = 4 * 16 // shape[0]
    assert TMOE.capacity(t_local, 2, 8, cf) == max(4, int(cf * t_local
                                                           * 2 / 8))
    mesh = _mesh(shape)
    full = dict(p.named_parameters())
    parts = {n: NamedSharding(mesh, d.pspec).split(full[n].detach())
             for n, d in defs.items()}
    ps = np.empty(mesh.devices.shape, dtype=object)
    for c in np.ndindex(*ps.shape):
        ps[c] = ParamModule({n: dataclasses.replace(
            d, shape=tuple(parts[n][c].shape)) for n, d in defs.items()})
        ps[c].load_state_dict({n: parts[n][c] for n in defs})
    D.reset_collectives()
    with torch.no_grad():
        ys, auxs = TMOE.apply_moe_ep(NamedSharding(mesh, ("data",)).split(x),
                                     ps, mesh, dp_axes="data", **kw)
    assert D.collective_counts() == {"psum": {"model": 1},
                                     "pmean": {"data": 1},
                                     "all_gather": {"data": 3}}
    rp = {n: jnp.asarray(t.detach().numpy()) for n, t in full.items()}
    ref_moe = _ref_moe(**kw)
    rows = 4 // shape[0]
    per_aux = []
    for d in range(shape[0]):
        want, a = ref_moe(jnp.asarray(x[d * rows:(d + 1) * rows].numpy()),
                          rp)
        per_aux.append(float(a))
        for m in range(shape[1]):
            np.testing.assert_allclose(ys[d, m].numpy(),
                                       np.asarray(want), atol=1e-5,
                                       rtol=1e-5)
    want, glob = ref_moe(jnp.asarray(x.numpy()), rp)
    for a in auxs.flat:
        assert abs(float(a) - np.mean(per_aux)) < 1e-5
        assert abs(float(a) - float(glob)) < 0.05 * float(glob)
    if cf == 64.0:
        got = torch.cat([ys[d, 0] for d in range(shape[0])])
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def test_apply_moe_ep_falls_back_to_the_dense_dispatch():
    """Without a model axis that splits the experts the answer is
    ``apply_moe``'s over all tokens (its capacity rounded as there),
    with drops: a (4, 1) mesh gathers the tokens over ``data``."""
    defs, e_pad = TMOE.moe_defs(64, 128, 8)
    p = init_params(ParamModule(defs), torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 16, 64), dtype=np.float32))
    kw = dict(n_experts=8, n_padded=e_pad, top_k=2, capacity_factor=1.0)
    want, aux = TMOE.apply_moe(x, p, **kw)
    mesh = _mesh((4, 1))
    full = dict(p.named_parameters())
    ps = np.empty(mesh.devices.shape, dtype=object)
    parts = {n: NamedSharding(mesh, tuple(a if a != "model" else None
                                          for a in d.pspec)).split(
        full[n].detach()) for n, d in defs.items()}
    for c in np.ndindex(*ps.shape):
        ps[c] = ParamModule({n: dataclasses.replace(
            d, shape=tuple(parts[n][c].shape)) for n, d in defs.items()})
        ps[c].load_state_dict({n: parts[n][c] for n in defs})
    with torch.no_grad():
        ys, auxs = TMOE.apply_moe_ep(NamedSharding(mesh, ("data",)).split(x),
                                     ps, mesh, dp_axes="data", **kw)
    got = torch.cat([ys[d, 0] for d in range(4)])
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                               atol=1e-6, rtol=1e-6)
    assert all(abs(float(a) - float(aux.detach())) < 1e-6 for a in auxs.flat)


# ----------------------------------------------------------- elastic ----
def test_elastic_restart_onto_a_data_mesh(tmp_path, capsys):
    """The reference's ``test_elastic_restart_new_mesh``, in process:
    mamba2 (reduced) trains six steps on one device, then resumes from
    its checkpoint on a (2, 1) mesh to step nine; the tail equals the
    straight run's within the reference's resume tolerance, 2e-3."""
    kw = dict(batch=4, seq=32, ckpt_every=3, lr=1e-2, seed=1, device="cpu",
              log_every=100, schedule_steps=9)
    _, _, straight = tlaunch.train("mamba2-130m", steps=9, **kw)
    d = str(tmp_path)
    tlaunch.train("mamba2-130m", steps=6, ckpt_dir=d, **kw)
    _, state, tail = tlaunch.train("mamba2-130m", steps=9, ckpt_dir=d,
                                   n_data=2, n_model=1, **kw)
    out = capsys.readouterr().out
    assert "resumed step 6" in out and "on a (2, 1) mesh of cpux2" in out
    np.testing.assert_allclose(tail, straight[6:], rtol=2e-3, atol=2e-3)
    assert int(state["count"]) == 9
    assert isinstance(state["m"]["blocks.0.ssm.wz"], type(
        state["v"]["blocks.0.ssm.wz"]))


# -------------------------------------------------------------- specs ----
def _ref_flat(tree, prefix=""):
    if is_def(tree):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in tree.items():
        out.update(_ref_flat(v, f"{prefix}{k}."))
    return out


def _stacked(defs):
    """The port's per-layer ``blocks`` stacked as the reference stacks
    them, so the two trees line up leaf for leaf."""
    if not isinstance(defs.get("blocks"), list):
        return defs
    return dict(defs, blocks=map_stacked(defs["blocks"][0],
                                         len(defs["blocks"])))


def _same_defs(port_defs, ref_defs, what):
    got = flat_defs(_stacked(port_defs))
    want = _ref_flat(ref_defs)
    assert sorted(got) == sorted(k for k in want), what
    for k, d in got.items():
        r = want[k]
        assert tuple(d.shape) == tuple(r.shape), (what, k)
        assert tuple(d.pspec) == tuple(r.pspec), (what, k, d.pspec, r.pspec)


class _FakeMesh:
    """What ``with_mesh`` reads of a mesh, for both packages."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape, dtype=object)


MESH_CASES = [((16, 16), ("data", "model")),
              ((2, 16, 16), ("pod", "data", "model")),
              ((2, 2), ("data", "model")), ((4, 1), ("data", "model"))]


@pytest.mark.parametrize("name", ARCHS)
def test_specs_match_reference(name):
    """``with_mesh`` (tp and fsdp), ``input_specs``/``input_pspecs`` of
    every shape cell, the parameter specs (``fsdp_transform`` under
    fsdp), the decode caches' specs and ``opt_state_defs``'s ZeRO specs
    equal the reference's for ``name`` on each mesh shape."""
    for sharding in ("tp", "fsdp"):
        for shape, axes in MESH_CASES:
            fm = _FakeMesh(shape, axes)
            r = dataclasses.replace(RC.get_config(name), sharding=sharding
                                    ).with_mesh(fm)
            t = dataclasses.replace(TC.get_config(name), sharding=sharding
                                    ).with_mesh(fm)
            what = (sharding, shape)
            for f in ("dp_axes", "mesh_dp", "mesh_model", "microbatches"):
                assert getattr(t, f) == getattr(r, f), (what, f)
            for cell in RC.SHAPES:
                rs, ts = r.input_specs(cell), t.input_specs(cell)
                assert sorted(rs) == sorted(ts)
                for k, (shp, dt) in ts.items():
                    assert tuple(rs[k].shape) == shp, (what, cell, k)
                    assert jnp.dtype(rs[k].dtype).name == \
                        str(dt).removeprefix("torch."), (what, cell, k)
                assert t.input_pspecs(cell) == {
                    k: tuple(v) for k, v in r.input_pspecs(cell).items()}
            if sharding == "fsdp":
                # the reference re-specs its stacked tree, whose layer dim
                # can be the largest: compare over the same stacking
                total = max(1, t.mesh_dp) * max(1, t.mesh_model)
                tp = dataclasses.replace(t, sharding="tp")
                _same_defs(fsdp_transform(_stacked(TT.param_defs(tp)),
                                          t.dp_axes, total),
                           RT.param_defs(r), what)
                continue
            _same_defs(TT.param_defs(t), RT.param_defs(r), what)
            if t.family != "encoder":
                for batch in (1, 128):
                    tc = TT.cache_defs(t, batch, 64)
                    rc = RT.cache_defs(r, batch, 64)
                    for k, layers in tc.items():
                        _same_defs({"blocks": layers}, {"blocks": rc[k]},
                                   (what, "cache", k))
            # over the stacked tree, as the reference holds it
            got = topt.opt_state_defs(_stacked(TT.param_defs(t)), t.mesh_dp)
            want = ropt.opt_state_defs(RT.param_defs(r), r.mesh_dp)
            for k in ("m", "v"):
                _same_defs(got[k], want[k], (what, "zero", k))
            assert got["count"].pspec == tuple(want["count"].pspec)


def test_production_mesh_and_spec_helpers(monkeypatch):
    """``make_production_mesh``'s shapes and axes are the reference's
    (its device check stubbed out: this host has one jax device), the
    stacked specs prepend ``None``, ``zero_pspec`` keeps a spec that
    names ``data``, and a NamedSharding round-trips a tensor."""
    monkeypatch.setattr(RM, "_mk", lambda shape, axes: (shape, axes))
    for multi in (False, True):
        shape, axes = RM.make_production_mesh(multi_pod=multi)
        m = tmesh.make_production_mesh(multi_pod=multi,
                                       devices=["cpu"] * math.prod(shape))
        assert m.devices.shape == shape and m.axis_names == axes
    with pytest.raises(RuntimeError, match="devices="):
        if not torch.cuda.is_available():
            tmesh.make_production_mesh()
    r = rmap_stacked(RT.attn_defs(RC.get_config("qwen3-14b")), 3)
    t = map_stacked(TT.attn_defs(TC.get_config("qwen3-14b")), 3)
    assert {k: tuple(v.pspec) for k, v in r.items()} == \
        {k: v.pspec for k, v in t.items()}
    d = TMOE.moe_defs(64, 128, 8)[0]["w_up"]
    assert topt.zero_pspec(d, data_size=2) == ("model", "data", None)
    mesh = _mesh((2, 2))
    shardings = tree_shardings(TT.attn_defs(TC.get_config("qwen3-14b")),
                               mesh)
    assert {k: v.spec for k, v in shardings.items()} == \
        {k: v.pspec for k, v in TT.attn_defs(TC.get_config("qwen3-14b"))
         .items()}
    x = torch.arange(48.0).reshape(4, 12)
    for spec in [(None, "model"), ("data", "model"), (("data", "model"),),
                 ("model",), ()]:
        sh = NamedSharding(mesh, spec)
        assert torch.equal(sh.gather(sh.split(x), x.shape, "cpu"), x)


def test_fsdp_refused_naming_item_16b(monkeypatch):
    """``sharding="fsdp"`` is no longer refused: the mesh executor and
    both launchers run it (serving held to the unsharded tokens, a train
    step's loss finite).  The fsdp config is registered for this test
    only, so the registry other test files read is left as it was."""
    from repro_torch.configs import base as TCB

    base = TC.get_config("h2o-danube-1.8b")
    monkeypatch.setitem(TCB._REGISTRY, "h2o-fsdp", dataclasses.replace(
        base, name="h2o-fsdp", sharding="fsdp"))
    got = tserve.run("h2o-fsdp", device="cpu", n_data=2, n_model=2,
                     repeats=1)
    want = tserve.run("h2o-danube-1.8b", device="cpu", repeats=1)
    assert torch.equal(got.tokens, want.tokens)
    assert set(got.collectives_per_prefill) == {"all_gather"}
    _, _, losses = tlaunch.train("h2o-fsdp", device="cpu", n_data=2,
                                 n_model=2, steps=1, batch=4, seq=32)
    assert all(math.isfinite(float(v)) for v in losses)


# ================================================================ fsdp ====
FSDP = ["h2o-danube-1.8b", "granite-moe-3b-a800m"]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", FSDP)
def test_fsdp_serving_matches_unsharded(name, shape):
    """``sharding="fsdp"``: prefill logits, decode logits and greedy
    tokens on a mesh equal the unsharded path's (each split leaf
    gathered over every axis where a layer reads it: one ``all_gather``
    over ``data+model`` a split leaf a use, no other collective on a
    mesh whose DP axes are both)."""
    cfg, model, (want, want_steps, want_toks) = _unsharded(name)
    mesh = _mesh(shape)
    mcfg = dataclasses.replace(cfg, sharding="fsdp").with_mesh(mesh)
    mm = TP.MeshModel(mcfg, mesh, model)
    D.reset_collectives()
    got, steps, toks = _serve(mcfg, mm, _prompt(cfg))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32, rtol=F32)
    for g, w in zip(steps, want_steps):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=F32, rtol=F32)
    assert torch.equal(toks, want_toks)
    counts = D.collective_counts()
    assert set(counts["all_gather"]) >= {"data+model"}
    split = [n for n, d in mm.flat.items()
             if mm.shardings[n].dims(d.shape)]
    assert split and all(mm.shardings[n].dims(mm.flat[n].shape)
                         == {k: ("data", "model") for k in
                             mm.shardings[n].dims(mm.flat[n].shape)}
                         for n in split)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", FSDP)
def test_fsdp_train_steps_match_unsharded(name, shape, monkeypatch):
    """``sharding="fsdp"`` train steps (remat on): loss and every
    gradient leaf at init, then two AdamW steps with the moments on the
    parameters' shards, against the unsharded step at the tp test's
    limits (the MoE's experts are gathered whole: the dense dispatch)."""
    cfg = _cfg(name, remat=True, moe_aux_weight=0.01)
    _train_matches_unsharded(cfg, dataclasses.replace(cfg, sharding="fsdp"),
                             shape, False, monkeypatch)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ARCHS)
def test_fsdp_mesh_specs_match_reference(name, shape):
    """The executor's FSDP placement is the reference's
    ``fsdp_transform``: each leaf of ``mesh_defs`` carries the spec the
    reference gives it on the same mesh, its stacked layer dim dropped.
    The one deviation: where the reference splits that layer dim (a
    per-layer leaf no larger than the layer count, zamba2's ``A_log``,
    ``D``, ``dt_bias`` at 4 layers and 4 heads on 4 devices), the port,
    whose layers are separate leaves, applies ``fsdp_transform`` to the
    per-layer leaf."""
    mesh = _mesh(shape)
    fm = _FakeMesh(shape, ("data", "model"))
    t = dataclasses.replace(TC.get_config(name).reduced(), sharding="fsdp")
    r = dataclasses.replace(RC.get_config(name).reduced(), sharding="fsdp")
    tm = t.with_mesh(mesh)
    got = flat_defs(TP.mesh_defs(tm, mesh))
    want = _ref_flat(RT.param_defs(r.with_mesh(fm)))
    layer_dim = []
    for n, d in got.items():
        parts = n.split(".")
        if parts[0] == "blocks":
            ref = want[".".join(["blocks"] + parts[2:])]
            spec = tuple(ref.pspec[1:])
            if ref.pspec[0] is not None:
                layer_dim.append(parts[-1])
                spec = fsdp_transform(dataclasses.replace(d, pspec=()),
                                      tm.dp_axes, math.prod(shape)).pspec
        else:
            spec = tuple(want[n].pspec)
        spec = spec + (None,) * (len(d.shape) - len(spec))
        assert tuple(d.pspec) == tuple(
            None if e is None else tuple(e) if not isinstance(e, str)
            else e for e in spec), (n, d.pspec, spec)
    assert set(layer_dim) <= {"A_log", "D", "dt_bias"}, layer_dim


# ====================================================== boundary stubs ====
@functools.lru_cache(maxsize=None)
def _stub_reference(name, field):
    """The reference's reduced ``name`` with ``field="boundary_stub"``:
    weights, prefill logits and cache, one decode step's logits."""
    rcfg = dataclasses.replace(RC.get_config(name).reduced(),
                               **dict(FR.KW, **{field: "boundary_stub"}))

    def run(key, prompt):
        params = FR._params(rcfg, key)
        logits, cache = RT.prefill(rcfg, params, prompt, FR.CACHE_LEN)
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        step, _ = RT.decode_step(rcfg, params, cache, tok[:, None],
                                 jnp.int32(FR.SEQ))
        return dict(params=params, logits=logits, cache=cache, step=step)

    prompt = FR.prompt_for(rcfg)
    out = jax.jit(run)(jax.random.PRNGKey(3),
                       {k: jnp.asarray(v) for k, v in prompt.items()})
    return dict(FR.np_tree(out), prompt=prompt,
                params=jax.tree.map(np.asarray, out["params"]))


STUBS = [("h2o-danube-1.8b", "attention_impl"),
         ("mamba2-130m", "ssm_impl"), ("zamba2-2.7b", "ssm_impl")]


@pytest.mark.parametrize("shape", [None, (2, 2)],
                         ids=["unsharded", "2x2"])
@pytest.mark.parametrize("name,field", STUBS)
def test_boundary_stubs_match_reference(name, field, shape):
    """``attention_impl="boundary_stub"`` (q · mean_s(k) + mean_s(v), no
    S × S work) and ``ssm_impl="boundary_stub"`` (no scan; a zero state,
    the real conv tail) against the reference's same stub, its weights
    carried across: prefill logits, the SSM caches, one decode step,
    unsharded and on a (2, 2) mesh (split heads take the sequence mean
    of their own heads; the gated norm keeps its ``psum``)."""
    ref = _stub_reference(name, field)
    cfg = dataclasses.replace(TC.get_config(name).reduced(),
                              **dict(FR.KW, **{field: "boundary_stub"}))
    model = TT.build_model(cfg, "cpu")
    model.load_state_dict(params_from_jax(ref["params"]))
    params = model
    if shape is not None:
        mesh = _mesh(shape)
        cfg = cfg.with_mesh(mesh)
        params = TP.MeshModel(cfg, mesh, model)
    logits, cache = TT.prefill(cfg, params, FR.to_torch(ref["prompt"]),
                               FR.CACHE_LEN)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=F32,
                               rtol=F32)
    if field == "ssm_impl":
        # the first position's caches: its rows and its heads' columns
        first = cache if shape is None else cache.flat[0]
        for i, c in enumerate(first["ssm"]):
            assert not torch.any(c["state"])
            rows, cols = c["conv"].shape[0], c["conv"].shape[2]
            np.testing.assert_allclose(
                c["conv"].numpy(),
                ref["cache"]["ssm"]["conv"][i][:rows, :, :cols], atol=F32,
                rtol=F32)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    step, _ = TT.decode_step(cfg, params, cache, tok[:, None], FR.SEQ)
    np.testing.assert_allclose(step.numpy(), ref["step"], atol=F32,
                               rtol=F32)

"""The port's tuning (``repro_torch.tuning``) and the front door's
``plan=``, ``mode="scratch"`` and ``mode="tuned"`` against the reference.

The load-bearing promises, as in ``tests/test_tuning.py``:

  * the plan DB's key, digest and checksum are the reference's for the
    same inputs (the port's records live in their own directory);
  * a crash at any point of a ``PlanDB.put`` never corrupts what ``get``
    offers (one SIGKILLed child process); corrupt and stale records are a
    warned miss, never an exception;
  * ``compile_stencil(..., mode="tuned")`` on a warm DB makes ZERO timing
    calls (``search.TIMING``), and falls back to the analytic plan on a
    miss;
  * an explicit plan is honored or refused, never ignored: a pinned 3-D
    tile reaches ``resolve_geometry``, and one the kernel cannot take
    raises, naming the bound;
  * the launch-geometry traffic model equals the geometry's own counts.

Every program is compiled with ``device="cpu"`` (the plain version, tier
``interpret``).
"""
from __future__ import annotations

import dataclasses
import math
import os
import signal
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stencil_spec as ref_spec
from repro.kernels import ref as jref
from repro.tuning import plandb as RP
from repro_torch.api import compile_stencil, plan_bucketed, resolve_geometry
from repro_torch.core import planner as tplanner
from repro_torch.core import roofline as trl
from repro_torch.core import stencil_spec as tspec
from repro_torch.kernels import ref as tref
from repro_torch.tuning import analytic as A
from repro_torch.tuning import plandb as P
from repro_torch.tuning import search as S

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = tspec.get("j2d5pt")
SHAPE = (64, 64)
SHAPE_3D = (16, 12, 20)


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: torch's default intra-op threads only oversubscribe
    the CPU the other test workers share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _key(hw="cpu:test", tier="interpret", shape=SHAPE, spec=SPEC):
    return P.db_key(spec, shape, hw, tier)


def _record(key):
    plan = plan_bucketed(SPEC, SHAPE, trl.H100)
    return P.make_record(key, plan, "fused", {"best_us": 1.0})


def field(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


# ---------------------------------------------- the reference's key ----
@pytest.mark.parametrize("name,shape", [("j2d5pt", (63, 57)),
                                        ("j2d25pt", (500, 500)),
                                        ("j3d27pt", (16, 12, 20)),
                                        ("poisson", (64, 65, 130))])
@pytest.mark.parametrize("hw,tier", [("cuda:NVIDIA_H100_80GB_HBM3", "native"),
                                     ("cpu:x86_64", "interpret")])
def test_key_digest_checksum_equal_the_reference(name, shape, hw, tier):
    tkey = P.db_key(tspec.get(name), shape, hw, tier)
    assert tkey == RP.db_key(ref_spec.get(name), shape, hw, tier)
    assert P.key_digest(tkey) == RP.key_digest(tkey)
    rec = P.make_record(tkey, plan_bucketed(tspec.get(name), shape),
                        "fused", {"best_us": 12.5, "rounds": 2})
    assert P.record_checksum(rec) == RP.record_checksum(rec)
    assert set(rec) == {"key", "torch_version", "plan", "measured",
                        "created"}
    assert set(rec["plan"]) == {"t", "block", "lazy_batch", "num_buffers",
                                "exec_mode"}
    assert rec["plan"]["lazy_batch"] == rec["plan"]["num_buffers"] == 1


def test_fingerprint_tier_and_default_path(monkeypatch, tmp_path):
    fp = P.hw_fingerprint("cpu")
    assert fp.startswith("cpu:") and " " not in fp
    assert P.tier_for("cpu") == "interpret"
    assert P.tier_for("cuda:0") == "native"
    monkeypatch.setenv("REPRO_TORCH_PLANDB", str(tmp_path))
    assert P.default_db_path() == str(tmp_path)
    assert P.resolve_db(None).root == str(tmp_path)
    monkeypatch.delenv("REPRO_TORCH_PLANDB")
    assert P.default_db_path().endswith(
        os.path.join(".cache", "repro_torch", "plandb"))
    assert P.default_db_path() != RP.default_db_path() or \
        os.environ.get("REPRO_PLANDB")


# ------------------------------------------------------------ atomicity ----
CHILD = textwrap.dedent("""
    import os, signal, sys
    from repro_torch.core.stencil_spec import get
    from repro_torch.core import roofline as rl
    from repro_torch.api.program import plan_bucketed
    from repro_torch.tuning import plandb as P

    root = sys.argv[1]
    spec = get("j2d5pt")
    key = P.db_key(spec, (64, 64), "cpu:test", "interpret")
    plan = plan_bucketed(spec, (64, 64), rl.H100)
    db = P.PlanDB(root)
    db.put(key, P.make_record(key, plan, "fused", {"best_us": 111.0}))
    db.put(key, P.make_record(key, plan, "scratch", {"best_us": 222.0}),
           sabotage="crash")
    print("KILLING", flush=True)
    os.kill(os.getpid(), signal.SIGKILL)
""")


def test_sigkill_mid_put_leaves_visible_record_intact(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr[-2000:])
    assert "KILLING" in r.stdout
    db = P.PlanDB(str(tmp_path))
    key = _key()
    rec = db.get(key)
    assert rec is not None
    assert rec["measured"]["best_us"] == 111.0
    assert rec["plan"]["exec_mode"] == "fused"
    assert [f for f in os.listdir(tmp_path) if ".json.tmp" in f]
    assert all(".tmp" not in p for p, _ in db.entries())
    db.prune_stale()
    assert not [f for f in os.listdir(tmp_path) if ".json.tmp" in f]
    assert db.get(key)["measured"]["best_us"] == 111.0


def test_tmp_orphan_in_process_is_never_read(tmp_path):
    db = P.PlanDB(str(tmp_path))
    key = _key()
    tmp = db.put(key, _record(key), sabotage="crash")
    assert tmp.endswith(f".tmp{os.getpid()}") and os.path.exists(tmp)
    assert db.get(key) is None and db.entries() == []
    assert db.prune_stale() == [tmp]


# ------------------------------------------------- corrupt / stale skip ----
def test_corrupt_record_is_warned_miss_not_fatal(tmp_path):
    db = P.PlanDB(str(tmp_path))
    key = _key()
    db.put(key, _record(key), sabotage="corrupt")
    with pytest.warns(UserWarning, match="corrupt"):
        assert db.get(key) is None
    db2 = P.PlanDB(str(tmp_path / "b"))
    path = db2.put(key, _record(key))
    with open(path, "w") as f:
        f.write('{"key": {"trunc')
    with pytest.warns(UserWarning, match="corrupt"):
        assert db2.get(key) is None
    assert db2.entries() == [(path, None)]
    # a record filed under another key's digest (hand-edited)
    db3 = P.PlanDB(str(tmp_path / "c"))
    other = _key(hw="cpu:other")
    path = db3.put(other, _record(other))
    os.rename(path, db3._path(key))
    with pytest.warns(UserWarning, match="does not match"):
        assert db3.get(key) is None


def test_stale_torch_version_is_warned_miss_and_prunable(tmp_path):
    db = P.PlanDB(str(tmp_path))
    key = _key()
    rec = _record(key)
    rec["torch_version"] = "0.0.1"
    db.put(key, rec)
    with pytest.warns(UserWarning, match="stale"):
        assert db.get(key) is None
    assert len(db.prune_stale()) == 1
    assert db.entries() == []


def test_key_hits_and_misses(tmp_path):
    db = P.PlanDB(str(tmp_path))
    key = _key()
    db.put(key, _record(key))
    assert db.get(key) is not None
    assert P.db_key(SPEC, (63, 57), "cpu:test", "interpret") == key
    assert db.get(_key(hw="cuda:NVIDIA_H100_80GB_HBM3")) is None
    assert db.get(_key(tier="native")) is None
    assert db.get(_key(shape=(256, 256))) is None
    assert db.get(_key(spec=tspec.get("j2d9pt"))) is None
    with pytest.raises(ValueError, match="tier"):
        P.db_key(SPEC, SHAPE, "cpu:test", "tuned")


# ------------------------------------------- tuned mode through the API ----
@pytest.fixture(scope="module")
def warm_db(tmp_path_factory):
    """One tiny-budget search a family, shared by the tuned-mode tests."""
    root = str(tmp_path_factory.mktemp("plandb"))
    db = P.PlanDB(root)
    res = {}
    for spec, shape in ((SPEC, SHAPE), (tspec.get("j3d7pt"), SHAPE_3D)):
        before = S.TIMING["calls"]
        res[spec.name] = S.tune(spec, shape, db=db, budget=12,
                                max_candidates=4, total_t=4, device="cpu")
        assert S.TIMING["calls"] - before == res[spec.name].timing_calls > 0
    return db, res


@pytest.mark.parametrize("name,shape", [("j2d5pt", SHAPE),
                                        ("j3d7pt", SHAPE_3D)])
def test_tuned_compile_warm_db_zero_timing(warm_db, name, shape):
    db, res = warm_db
    rec = res[name].record
    before = S.TIMING["calls"]
    prog = compile_stencil(tspec.get(name), shape, mode="tuned", plan_db=db,
                           device="cpu")
    assert S.TIMING["calls"] == before, \
        "warm-DB tuned compile must perform zero timing calls"
    assert prog.tuned["source"] == "plandb"
    assert {k: v for k, v in prog.tuned["record"].items()
            if k != "checksum"} == rec
    assert prog.t == rec["plan"]["t"]
    assert prog.mode == rec["plan"]["exec_mode"] == "fused"
    assert tuple(prog.plan.block) == tuple(rec["plan"]["block"])
    assert tuple(prog.geometry()["block"][:1]) == (rec["plan"]["block"][0],)
    x = field(shape)
    got = prog.apply(torch.from_numpy(x))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.reference(
            jnp.asarray(x), ref_spec.get(name), prog.t)), atol=2e-5,
        rtol=0)
    assert S.TIMING["calls"] == before
    # the tuned source is part of the program key
    assert prog is not compile_stencil(tspec.get(name), shape, t=prog.t,
                                       plan=prog.plan, device="cpu")


def test_tuned_compile_cold_db_falls_back_analytic(tmp_path):
    before = S.TIMING["calls"]
    prog = compile_stencil(SPEC, (192, 192), mode="tuned",
                           plan_db=str(tmp_path), device="cpu")
    assert S.TIMING["calls"] == before
    assert prog.tuned == {"source": "analytic_fallback"}
    assert prog.mode == "fused" and not prog.pinned
    auto = compile_stencil(SPEC, (192, 192), device="cpu")
    assert prog.t == auto.t and prog.geometry() == auto.geometry()
    assert prog is not auto


def test_tuned_mode_refusals(tmp_path):
    with pytest.raises(ValueError, match="drop t="):
        compile_stencil(SPEC, SHAPE, mode="tuned", t=4,
                        plan_db=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="drop plan="):
        compile_stencil(SPEC, SHAPE, mode="tuned",
                        plan=plan_bucketed(SPEC, SHAPE),
                        plan_db=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="single-device"):
        compile_stencil(SPEC, SHAPE, mode="tuned", mesh=1,
                        plan_db=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="drop plan="):
        compile_stencil(SPEC, SHAPE, mode="tuned", plan=None,
                        plan_db=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="EbisuPlan, None or 'auto'"):
        compile_stencil(SPEC, SHAPE, plan="fast", device="cpu")


# ------------------------------------------------------------ the search ----
@pytest.mark.parametrize("name,shape", [("j2d5pt", (128, 160)),
                                        ("j3d7pt", (64, 48, 96))])
def test_neighborhood_seeds_plan_first_and_is_deterministic(name, shape):
    spec = tspec.get(name)
    plan = S.seed_plan(spec, shape, trl.H100)
    cands = S.neighborhood(spec, shape, plan, max_candidates=8)
    assert cands == S.neighborhood(spec, shape, plan, max_candidates=8)
    seed = cands[0]
    assert (seed.t, tuple(seed.block), seed.exec_mode, seed.lazy_batch) == \
        (plan.t, tuple(plan.block), "fused", 1)
    assert 1 < len(cands) <= 8 and len(set(cands)) == len(cands)
    assert all(c.exec_mode == "fused" and c.lazy_batch == 1 for c in cands)
    assert all(tuple(c.block[1:]) == tuple(plan.block[1:]) for c in cands)
    ts = {max(1, plan.t // 2), plan.t, 2 * plan.t}
    leads = {max(1, plan.block[0] // 2), plan.block[0], 2 * plan.block[0]}
    assert all(c.t in ts and c.block[0] in leads for c in cands)
    dist = [(abs(math.log2(c.t / plan.t)),
             abs(math.log2(c.block[0] / plan.block[0]))) for c in cands[1:]]
    assert dist == sorted(dist)            # nearest to the seed first
    if spec.ndim == 3:                     # the seed is the launched tile
        assert tuple(plan.block) == compile_stencil(
            spec, shape, device="cpu").geometry()["block"]


@pytest.mark.parametrize("name,shape,bound", [
    ("j2d5pt", (96, 96), "shared-memory limit"),
    ("j3d7pt", (64, 48, 96), "kernel_threads_3d")])
def test_tune_prunes_what_the_kernel_cannot_take(name, shape, bound):
    """The doubled depth's tile is one the kernel cannot take: the search
    drops it as ``compile: ...`` before any timing."""
    res = S.tune(tspec.get(name), shape, budget=8, max_candidates=9,
                 total_t=4, device="cpu")
    reasons = [why for _, why in res.pruned]
    assert any(why.startswith("compile: ") and bound in why
               for why in reasons), reasons
    assert res.winner not in {c for c, _ in res.pruned}
    assert res.seed == res.candidates[0]
    assert len(res.rounds) >= 1


@pytest.mark.parametrize("name", ["j2d5pt", "j3d7pt"])
def test_plan_from_record_roundtrip(warm_db, name):
    _, res = warm_db
    r = res[name]
    shape = SHAPE if name == "j2d5pt" else SHAPE_3D
    plan = P.plan_from_record(tspec.get(name), shape, trl.H100, r.record)
    assert plan == r.plan
    assert plan.halo == tspec.get(name).halo(plan.t)
    spec = tspec.get(name)
    if spec.ndim == 2:
        assert plan.smem_bytes == tplanner.smem_bytes_2d(
            spec, plan.t, *plan.block, 4)
    else:
        _, ty, tx = plan.block
        assert plan.smem_bytes == tplanner.smem_bytes_3d(
            spec, plan.t, shape, ty, tx, 4)
        assert plan.threads == -(-sum(tplanner.kernel_threads_3d(
            spec, plan.t, shape, ty, tx, 4)[0]) // 32) * 32


# ----------------------------------------------------------------- CLI ----
def test_cli_sweep_check_showdb_prune(tmp_path, capsys):
    from repro_torch.tuning.cli import main

    db = str(tmp_path / "db")
    args = ["--device", "cpu", "--stencil", "j2d5pt", "--scale", "64",
            "--db", db]
    assert main(["check", *args]) == 1          # cold DB -> miss
    assert main(["sweep", *args, "--budget", "6", "--candidates", "3",
                 "--t-total", "4", "--json", str(tmp_path / "w.json")]) == 0
    capsys.readouterr()
    assert main(["check", *args]) == 0          # warm -> hit
    out = capsys.readouterr().out
    assert "HIT" in out and "timing_calls=" in out
    assert main(["show-db", "--db", db]) == 0
    assert "1 record(s)" in capsys.readouterr().out
    assert main(["prune-stale", "--db", db]) == 0
    assert "pruned 0" in capsys.readouterr().out
    assert main(["check", *args]) == 0          # the live record survives
    assert (tmp_path / "w.json").exists()


# ------------------------------------------------------- traffic model ----
@pytest.mark.parametrize("name,shape,t,total_t", [
    ("j2d5pt", (100, 130), 3, 7), ("j2d25pt", (64, 90), 2, 4),
    ("j3d7pt", (20, 24, 40), 2, 5), ("j3d27pt", (18, 10, 33), 3, 3)])
def test_traffic_model_equals_the_geometry_counts(name, shape, t, total_t):
    spec = tspec.get(name)
    prog = compile_stencil(spec, shape, t=t, device="cpu")
    cost = A.analytic_cost(prog, total_t)
    want_bytes = want_flops = 0
    sweeps = [t] * (total_t // t) + ([total_t % t] if total_t % t else [])
    for d in sweeps:
        g = resolve_geometry(spec, d, shape, plan=prog.tile_plan)
        ctas = math.prod(g["grid"])
        want_bytes += ctas * (g["fetched_cells"] + g["body_cells"]) * 4
        want_flops += g["cell_updates"] * spec.flops_per_cell
    assert cost.bytes_accessed == want_bytes
    assert cost.flops == want_flops and cost.sweeps == len(sweeps)
    assert A.analytic_bytes_per_step(prog, total_t) == want_bytes / total_t
    assert A.analytic_cost(prog, total_t) is cost      # memoized
    if spec.ndim == 2:      # the 2-D count is the tile schedule's
        from repro_torch.kernels.stencil2d import tile_schedule
        g = prog.geometry()
        assert g["cell_updates"] == tile_schedule(
            spec, t, *g["block"], *shape)["cell_updates"]


# --------------------------------------------------- pinned tiles, modes ----
def test_pinned_3d_tile_reaches_resolve_geometry():
    spec = tspec.get("j3d7pt")
    shape = (20, 24, 40)
    auto = compile_stencil(spec, shape, t=2, device="cpu")
    block = (3, 8, 32)
    assert auto.geometry()["block"] != block
    plan = S.pin(spec, shape, trl.H100, 2, block)
    prog = compile_stencil(spec, shape, t=2, plan=plan, device="cpu")
    assert prog.pinned and prog.geometry()["block"] == block
    assert resolve_geometry(spec, 2, shape, plan=plan)["block"] == block
    x = field(shape, seed=3)
    want = tref.reference(torch.from_numpy(x), spec, 5)
    torch.testing.assert_close(prog.run(torch.from_numpy(x), 5), want,
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(
        prog.run(torch.from_numpy(x), 5).numpy(),
        np.asarray(jref.reference(jnp.asarray(x), ref_spec.get("j3d7pt"),
                                  5)), atol=2e-5, rtol=0)


@pytest.mark.parametrize("t,block,match", [
    (2, (4, 128, 160), "kernel_threads_3d"),
    (33, (4, 8, 32), "MAX_DEPTH_3D"),
    (1, (4, 120, 128), "shared-memory limit"),
])
def test_pinned_3d_tile_the_kernel_cannot_take_raises(t, block, match):
    spec = tspec.get("j3d7pt")
    shape = (64, 256, 256)
    plan = dataclasses.replace(plan_bucketed(spec, shape), t=t,
                               block=block)
    with pytest.raises(ValueError, match=match):
        compile_stencil(spec, shape, t=t, plan=plan, device="cpu")


def test_pinned_2d_tile_is_honored_or_refused():
    spec = tspec.get("j2d9pt")
    shape = (70, 90)
    plan = S.pin(spec, shape, trl.H100, 3, (16, 64))
    prog = compile_stencil(spec, shape, t=3, plan=plan, device="cpu")
    assert prog.geometry()["block"] == (16, 64)
    x = torch.from_numpy(field(shape, seed=1))
    torch.testing.assert_close(prog.run(x, 7),
                               tref.reference(x, spec, 7), atol=2e-5, rtol=0)
    big = S.pin(spec, shape, trl.H100, 3, (512, 512))
    with pytest.raises(ValueError, match="shared-memory limit"):
        compile_stencil(spec, shape, t=3, plan=big, device="cpu")
    lifted_2d_tile = S.pin(spec, shape, trl.H100, 3, (16, 64))
    with pytest.raises(ValueError, match=r"\(zc, ty, tx\)"):
        compile_stencil(spec, shape, t=3, plan=lifted_2d_tile,
                        mode="stream", device="cpu")


@pytest.mark.parametrize("name,shape", [("j2d5pt", (37, 53)),
                                        ("j3d7pt", (9, 12, 20))])
def test_scratch_equals_fused(name, shape):
    """``mode="scratch"`` runs the fused tile kernel (3-D ignores it)."""
    spec = tspec.get(name)
    fused = compile_stencil(spec, shape, t=2, device="cpu")
    scratch = compile_stencil(spec, shape, t=2, mode="scratch",
                              device="cpu")
    assert scratch.mode == "scratch" and scratch is not fused
    assert scratch.geometry() == fused.geometry()
    x = torch.from_numpy(field(shape, seed=2))
    assert torch.equal(scratch.run(x, 5), fused.run(x, 5))
    assert torch.equal(scratch.apply(x), fused.apply(x))
    if spec.ndim == 2:
        xp = torch.zeros(scratch.padded_shape)
        xp[:shape[0], :shape[1]] = x
        out = scratch.run_padded(xp.clone(), 4)
        assert torch.equal(out[:shape[0], :shape[1]], fused.run(x, 4))

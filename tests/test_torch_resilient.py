"""The port's resumable campaigns (``repro_torch.resilient``,
``StencilProgram.run_resumable`` / ``run_sharded_resumable``, the CLI's
``--checkpoint-dir``) against their contract and the reference.

The load-bearing property, as in the reference's ``tests/test_resilient.py``
(whose in-process cases are ported here): a campaign that crashes and
resumes — at any leg boundary, with any of the injected faults along the
way — produces a final field **bit-exact** equal to the port's own
uninterrupted ``StencilProgram.run(x, T)``.  Every injected fault
resolves to a recovery or a typed ``CampaignFault``, deterministically
under a seeded injector and a simulated clock.  Programs are compiled
with ``device="cpu"`` (the kernels' plain versions); sharded campaigns
run on meshes of CPU shards, the cases of the reference's
``multidev_resilient_child.py``.

Against the reference: the port's campaigns equal the reference's own
``run_campaign`` within 2e-5 (f32); the schedule, health envelope and
retry policy are the reference's, compared directly.  A bf16 campaign is
held within the reference suite's 0.06 of ``.run``, because the
reference's own bf16 campaign is not bit-exact with its ``.run`` either
(a bf16 carry rounds at every leg).
"""
from __future__ import annotations

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.api import Boundary, compile_stencil
from repro_torch.core.stencil_spec import get
from repro_torch.faults import FaultConfig, FaultInjector, SimClock
from repro_torch.resilient import (CampaignFault, CampaignStore,
                                   HealthEnvelope, HealthViolation,
                                   ResumeMismatch, RetryPolicy,
                                   leg_schedule, resume_campaign,
                                   run_campaign)
from repro_torch.resilient.health import probe
from repro_torch.resilient.store import (MANIFEST, PAYLOAD, CheckpointError,
                                         CorruptCheckpoint,
                                         _flip_payload_bytes)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = [("j2d5pt", (12, 14)), ("j3d7pt", (6, 8, 5))]
BOUNDARIES = [Boundary.dirichlet(0.0), Boundary.periodic()]
T_TOTAL = 11      # with t=2: legs of 2 steps + a remainder leg of 1


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: torch's default intra-op threads only oversubscribe
    the CPU the other test workers share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def field(shape, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).random(shape, dtype=np.float32))


def _setup(name, shape, boundary, dtype=torch.float32):
    prog = compile_stencil(get(name), shape, t=2, boundary=boundary,
                           dtype=dtype, device="cpu")
    x = field(shape).to(dtype)
    return prog, x, prog.run(x, T_TOTAL)


def _bitexact(a, b) -> bool:
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


class Crash(Exception):
    """Stands in for SIGKILL inside one test process."""


def _crash_after(leg_idx, store=None):
    def hook(leg, steps_done):
        if leg == leg_idx:
            if store is not None:
                store.wait()       # post-leg: the checkpoint landed
            raise Crash()
    return hook


# ------------------------------------------------ bit-exact resumption ----
@pytest.mark.parametrize("name,shape", CASES)
@pytest.mark.parametrize("boundary", BOUNDARIES,
                         ids=[b.kind for b in BOUNDARIES])
@pytest.mark.parametrize("interrupt", ["post_leg", "mid_save"])
def test_resumed_campaign_bitexact(tmp_path, name, shape, boundary,
                                   interrupt):
    """Crash after leg 2 — either after its checkpoint landed (post-leg)
    or with that save dying mid-``tmp`` (the leg is lost and replayed) —
    then resume: the final field equals the uninterrupted ``run``
    bitwise."""
    prog, x, ref = _setup(name, shape, boundary)
    store = CampaignStore(str(tmp_path))
    faults = None
    if interrupt == "mid_save":
        faults = FaultInjector(FaultConfig(crash_save_at_leg=(2,)))
    with pytest.raises(Crash):
        run_campaign(prog, x, T_TOTAL, store=store, faults=faults,
                     on_leg=_crash_after(2, store))
    rep = resume_campaign(prog, store)
    assert rep.resumed_from == (2 if interrupt == "post_leg" else 1)
    assert _bitexact(rep.result, ref)


@pytest.mark.parametrize("every", [1, 2, 5])
def test_fresh_campaign_matches_run(tmp_path, every):
    """No crash at all: the legged executor IS ``run``, for any leg
    width (including one wider than the whole campaign)."""
    prog, x, ref = _setup("j2d5pt", (12, 14), Boundary.periodic())
    rep = prog.run_resumable(x, T_TOTAL, store=str(tmp_path / str(every)),
                             every=every)
    assert _bitexact(rep.result, ref)
    assert rep.legs_run == rep.legs_total == len(
        leg_schedule(T_TOTAL, prog.t, every))


def test_run_resumable_zero_steps(tmp_path):
    prog, x, _ = _setup("j2d5pt", (12, 14), Boundary.dirichlet(0.0))
    rep = prog.run_resumable(x, 0, store=str(tmp_path))
    assert _bitexact(rep.result, x) and rep.legs_total == 0


def test_float64_campaign_bitexact(tmp_path):
    prog, x, ref = _setup("j3d7pt", (6, 8, 5), Boundary.periodic(),
                          dtype=torch.float64)
    store = CampaignStore(str(tmp_path))
    with pytest.raises(Crash):
        prog.run_resumable(x, T_TOTAL, store=store, every=2,
                           on_leg=_crash_after(1, store))
    rep = resume_campaign(prog, store, every=2)
    assert rep.result.dtype == torch.float64 and _bitexact(rep.result, ref)


def test_bf16_campaign_as_the_reference_shows(tmp_path):
    """A bf16 carry round-trips a checkpoint to the same bits, and the
    campaign is its legs' ``run`` chained; like the reference's, it is
    within 0.06 of the uninterrupted ``run``, not bit-exact with it."""
    prog, x, ref = _setup("j2d5pt", (12, 14), Boundary.dirichlet(0.0),
                          dtype=torch.bfloat16)
    store = CampaignStore(str(tmp_path))
    with pytest.raises(Crash):
        prog.run_resumable(x, T_TOTAL, store=store,
                           on_leg=_crash_after(2, store))
    rep = resume_campaign(prog, store)
    assert rep.result.dtype == torch.bfloat16
    legs = x
    for _, steps in leg_schedule(T_TOTAL, prog.t):
        legs = prog.run(legs, steps)
    assert _bitexact(rep.result, legs)
    torch.testing.assert_close(rep.result.float(), ref.float(), atol=0.06,
                               rtol=0.06)
    _, carry, manifest, _ = store.load_latest_good()
    assert manifest["carry_dtype"] == "bfloat16"
    assert carry.dtype == torch.bfloat16 and _bitexact(carry, legs)


def test_leg_schedule_alignment():
    from repro.resilient import leg_schedule as ref_leg_schedule

    assert leg_schedule(10, 4, 1) == [(1, 4), (2, 4), (3, 2)]
    assert leg_schedule(16, 4, 2) == [(1, 8), (2, 8)]
    assert leg_schedule(3, 8, 1) == [(1, 3)]
    assert leg_schedule(0, 4, 1) == []
    for args in ((10, 4, 1), (16, 4, 2), (25, 12, 1), (25, 12, 2),
                 (17, 8, 3), (0, 2, 1), (11, 2, 5)):
        assert leg_schedule(*args) == ref_leg_schedule(*args)
    with pytest.raises(ValueError):
        leg_schedule(4, 4, 0)


@pytest.mark.parametrize("name,shape,boundary,every", [
    ("j2d5pt", (12, 14), Boundary.periodic(), 2),
    ("j3d7pt", (6, 8, 5), Boundary.dirichlet(0.0), 1)],
    ids=["j2d5pt-periodic", "j3d7pt-dirichlet"])
def test_matches_reference_campaign(tmp_path, name, shape, boundary, every):
    """The port's campaign against the reference's own ``run_campaign``
    on the same field, within 2e-5, with the same leg accounting."""
    import jax.numpy as jnp

    from repro.api.boundary import Boundary as RefBoundary
    from repro.api.program import compile_stencil as ref_compile
    from repro.core.stencil_spec import get as ref_get
    from repro.resilient import run_campaign as ref_run_campaign

    prog, x, _ = _setup(name, shape, boundary)
    rep = prog.run_resumable(x, T_TOTAL, store=str(tmp_path / "p"),
                             every=every)
    rprog = ref_compile(ref_get(name), shape, t=2,
                        boundary=RefBoundary(boundary.kind, boundary.value))
    want = ref_run_campaign(rprog, jnp.asarray(x.numpy()), T_TOTAL,
                            store=str(tmp_path / "r"), every=every)
    np.testing.assert_allclose(rep.result.numpy(), np.asarray(want.result),
                               atol=2e-5, rtol=2e-5)
    assert (rep.legs_total, rep.legs_run, rep.checkpoints_written) == (
        want.legs_total, want.legs_run, want.checkpoints_written)
    assert rep.final_rms == pytest.approx(want.final_rms, rel=1e-5)


# ------------------------------------------------- fault -> recovery ----
def test_nan_leg_rolls_back_and_recovers(tmp_path):
    """A one-shot NaN blow-up at leg 3: health catches it in the probe,
    the runner rolls back one leg and the clean retry proceeds — still
    bit-exact."""
    prog, x, ref = _setup("j2d5pt", (12, 14), Boundary.dirichlet(0.0))
    clk = SimClock()
    inj = FaultInjector(FaultConfig(nan_at_leg=(3,)))
    rep = run_campaign(prog, x, T_TOTAL, store=str(tmp_path), faults=inj,
                       clock=clk)
    assert _bitexact(rep.result, ref)
    assert rep.rollbacks == 1 and rep.retries == 1
    assert rep.faults_injected["nan_leg"] == 1
    assert clk.now_ms() > 0          # backoff advanced the injected clock


def test_persistent_nan_exhausts_into_typed_fault(tmp_path):
    """NaN re-injected on every retry: the bounded ladder ends in
    ``CampaignFault('health')`` pinned to the leg — the no-hang case."""
    prog, x, _ = _setup("j2d5pt", (12, 14), Boundary.dirichlet(0.0))
    inj = FaultInjector(FaultConfig(nan_at_leg=(3,), nan_persistent=True))
    with pytest.raises(CampaignFault) as ei:
        run_campaign(prog, x, T_TOTAL, store=str(tmp_path), faults=inj,
                     clock=SimClock(), policy=RetryPolicy(max_retries=2))
    assert ei.value.reason == "health" and ei.value.leg == 3
    assert isinstance(ei.value.__cause__, HealthViolation)


def test_corrupt_checkpoint_skipped_at_rollback(tmp_path):
    """Leg 2's checkpoint is corrupted on disk; the NaN at leg 3 forces
    a rollback, which skips the bad checkpoint (checksum refusal), lands
    on leg 1, and replays — bit-exact."""
    prog, x, ref = _setup("j2d5pt", (12, 14), Boundary.dirichlet(0.0))
    inj = FaultInjector(FaultConfig(corrupt_ckpt_at_leg=(2,),
                                    nan_at_leg=(3,)))
    rep = run_campaign(prog, x, T_TOTAL, store=str(tmp_path), faults=inj,
                       clock=SimClock())
    assert _bitexact(rep.result, ref)
    assert [leg for leg, _ in rep.corrupt_skipped] == [2]


def test_all_checkpoints_corrupt_is_typed(tmp_path):
    """Every payload on disk flipped after the crash: resume refuses
    with ``CampaignFault('checkpoints_corrupt')``."""
    prog, x, _ = _setup("j2d5pt", (12, 14), Boundary.dirichlet(0.0))
    store = CampaignStore(str(tmp_path))
    with pytest.raises(Crash):
        run_campaign(prog, x, T_TOTAL, store=store,
                     on_leg=_crash_after(2, store))
    for leg in store.legs():
        _flip_payload_bytes(os.path.join(store.root, f"leg_{leg}", PAYLOAD))
    with pytest.raises(CampaignFault) as ei:
        resume_campaign(prog, store)
    assert ei.value.reason == "checkpoints_corrupt"


def test_resume_without_checkpoint_is_typed(tmp_path):
    prog, _, _ = _setup("j2d5pt", (12, 14), Boundary.dirichlet(0.0))
    with pytest.raises(CampaignFault) as ei:
        resume_campaign(prog, CampaignStore(str(tmp_path)))
    assert ei.value.reason == "no_checkpoint"


def test_resume_fingerprint_mismatch_refused(tmp_path):
    """A checkpoint written under one program refuses to resume under a
    drifted one — wrong depth, wrong boundary — and the error names each
    mismatched field with its fix."""
    prog, x, _ = _setup("j2d5pt", (12, 14), Boundary.dirichlet(0.0))
    store = CampaignStore(str(tmp_path))
    with pytest.raises(Crash):
        run_campaign(prog, x, T_TOTAL, store=store,
                     on_leg=_crash_after(2, store))
    drifted = compile_stencil(get("j2d5pt"), (12, 14), t=3,
                              boundary=Boundary.periodic(), device="cpu")
    with pytest.raises(ResumeMismatch) as ei:
        resume_campaign(drifted, store)
    msg = str(ei.value)
    assert "t:" in msg and "boundary:" in msg and "fix:" in msg


def test_permanent_error_is_not_retried(tmp_path):
    """A genuine bug in the loop surfaces as ``CampaignFault('internal')``
    on the first hit — no rollback/retry burn."""
    prog, x, _ = _setup("j2d5pt", (12, 14), Boundary.dirichlet(0.0))

    class Boom(HealthEnvelope):
        def judge(self, **kw):
            raise TypeError("boom")

    with pytest.raises(CampaignFault) as ei:
        run_campaign(prog, x, T_TOTAL, store=str(tmp_path), health=Boom(),
                     clock=SimClock())
    assert ei.value.reason == "internal" and "TypeError" in str(ei.value)


# ------------------------------------------------------ health envelope ----
def test_health_envelope_judgements_match_reference():
    from repro.resilient import HealthEnvelope as RefEnvelope
    from repro.resilient import HealthViolation as RefViolation

    cases = [dict(finite=True, rms=1.0, prev_rms=0.9, leg=1),
             dict(finite=False, rms=float("nan"), prev_rms=None, leg=2),
             dict(finite=True, rms=11.0, prev_rms=10.5, leg=3),
             dict(finite=True, rms=2.0, prev_rms=1.0, leg=4)]
    reasons = []
    for kw in cases:
        got = want = None
        try:
            HealthEnvelope(max_growth=1.5, max_rms=10.0).judge(**kw)
        except HealthViolation as e:
            got = (e.reason, str(e))
        try:
            RefEnvelope(max_growth=1.5, max_rms=10.0).judge(**kw)
        except RefViolation as e:
            want = (e.reason, str(e))
        assert got == want
        reasons.append(got and got[0])
    assert reasons == [None, "nonfinite", "rms_ceiling", "rms_drift"]


def test_probe_is_one_reduction():
    finite, rms = probe(torch.ones((4, 4)))
    assert finite and rms == pytest.approx(1.0)
    finite, _ = probe(torch.tensor([[1.0, float("inf")], [0.0, 2.0]]))
    assert not finite
    finite, rms = probe(torch.full((3, 3), 2.0, dtype=torch.bfloat16))
    assert finite and rms == pytest.approx(2.0)


def test_retry_policy_and_classify_match_reference():
    from repro import faults as ref_faults
    from repro.resilient import RetryPolicy as RefPolicy
    from repro.resilient import classify as ref_classify
    from repro.resilient.policy import REASONS as REF_REASONS
    from repro_torch import faults
    from repro_torch.resilient import classify
    from repro_torch.resilient.policy import REASONS

    assert REASONS == REF_REASONS
    a, b = random.Random(5), random.Random(5)
    for attempt in range(6):
        assert (RetryPolicy(seed=5).backoff_ms(attempt, a)
                == RefPolicy(seed=5).backoff_ms(attempt, b))
    assert classify(faults.TransientFault("oom")) == ref_classify(
        ref_faults.TransientFault("oom")) == "transient"
    assert classify(HealthViolation("nonfinite", 3, 0.0)) == "transient"
    assert classify(TypeError("boom")) == "permanent"


def test_rms_envelope_trips_campaign(tmp_path):
    """An absurdly tight rms ceiling turns a healthy run into a typed
    health fault — the drift guard is live end-to-end."""
    prog, x, _ = _setup("j2d5pt", (12, 14), Boundary.dirichlet(0.0))
    with pytest.raises(CampaignFault) as ei:
        run_campaign(prog, x, T_TOTAL, store=str(tmp_path),
                     health=HealthEnvelope(max_rms=1e-30),
                     clock=SimClock(), policy=RetryPolicy(max_retries=1))
    assert ei.value.reason == "health"


# ---------------------------------------------------------- store unit ----
def test_store_atomicity_and_prune(tmp_path):
    store = CampaignStore(str(tmp_path), keep=2)
    x = torch.arange(12.0).reshape(3, 4)
    for leg in (1, 2, 3):
        store.save(leg, x * leg, {"steps_done": leg}, block=True)
    assert store.legs() == [2, 3]          # pruned to keep=2
    leg, arr, man, skipped = store.load_latest_good()
    assert leg == 3 and man["steps_done"] == 3 and not skipped
    assert torch.equal(arr, x * 3)
    # a crashed save leaves only an invisible tmp dir
    store.save(4, x, {"steps_done": 4}, block=True, sabotage="crash")
    assert store.latest_leg() == 3
    assert any(".tmp" in d for d in os.listdir(tmp_path))


def test_store_checksum_refuses_corrupt_payload(tmp_path):
    store = CampaignStore(str(tmp_path))
    x = torch.ones((5, 5))
    store.save(1, x, {"steps_done": 1}, block=True)
    store.save(2, x * 2, {"steps_done": 2}, block=True, sabotage="corrupt")
    with pytest.raises(CorruptCheckpoint):
        store.load(2)
    leg, _, _, skipped = store.load_latest_good()
    assert leg == 1 and [s[0] for s in skipped] == [2]


def test_store_manifest_garbage_is_corrupt(tmp_path):
    store = CampaignStore(str(tmp_path))
    store.save(1, np.ones(3, np.float32), {"steps_done": 1}, block=True)
    with open(os.path.join(store.root, "leg_1", MANIFEST), "w") as f:
        f.write("{not json")
    with pytest.raises(CheckpointError):
        store.load_latest_good()


def test_store_snapshot_is_a_copy(tmp_path):
    """``save`` snapshots the carry at the call: writing into the tensor
    afterwards changes nothing on disk."""
    store = CampaignStore(str(tmp_path))
    x = torch.ones(4, 4)
    store.save(1, x, {"steps_done": 1})
    x.fill_(7.0)
    store.wait()
    assert torch.equal(store.load(1)[0], torch.ones(4, 4))


# --------------------------------------------------------- seeded soak ----
def _soak(seed: int, tmp_path) -> dict:
    prog, x, ref = _setup("j2d5pt", (12, 14), Boundary.dirichlet(0.0))
    cfg = FaultConfig(seed=seed, nan_at_leg=(2, 4),
                      corrupt_ckpt_at_leg=(3,), crash_save_at_leg=(5,))
    inj, clk = FaultInjector(cfg), SimClock()
    store = CampaignStore(str(tmp_path / f"s{seed}"))
    try:
        rep = run_campaign(prog, x, T_TOTAL, store=store, faults=inj,
                           clock=clk)
        out = {"outcome": "ok", "bitexact": _bitexact(rep.result, ref),
               "rollbacks": rep.rollbacks, "retries": rep.retries,
               "injected": rep.faults_injected}
    except CampaignFault as e:
        out = {"outcome": e.reason, "injected": inj.stats()}
    out["clock_ms"] = round(clk.now_ms(), 6)
    return out


def test_soak_every_fault_resolves_deterministically(tmp_path):
    """Under a mixed fault diet every campaign completes bit-exact — and
    rerunning a seed reproduces the identical outcome, clock included."""
    for seed in (0, 1):
        a = _soak(seed, tmp_path / "a")
        b = _soak(seed, tmp_path / "b")
        assert a == b
        assert a["outcome"] == "ok" and a["bitexact"]


def test_report_is_json_serializable(tmp_path):
    """Operators log reports; everything but the tensor must serialize."""
    prog, x, _ = _setup("j2d5pt", (12, 14), Boundary.dirichlet(0.0))
    rep = prog.run_resumable(x, T_TOTAL, store=str(tmp_path))
    d = {k: v for k, v in rep.__dict__.items() if k != "result"}
    json.dumps(d)


# --------------------------------------- sharded campaigns (CPU shards) ----
SHARDED_SHAPE, SHARDED_T = (64, 96), 22


@pytest.fixture
def sharded_setup():
    prog = compile_stencil(get("j2d5pt"), SHARDED_SHAPE, t=4, mesh=(2, 2),
                           device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        SHARDED_SHAPE).astype(np.float32))
    return prog, x, prog.run_sharded(x.clone(), SHARDED_T)


def test_sharded_resume_bitexact(tmp_path, sharded_setup):
    """Crash after leg 2 of a sharded campaign, resume: bit-exact with
    the uninterrupted ``run_sharded``."""
    prog, x, ref = sharded_setup
    store = CampaignStore(str(tmp_path))
    with pytest.raises(Crash):
        prog.run_sharded_resumable(x, SHARDED_T, store=store,
                                   on_leg=_crash_after(2, store))
    rep = resume_campaign(prog, store, sharded=True)
    assert rep.resumed_from == 2 and _bitexact(rep.result, ref)


def test_sharded_elastic_restore(tmp_path, sharded_setup):
    """A device lost before leg 3 restores onto (2, 1), over the first
    devices of the old mesh, and completes within 1e-5 of the run."""
    prog, x, ref = sharded_setup
    inj = FaultInjector(FaultConfig(device_loss_at_leg=(3,)))
    rep = prog.run_sharded_resumable(x, SHARDED_T,
                                     store=CampaignStore(str(tmp_path)),
                                     faults=inj, clock=SimClock())
    assert rep.mesh_history == [(2, 1)]
    np.testing.assert_allclose(rep.result.numpy(), ref.numpy(), atol=1e-5)


def test_sharded_mesh_exhausted(tmp_path, sharded_setup):
    """Repeated losses bottom out in a typed fault, never a hang."""
    prog, x, _ = sharded_setup
    inj = FaultInjector(FaultConfig(device_loss_at_leg=(1, 2, 3)))
    with pytest.raises(CampaignFault) as ei:
        prog.run_sharded_resumable(x, SHARDED_T,
                                   store=CampaignStore(str(tmp_path)),
                                   faults=inj, clock=SimClock())
    assert ei.value.reason == "mesh_exhausted"


def test_sharded_elastic_resume(tmp_path, sharded_setup):
    """A resume across a mesh change is refused strict and allowed
    elastic, within 1e-5 of the run."""
    prog, x, ref = sharded_setup
    store = CampaignStore(str(tmp_path))
    with pytest.raises(Crash):
        prog.run_sharded_resumable(x, SHARDED_T, store=store,
                                   on_leg=_crash_after(2, store))
    smaller = compile_stencil(get("j2d5pt"), SHARDED_SHAPE, t=4,
                              mesh=(2, 1), device="cpu")
    with pytest.raises(ResumeMismatch):
        resume_campaign(smaller, store, sharded=True,
                        policy=RetryPolicy(elastic=False))
    rep = resume_campaign(smaller, store, sharded=True,
                          policy=RetryPolicy(elastic=True))
    assert "mesh" in [d[0] for d in rep.elastic_drift]
    np.testing.assert_allclose(rep.result.numpy(), ref.numpy(), atol=1e-5)


# --------------------------------------------------- CLI crash-restart ----
def test_cli_kill_and_resume_bitexact(tmp_path):
    """Run, SIGKILL after leg 2 (exit 137), resume with ``--resume
    auto``, and compare with the uninterrupted run's ``--out``, bit for
    bit.  The uninterrupted run goes in-process; the killed and resumed
    ones are one child process each."""
    from repro_torch.launch import stencil_run

    args = ["--stencil", "j2d5pt", "--scale", "48", "--T", "24",
            "--device", "cpu"]
    ref, out = str(tmp_path / "ref.npy"), str(tmp_path / "out.npy")
    stencil_run.main(args + ["--checkpoint-dir", str(tmp_path / "a"),
                             "--out", ref])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "repro_torch.launch.stencil_run"] + args
    r = subprocess.run(base + ["--checkpoint-dir", str(tmp_path / "b"),
                               "--kill-after-leg", "2"],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode in (-9, 137), r.stderr[-2000:]
    assert "injected crash after leg 2" in r.stdout
    r = subprocess.run(base + ["--checkpoint-dir", str(tmp_path / "b"),
                               "--resume", "auto", "--out", out],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resumed@leg2" in r.stdout
    assert (np.load(ref) == np.load(out)).all()

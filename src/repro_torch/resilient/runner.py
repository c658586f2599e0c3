"""The campaign loop: temporal-block-aligned legs with bounded recovery
(counterpart of ``repro.resilient.runner``).

A campaign runs ``T`` steps as **legs** of ``every`` temporal blocks
each (``leg = every × t`` steps, remainder in the final leg).  Legs are
aligned to the program's sweep schedule, so the concatenation of the
per-leg schedules IS ``sweep_schedule(T, t)`` — which is why an
uninterrupted campaign, a crashed-and-resumed campaign, and a plain
``StencilProgram.run(x, T)`` are **bit-exact** equal: no step is ever
split or re-ordered by checkpointing, and on the card each leg launches
the same sweeps on the same inputs.  (Storage narrower than the compute
dtype is the exception: a bf16 carry is rounded to bf16 at every leg,
where ``run`` rounds once at the end, as in the reference.)

Per leg:

  1. dispatch the leg (``program.run`` / ``run_sharded``),
  2. ONE health reduction with one host sync
     (``resilient.health.probe``) judged against the
     :class:`~repro_torch.resilient.health.HealthEnvelope`,
  3. checkpoint the carry asynchronously
     (:class:`~repro_torch.resilient.store.CampaignStore` — atomic
     tmp-dir+rename, fingerprint manifest, content checksum).

On a fault the runner walks the bounded recovery ladder
(:mod:`~repro_torch.resilient.policy`): roll back to the last good
checkpoint (corrupt ones are skipped at the cost of their legs), retry
with backoff — after an elastic mesh shrink when the fault is a lost
device — and resolve a typed
:class:`~repro_torch.resilient.policy.CampaignFault` when the budget is
spent.  Nothing hangs: permanent faults surface immediately, transient
budgets are per-leg, mesh shrinks bottom out at one device, and a
global iteration guard backstops the lot.

The carry of a sharded campaign is the global field on the program's
device (the mesh's first device), which ``run_sharded`` splits over the
mesh at every leg: the port has no global sharded tensor to carry.

    report = run_campaign(prog, x, 512, store=store, every=2)
    report.result            # == prog.run(x, 512), bitwise
    report = resume_campaign(prog, store)     # after a crash
"""
from __future__ import annotations

import dataclasses
import random

from repro_torch.faults import FaultInjector, MonotonicClock, TransientFault
from repro_torch.resilient.health import (HealthEnvelope, HealthViolation,
                                          probe)
from repro_torch.resilient.policy import (CampaignFault, RetryPolicy,
                                          classify)
from repro_torch.resilient.store import (CampaignStore, CheckpointError,
                                         CorruptCheckpoint)


def leg_schedule(total_t: int, t: int, every: int = 1) -> list:
    """``[(leg_index, steps), ...]`` covering ``total_t`` steps in legs
    of ``every`` temporal blocks (1-based leg indices; the final leg
    carries the remainder).  Concatenating each leg's internal sweep
    schedule reproduces ``sweep_schedule(total_t, t)`` exactly — the
    alignment behind the bit-exact resume contract.

        leg_schedule(10, 4, 1)   # -> [(1, 4), (2, 4), (3, 2)]
        leg_schedule(16, 4, 2)   # -> [(1, 8), (2, 8)]
    """
    if total_t < 0 or t < 1 or every < 1:
        raise ValueError(f"need total_t >= 0, t >= 1, every >= 1; got "
                         f"({total_t}, {t}, {every})")
    width = every * t
    out, done, leg = [], 0, 1
    while done < total_t:
        steps = min(width, total_t - done)
        out.append((leg, steps))
        done += steps
        leg += 1
    return out


@dataclasses.dataclass
class CampaignReport:
    """What happened: the result plus the recovery forensics the soak
    tests (and operators) assert on."""

    result: object = None
    total_t: int = 0
    every: int = 1
    legs_total: int = 0
    legs_run: int = 0                  # leg executions incl. replays
    resumed_from: int | None = None    # checkpoint leg a resume started at
    retries: int = 0
    rollbacks: int = 0
    checkpoints_written: int = 0
    corrupt_skipped: list = dataclasses.field(default_factory=list)
    mesh_history: list = dataclasses.field(default_factory=list)
    elastic_drift: list = dataclasses.field(default_factory=list)
    final_rms: float | None = None
    faults_injected: dict | None = None


def _fingerprint(program, kind: str) -> dict:
    fp = program.fingerprint()
    fp["kind"] = kind
    return fp


def _to_device(arr, program, sharded: bool):
    """The carry on the program's device at its storage dtype.  A sharded
    program's device is its mesh's first device; ``run_sharded`` splits
    the carry over the mesh."""
    import torch

    v = torch.as_tensor(arr)
    return v.to(device=program.device, dtype=program.dtype)


def _poison(y):
    """NaN one cell of the carry (the injected numerical blow-up)."""
    y = y.clone()
    y[tuple(0 for _ in y.shape)] = float("nan")
    return y


def _shrunk_mesh_shape(program) -> tuple:
    """The next smaller mesh after a device loss: halve the last axis
    with more than one shard (even counts stay divisible; odd counts
    collapse to 1).  Raises ``CampaignFault('mesh_exhausted')`` at one
    device — there is nothing left to restore onto."""
    mesh = program.mesh
    dims = [int(mesh.shape[ax]) for ax in mesh.axis_names]
    for i in range(len(dims) - 1, -1, -1):
        if dims[i] > 1:
            dims[i] = dims[i] // 2 if dims[i] % 2 == 0 else 1
            return tuple(dims)
    raise CampaignFault("mesh_exhausted",
                        detail="mesh is already a single device")


def _recompiled(program, mesh_shape: tuple):
    """The same program on a smaller mesh (the elastic restore target),
    over the first devices of the old mesh; the §6 plan re-derives per
    the new, larger shard."""
    import math

    from repro_torch.api.program import compile_stencil
    from repro_torch.launch.mesh import make_stencil_mesh

    devices = list(program.mesh.devices.flat)[:math.prod(mesh_shape)]
    return compile_stencil(
        program.spec, program.shape, dtype=program.dtype, t=program.t,
        hw=program.hw, boundary=program.boundary, mode=program.mode,
        compute_dtype=program.compute_dtype, device=program.device,
        mesh=make_stencil_mesh(mesh_shape, devices=devices))


def run_campaign(program, x=None, total_t: int | None = None, *,
                 store, every: int = 1,
                 policy: RetryPolicy | None = None,
                 health: HealthEnvelope | None = None,
                 faults: FaultInjector | None = None,
                 clock=None, resume: str = "auto", sharded: bool = False,
                 on_leg=None) -> CampaignReport:
    """Run (or resume) a checkpointed campaign of ``total_t`` steps.

    ``resume`` ∈ {'auto', 'always', 'never'}: 'auto' resumes when the
    store holds a checkpoint and starts fresh otherwise; 'always'
    demands one (typed ``CampaignFault('no_checkpoint')`` if absent);
    'never' ignores existing checkpoints (and overwrites them leg by
    leg).  ``on_leg(leg, steps_done)`` fires after each successful
    leg's checkpoint is queued — the CLI's crash-injection hook.

    Returns a :class:`CampaignReport`; ``report.result`` is bit-exact
    equal to the uninterrupted ``program.run(x, total_t)`` (or
    ``run_sharded``) — see ``tests/test_torch_resilient.py``.
    """
    store = CampaignStore(store) if isinstance(store, str) else store
    policy = policy or RetryPolicy()
    health = health or HealthEnvelope()
    clock = clock or MonotonicClock()
    jitter = random.Random(policy.seed)
    if resume not in ("auto", "always", "never"):
        raise ValueError(f"resume must be auto|always|never, got {resume!r}")
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")
    kind = "sharded" if sharded else "single"
    report = CampaignReport(every=every)

    # ------------------------------------------------------ start state ----
    manifest0 = None
    if resume != "never":
        try:
            store.wait()
            leg0, arr, manifest0, skipped = store.load_latest_good()
        except CheckpointError as e:
            if isinstance(e, CorruptCheckpoint):
                raise CampaignFault("checkpoints_corrupt",
                                    detail=str(e)) from e
            if resume == "always":
                raise CampaignFault("no_checkpoint", detail=str(e)) from e
        else:
            report.corrupt_skipped.extend(skipped)
    if manifest0 is not None:
        report.elastic_drift = CampaignStore.check_fingerprint(
            manifest0, _fingerprint(program, kind),
            total_t=total_t, every=every, elastic=policy.elastic)
        total_t = int(manifest0["total_t"])
        carry = _to_device(arr, program, sharded)
        steps_done = int(manifest0["steps_done"])
        prev_rms = manifest0.get("rms")
        report.resumed_from = leg0
    else:
        if x is None or total_t is None:
            raise ValueError(
                "a fresh campaign needs x and total_t "
                "(resume='always' resumes without them)")
        carry = _to_device(x, program, sharded)
        steps_done = 0
        _, prev_rms = probe(carry)
        # leg 0 anchors rollback before the first leg ever checkpoints
        store.save(0, carry, _manifest(program, kind, 0, total_t, every,
                                       prev_rms))
        report.checkpoints_written += 1
    report.total_t = total_t
    schedule = leg_schedule(total_t, program.t, every)
    report.legs_total = len(schedule)
    width = every * program.t

    # --------------------------------------------------------- leg loop ----
    attempts: dict = {}
    guard = len(schedule) * (policy.max_retries + 2) + 16
    while steps_done < total_t:
        guard -= 1
        if guard < 0:        # belt-and-braces no-hang backstop
            raise CampaignFault(
                "internal", detail="iteration guard tripped — recovery "
                "loop did not converge")
        leg = steps_done // width + 1
        steps = min(width, total_t - steps_done)
        try:
            if sharded and faults is not None and faults.lose_device(leg):
                raise TransientFault(
                    "device_lost", f"shard dropped before leg {leg}")
            y = (program.run_sharded(carry, steps) if sharded
                 else program.run(carry, steps))
            if faults is not None and faults.poison_leg(leg):
                y = _poison(y)
            finite, rms = probe(y)
            health.judge(finite=finite, rms=rms, prev_rms=prev_rms,
                         leg=leg)
        except Exception as e:  # noqa: BLE001 — classified below
            if classify(e) == "permanent":
                raise CampaignFault("internal", leg=leg,
                                    detail=repr(e)) from e
            lost = isinstance(e, TransientFault) and e.kind == "device_lost"
            if lost and sharded and policy.elastic:
                shape = _shrunk_mesh_shape(program)
                program = _recompiled(program, shape)
                report.mesh_history.append(shape)
            else:
                attempts[leg] = attempts.get(leg, 0) + 1
                if attempts[leg] > policy.max_retries:
                    reason = ("health" if isinstance(e, HealthViolation)
                              else "retries_exhausted")
                    raise CampaignFault(
                        reason, leg=leg,
                        detail=f"{attempts[leg]} attempts: {e}") from e
                report.retries += 1
            # roll back to the last good checkpoint (skipping corrupt
            # ones), pace the retry on the injected clock
            store.wait()
            try:
                leg_g, arr, man, skipped = store.load_latest_good()
            except CorruptCheckpoint as ce:
                raise CampaignFault("checkpoints_corrupt", leg=leg,
                                    detail=str(ce)) from ce
            report.corrupt_skipped.extend(skipped)
            report.rollbacks += 1
            carry = _to_device(arr, program, sharded)
            steps_done = int(man["steps_done"])
            prev_rms = man.get("rms")
            clock.advance(policy.backoff_ms(
                attempts.get(leg, 1) - 1, jitter))
            continue
        # ------------------------------------------------- leg landed ----
        carry, steps_done, prev_rms = y, steps_done + steps, rms
        report.legs_run += 1
        sabotage = (faults.checkpoint_sabotage(leg)
                    if faults is not None else None)
        store.save(leg, carry,
                   _manifest(program, kind, steps_done, total_t, every,
                             rms), sabotage=sabotage)
        if sabotage != "crash":
            report.checkpoints_written += 1
        if on_leg is not None:
            on_leg(leg, steps_done)

    store.wait()
    report.result = carry
    report.final_rms = prev_rms
    if faults is not None:
        report.faults_injected = faults.stats()
    return report


def resume_campaign(program, store, **kwargs) -> CampaignReport:
    """Resume a crashed campaign from its store — everything (carry,
    steps done, total steps) comes from the newest good checkpoint,
    after the manifest's fingerprints are validated against ``program``
    (mismatches refuse with the fix spelled out —
    :class:`~repro_torch.resilient.store.ResumeMismatch`).

        report = resume_campaign(prog, CampaignStore(ckpt_dir))
        report.result      # bit-exact == the uninterrupted run
    """
    return run_campaign(program, None, None, store=store,
                        resume="always", **kwargs)


def _manifest(program, kind: str, steps_done: int, total_t: int,
              every: int, rms: float | None) -> dict:
    m = _fingerprint(program, kind)
    m.update(steps_done=int(steps_done), total_t=int(total_t),
             every=int(every), rms=rms)
    return m

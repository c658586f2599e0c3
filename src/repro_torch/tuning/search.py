"""Budgeted successive-halving search over stencil tuning candidates
(counterpart of ``repro.tuning.search``).

The candidate space is the §6 analytic plan's NEIGHBORHOOD — halve /
keep / double the planner's depth and leading tile (``bh`` in 2-D, the z
chunk ``zc`` in 3-D) — on the thesis that the analytic optimum is
near-right and measurement should correct it, not replace it
(ARTEMIS/DRSTENCIL search blind; AN5D searches a pruned neighborhood; we
seed from the model).  The seed is the tile the analytic program
launches: the plan's own in 2-D, the planner's fit for the exact shape
in 3-D.

Noise discipline (the reference's protocol):

  * every candidate is timed best-of-N through the real
    ``StencilProgram.run`` chain: CUDA events around each call on the
    card, synchronised; ``time.perf_counter`` on the CPU;
  * each round ALSO times the untouched naive control, the port's plain
    oracle (``kernels/ref.py`` ``reference``) on the same device, and
    scores candidates by the ratio ``candidate / naive``, so a burst of
    load that slows both sides leaves the ranking alone;
  * successive halving: every surviving candidate is re-timed each
    round at doubled repetitions, so the total timing budget
    concentrates on the contenders.

Before any timing, candidates are priced analytically
(:mod:`repro_torch.tuning.analytic`, the launch-geometry traffic model):
a candidate whose per-step HBM traffic exceeds ``prune_ratio`` × the
cheapest candidate's is dropped unmeasured (the seed itself is never
pruned), and a candidate whose tile the kernel cannot take is dropped as
``compile: ...``.

Every timing call increments ``TIMING["calls"]`` — the injected counter
the tests use to assert that a warm-DB ``compile_stencil(...,
mode="tuned")`` performs ZERO timing.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import roofline as rl
from repro_torch.tuning import plandb as _plandb
from repro_torch.tuning.analytic import analytic_bytes_per_step

# the ONE seam through which the search observes time; the tuned
# compile path must never touch it (asserted in tests)
TIMING = {"calls": 0}


def _timed(fn, reps: int, device) -> float:
    """Best time per call in µs over ``reps`` calls (min-of-N): CUDA
    events around each call on the card, synchronised; the host clock on
    the CPU (``core.device.Timer``)."""
    from repro_torch.core.device import Timer

    best = float("inf")
    for _ in range(reps):
        TIMING["calls"] += 1
        with Timer(device) as tm:
            fn()
        best = min(best, tm.ms)
    return best * 1e3


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the search space: sweep depth, CTA tile, streaming
    batch (1: the port's kernels have no such knob) and which kernel
    family executes it."""
    t: int
    block: tuple
    lazy_batch: int
    exec_mode: str     # 'fused' (the port's 'scratch' is the same launch)

    def label(self) -> str:
        b = "x".join(str(int(v)) for v in self.block)
        return f"t{self.t}-b{b}-lb{self.lazy_batch}-{self.exec_mode}"


def pin(spec, shape, hw, t: int, block: tuple, itemsize: int = 4):
    """The analytic plan with depth ``t`` and tile ``block`` pinned over
    it, its ``halo``, ``smem_bytes`` and ``threads`` recomputed for that
    tile (the planner's shared-memory budget; in 3-D the threads the
    kernel spreads the levels over, or its cap where it refuses the
    tile, which the front door then refuses by name)."""
    from repro_torch.api.program import plan_bucketed
    from repro_torch.core import planner as pl

    base = plan_bucketed(spec, shape, hw, itemsize)
    block = tuple(int(b) for b in block)
    if spec.ndim == 2:
        smem = pl.smem_bytes_2d(spec, t, *block, itemsize)
        threads = pl.THREADS
    else:
        _, ty, tx = block
        smem = pl.smem_bytes_3d(spec, t, tuple(shape), ty, tx, itemsize)
        spread = pl.kernel_threads_3d(spec, t, tuple(shape), ty, tx,
                                      itemsize)
        threads = (pl.KERNEL_THREADS_3D if spread is None
                   else -(-sum(spread[0]) // 32) * 32)
    return dataclasses.replace(base, t=int(t), halo=spec.halo(int(t)),
                               block=block, threads=threads,
                               smem_bytes=smem)


def seed_plan(spec, shape, hw, itemsize: int = 4):
    """The analytic program's plan with the tile it really launches
    pinned: the plan's own in 2-D, the planner's fit for the exact
    ``shape`` in 3-D (the plan is made for the 64-rounded bucket)."""
    from repro_torch.api.program import plan_bucketed, sweep_tile_3d

    base = plan_bucketed(spec, shape, hw, itemsize)
    block = (base.block if spec.ndim == 2 else
             sweep_tile_3d(spec, base.t, tuple(shape), hw, itemsize))
    return pin(spec, shape, hw, base.t, block, itemsize)


def pinned_plan(spec, shape, hw, cand: Candidate, itemsize: int = 4):
    """The analytic plan with the candidate's knobs pinned over it — the
    front door honors an explicit plan verbatim, so the search and tuned
    replay drive the exact same dispatch path."""
    return pin(spec, shape, hw, cand.t, cand.block, itemsize)


def neighborhood(spec, shape, plan, *,
                 max_candidates: int = 12) -> list[Candidate]:
    """Candidates around the §6 plan: {½, 1, 2}× depth × {½, 1, 2}× the
    leading tile (``bh`` in 2-D, ``zc`` in 3-D), deduplicated, seed
    first, nearest-to-seed order, truncated to ``max_candidates``.

    Only ``exec_mode="fused"``: the port's ``"scratch"`` is the same
    launch, so timing it again would only spend budget; ``lazy_batch``
    is fixed at 1."""
    ts = sorted({max(1, plan.t // 2), plan.t, plan.t * 2})
    ts = [t for t in ts if 2 * spec.halo(t) <= min(shape)] or [1]
    lead = plan.block[0]
    tiles = sorted({max(1, lead // 2), lead, lead * 2})
    seed = Candidate(plan.t, tuple(plan.block), 1, "fused")
    cands = {seed}
    for t in ts:
        for tile in tiles:
            cands.add(Candidate(t, (tile,) + tuple(plan.block[1:]), 1,
                                "fused"))

    def dist(c: Candidate):
        return (c != seed, abs(math.log2(c.t / plan.t)),
                abs(math.log2(c.block[0] / lead)), c.label())

    ordered = sorted(cands, key=dist)
    return ordered[:max(1, max_candidates)]


@dataclasses.dataclass
class TuneResult:
    winner: Candidate
    plan: object               # the winner's pinned EbisuPlan
    record: dict               # the plandb record (written when db given)
    rounds: list               # per-round {reps, naive_us, scores}
    candidates: list           # everything the neighborhood proposed
    pruned: list               # (candidate, reason) dropped pre-timing
    timing_calls: int
    seed: Candidate | None = None   # the analytic plan's candidate

    def summary(self) -> str:
        last = self.rounds[-1]["scores"] if self.rounds else {}
        us, ratio = last.get(self.winner, (float("nan"), float("nan")))
        return (f"winner {self.winner.label()}: {us:.0f}us "
                f"({ratio:.3f}x naive) after {len(self.rounds)} round(s), "
                f"{self.timing_calls} timing calls, "
                f"{len(self.pruned)} pruned before timing")


def tune(spec, shape, *, hw: rl.HardwareModel | None = None, db=None,
         budget: int = 64, total_t: int | None = None, reps: int = 2,
         device=None, prune_ratio: float = 3.0, max_candidates: int = 12,
         log=None) -> TuneResult:
    """Search the plan neighborhood under a timing-call ``budget`` and
    (when ``db`` is given) persist the winner for
    ``compile_stencil(..., mode="tuned")`` to replay with zero search.

        db = PlanDB(path)
        res = tune(get("j2d5pt"), (8352, 8352), db=db, budget=64)
        res.winner, res.summary()

    ``device`` defaults to the card (``device="cpu"`` times the plain
    version); ``hw`` to its H100 model.  ``budget`` caps timing calls
    (min-of-N reps each count N); the first round always runs in full so
    every unpruned candidate is measured at least once.  ``total_t`` is
    the chain length timed (default: twice the deepest candidate, so deep
    sweeps amortize as they would in a campaign).  Candidates whose tile
    the kernel cannot take, or that fail to warm up, are dropped with a
    reason, not fatal.
    """
    from repro_torch.api.program import compile_stencil
    from repro_torch.core.device import resolve_device
    from repro_torch.kernels import ref
    from repro_torch.stencils.data import init_domain

    say = log if log is not None else (lambda *_: None)
    shape = tuple(int(n) for n in shape)
    device = resolve_device(device)
    hw = hw or rl.hardware_for(device)
    base = seed_plan(spec, shape, hw)
    candidates = neighborhood(spec, shape, base,
                              max_candidates=max_candidates)
    seed = candidates[0]
    total_t = (2 * max(c.t for c in candidates) if total_t is None
               else int(total_t))

    x = init_domain(spec, shape, device=device)
    progs, pruned = {}, []
    for c in candidates:
        try:
            progs[c] = compile_stencil(
                spec, shape, t=c.t, hw=hw, mode=c.exec_mode, device=device,
                plan=pinned_plan(spec, shape, hw, c))
        except ValueError as e:
            pruned.append((c, f"compile: {e}"))

    # analytic pruning: per-step modelled HBM bytes, relative to the
    # cheapest candidate (never to naive — see tuning/analytic.py)
    per_step = {c: analytic_bytes_per_step(prog, total_t)
                for c, prog in progs.items()}
    floor = min(per_step.values(), default=float("inf"))
    survivors = []
    for c in progs:
        if c != seed and per_step[c] > prune_ratio * floor:
            pruned.append((c, f"analytic: {per_step[c]:.0f} B/step > "
                              f"{prune_ratio:.1f}x floor {floor:.0f}"))
        else:
            survivors.append(c)
    say(f"[tune] {spec.name} {shape}: {len(candidates)} candidates, "
        f"{len(pruned)} pruned, timing {len(survivors)} (budget {budget})")

    # warm every survivor and the naive control OUTSIDE the timed region
    def naive():
        return ref.reference(x, spec, total_t)

    naive()
    _sync(device)
    warmed = []
    for c in survivors:
        try:
            progs[c].run(x, total_t)
            _sync(device)
            warmed.append(c)
        except Exception as e:  # noqa: BLE001
            pruned.append((c, f"warmup: {e}"))
    survivors = warmed
    if not survivors:
        raise RuntimeError(f"tune {spec.name} {shape}: no candidate "
                           f"compiled and warmed up: {pruned}")

    rounds, spent, r = [], 0, max(1, reps)
    while True:
        cost = (len(survivors) + 1) * r
        if rounds and spent + cost > budget:
            break
        naive_us = _timed(naive, r, device)
        scores = {}
        for c in survivors:
            us = _timed(lambda c=c: progs[c].run(x, total_t), r, device)
            scores[c] = (us, us / naive_us)
        spent += cost
        rounds.append({"reps": r, "naive_us": naive_us, "scores": scores})
        ranked = sorted(survivors, key=lambda c: scores[c][1])
        say("[tune] round {}: naive {:.0f}us | ".format(len(rounds),
                                                        naive_us)
            + " ".join(f"{c.label()}={scores[c][1]:.4f}x" for c in ranked))
        if len(survivors) == 1:
            break
        survivors = ranked[:max(1, math.ceil(len(survivors) / 2))]
        r *= 2

    winner = min(rounds[-1]["scores"],
                 key=lambda c: rounds[-1]["scores"][c][1])
    wplan = pinned_plan(spec, shape, hw, winner)
    us, ratio = rounds[-1]["scores"][winner]
    measured = {
        "best_us": round(us, 1),
        "naive_us": round(rounds[-1]["naive_us"], 1),
        "ratio_to_naive": round(ratio, 4),
        "total_t": total_t,
        "rounds": len(rounds),
        "timing_calls": spent,
        "budget": budget,
        "analytic_bytes_per_step": round(per_step.get(winner, 0.0), 1),
        "seed_was_winner": winner == seed,
    }
    key = _plandb.db_key(spec, shape, _plandb.hw_fingerprint(device),
                         _plandb.tier_for(device))
    record = _plandb.make_record(key, wplan, winner.exec_mode, measured)
    if db is not None:
        path = _plandb.resolve_db(db).put(key, record)
        say(f"[tune] persisted winner -> {path}")
    res = TuneResult(winner=winner, plan=wplan, record=record,
                     rounds=rounds, candidates=candidates, pruned=pruned,
                     timing_calls=spent, seed=seed)
    say("[tune] " + res.summary())
    return res


def _sync(device) -> None:
    """Wait for the device's work: the card's launches are asynchronous."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)

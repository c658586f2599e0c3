"""Analytic candidate costs: bytes and flops from the launch geometry.

The reference prices a tuning candidate by lowering its sweep chain to
XLA HLO and counting the lowered program's traffic
(``repro.analysis.hlo_cost``).  The port has no lowered program to read:
its chain is a loop of hand-written kernel launches.  So the price comes
from the launches themselves.  For each sweep of ``program.run(x,
total_t)`` (:func:`~repro_torch.api.program.sweep_schedule`),
:func:`~repro_torch.api.program.resolve_geometry` gives the grid and, per
CTA, the cells it loads (``fetched_cells``) and writes (``body_cells``),
and the stencil applications the launch computes with its trapezoid
(``cell_updates``); the traffic model is

  * bytes: ``CTAs × (fetched_cells + body_cells) × itemsize`` of the
    compute dtype, summed over the sweeps;
  * flops: ``cell_updates × spec.flops_per_cell``, summed likewise.

It is what the kernels move and compute, not what a boundary's ghost
re-pin or the final cast around them cost.  Two consumers, as in the
reference:

  * the measured search prunes candidates whose per-step traffic is a
    multiple of the best candidate's before spending any timing on them
    (``prune_ratio`` in :func:`repro_torch.tuning.search.tune`);
  * a benchmark can carry ``analytic_bytes=`` per row: a deterministic
    traffic column that machine load cannot contaminate.

Nothing here launches anything or touches a tensor.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.api.program import ProgramCache, sweep_schedule

# candidates within a tune() call and repeated benchmark rows in one
# process share this cache
ANALYTIC_CACHE = ProgramCache(128, "analytic")


@dataclasses.dataclass(frozen=True)
class TrafficCost:
    """The modelled HBM bytes and tap flops of one chain of sweeps."""
    bytes_accessed: float
    flops: float
    sweeps: int


def _traffic(program, total_t: int) -> TrafficCost:
    import torch

    itemsize = torch.empty((), dtype=program.compute_dtype).element_size()
    nbytes = flops = 0.0
    schedule = sweep_schedule(total_t, program.t)
    for depth in schedule:
        g = program.geometry(depth)
        nbytes += (math.prod(g["grid"])
                   * (g["fetched_cells"] + g["body_cells"]) * itemsize)
        flops += g["cell_updates"] * program.kernel_spec.flops_per_cell
    return TrafficCost(bytes_accessed=nbytes, flops=flops,
                       sweeps=len(schedule))


def analytic_cost(program, total_t: int | None = None) -> TrafficCost:
    """The modelled :class:`TrafficCost` of the program's ``total_t``-step
    chain (default: one sweep at the program's depth), memoized per
    program key.

        cost = analytic_cost(prog, total_t=prog.t)
        cost.bytes_accessed, cost.flops     # deterministic, load-immune
    """
    total_t = program.t if total_t is None else int(total_t)
    return ANALYTIC_CACHE.get_or_build(
        (program._key, total_t), lambda: _traffic(program, total_t))


def analytic_bytes_per_step(program, total_t: int | None = None) -> float:
    """HBM bytes per simulated time step — the search's pruning metric
    (normalizing by ``total_t`` makes depths comparable: a deeper sweep
    amortizes its traffic over more steps)."""
    total_t = program.t if total_t is None else int(total_t)
    return analytic_cost(program, total_t).bytes_accessed / max(1, total_t)


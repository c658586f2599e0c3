"""Measured autotuning with a persistent plan database (counterpart of
``repro.tuning``).

The §6 planner is analytic; ARTEMIS/DRSTENCIL — the paper's strongest
baselines — are empirical searchers.  This package closes the loop on
the card:

  * :mod:`repro_torch.tuning.search` — budgeted successive halving over
    (t, tile) candidates seeded by the analytic plan's neighborhood, each
    timed best-of-N through the real ``StencilProgram.run`` (CUDA events
    on the card) and scored by the ratio to an interleaved plain-oracle
    control;
  * :mod:`repro_torch.tuning.plandb` — winners persisted as checksummed
    JSON records keyed on (spec signature, shape bucket, ``cuda:<device
    name>``, native/interpret), written atomically (tmp +
    ``os.rename``), so ``compile_stencil(..., mode="tuned")`` resolves a
    measured plan with ZERO search or timing on a warm DB;
  * :mod:`repro_torch.tuning.analytic` — the launch-geometry traffic
    model (bytes and tap flops from ``resolve_geometry``) that prunes
    traffic-pathological candidates before any timing is spent.  It
    takes the place of the reference's XLA-HLO cost reading.

CLI: ``python -m repro_torch.tuning {sweep,show-db,prune-stale,check}``.
Importing the package imports no jax or triton and initializes no CUDA.
"""
from repro_torch.tuning.analytic import analytic_bytes_per_step, analytic_cost
from repro_torch.tuning.plandb import (PlanDB, db_key, default_db_path,
                                       hw_fingerprint, plan_from_record)
from repro_torch.tuning.search import Candidate, TuneResult, neighborhood, tune

__all__ = [
    "Candidate", "PlanDB", "TuneResult", "analytic_bytes_per_step",
    "analytic_cost", "db_key", "default_db_path", "hw_fingerprint",
    "neighborhood", "plan_from_record", "tune",
]

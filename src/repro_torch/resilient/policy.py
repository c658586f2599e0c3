"""Recovery policy: bounded retries, fault classification, the typed bottom
(counterpart of ``repro.resilient.policy``, copied).

The campaign runner's contract: every failure walks a *bounded* recovery
path and the bottom of that path is a typed error, never a hang or a raw
traceback.  For campaigns the ladder is:

    leg fault -> roll back to last good checkpoint
              -> retry with exponential backoff + seeded jitter
                 (elastic mesh shrink first, when the fault is a lost
                  device on a sharded campaign)
              -> typed CampaignFault after ``max_retries`` per leg

:func:`classify` decides which exceptions enter the ladder at all:
transient kinds (injected :class:`~repro_torch.faults.TransientFault`, a
:class:`~repro_torch.resilient.health.HealthViolation` — a one-off
corruption re-runs clean) are retried; anything else is permanent and
surfaces as a ``CampaignFault('internal')`` immediately — retrying a
genuine bug just burns the budget.
"""
from __future__ import annotations

import dataclasses
import random

from repro_torch.faults import TransientFault
from repro_torch.resilient.health import HealthViolation

REASONS = ("health", "retries_exhausted", "checkpoints_corrupt",
           "no_checkpoint", "mesh_exhausted", "internal")


class CampaignFault(RuntimeError):
    """The campaign's typed bottom rung.  ``reason`` ∈ ``REASONS``;
    ``leg`` is where recovery gave up (None for pre-start faults like
    ``no_checkpoint``).  Raised instead of hanging or leaking the
    underlying exception — the cause is chained for forensics."""

    def __init__(self, reason: str, *, leg: int | None = None,
                 detail: str = ""):
        assert reason in REASONS, reason
        at = f" at leg {leg}" if leg is not None else ""
        super().__init__(f"campaign fault{at}: {reason}"
                         + (f" — {detail}" if detail else ""))
        self.reason = reason
        self.leg = leg


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded recovery knobs.

    * ``max_retries`` — rollback+retry attempts per leg index before the
      typed ``CampaignFault``; a leg replayed after a *later* leg's
      rollback keeps its own budget.
    * ``backoff_*`` — exponential backoff with seeded jitter, advanced
      on the injected clock (a ``SimClock`` soak spends no wall time).
    * ``elastic`` — on ``device_lost`` (sharded campaigns), recompile
      onto a smaller mesh and re-place the carry instead of failing; at
      resume, allow the checkpoint's mesh/plan to differ from the live
      program's (the carry is re-placed).  ``False`` = strict.
    * ``seed`` — the jitter RNG seed (determinism contract of
      ``repro_torch.faults``).
    """

    max_retries: int = 2
    backoff_base_ms: float = 1.0
    backoff_factor: float = 2.0
    backoff_jitter_ms: float = 0.5
    elastic: bool = True
    seed: int = 0

    def backoff_ms(self, attempt: int, rng: random.Random) -> float:
        """Backoff before retry ``attempt`` (0-based), jittered."""
        return (self.backoff_base_ms * self.backoff_factor ** attempt
                + rng.uniform(0, self.backoff_jitter_ms))


def classify(exc: BaseException) -> str:
    """``'transient'`` (enter the rollback/retry ladder) or
    ``'permanent'`` (surface as ``CampaignFault('internal')`` now).

        classify(TransientFault("evicted"))          # 'transient'
        classify(HealthViolation("nonfinite", 3, 0)) # 'transient'
        classify(TypeError("boom"))                  # 'permanent'
    """
    if isinstance(exc, (TransientFault, HealthViolation)):
        return "transient"
    return "permanent"

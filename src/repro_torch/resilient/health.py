"""Per-leg health monitoring: ONE reduction on the device, a configurable
envelope (counterpart of ``repro.resilient.health``).

A long campaign dies numerically in two ways: non-finite values (NaN/Inf
from blow-up or a flipped bit) and silent norm drift (an unstable tap
set amplifying round-off until the field is garbage while still
finite).  Both are caught by a single reduction per leg — :func:`probe`
computes ``(all-finite, rms)`` on the carry's device and brings both to
the host in one transfer, **one host sync per leg**, the counterpart of
the reference's single fused jitted reduction: a health check that cost
a device round trip per tile would eat the temporal-blocking win it
guards.

The verdict is judged against a :class:`HealthEnvelope`:

    env = HealthEnvelope(max_growth=1.05, max_rms=10.0)
    env.judge(finite=True, rms=3.2, prev_rms=3.1, leg=4)   # ok -> None
    env.judge(finite=False, rms=float("nan"), ...)         # raises

``max_growth`` bounds per-leg rms growth (diffusive/normalized tap sets
contract or preserve the norm, so sustained growth means instability);
``max_rms`` is an absolute ceiling.  Both default off — finiteness is
always checked.  Violations raise :class:`HealthViolation`, which the
runner classifies as *transient* (roll back, retry with backoff: a
one-off corruption re-runs clean) until the bounded retry budget turns
it into a typed ``CampaignFault``.
"""
from __future__ import annotations

import dataclasses


class HealthViolation(RuntimeError):
    """A leg's output failed the health envelope.  ``reason`` ∈
    {'nonfinite', 'rms_ceiling', 'rms_drift'}; carries the measured
    stats for the report/fault message."""

    def __init__(self, reason: str, leg: int, rms: float,
                 detail: str = ""):
        super().__init__(f"leg {leg}: {reason} (rms={rms:g})"
                         + (f" — {detail}" if detail else ""))
        self.reason = reason
        self.leg = leg
        self.rms = rms


@dataclasses.dataclass(frozen=True)
class HealthEnvelope:
    """What "healthy" means for a campaign carry, checked once per leg.

    * ``check_finite`` — refuse NaN/Inf anywhere in the field (on by
      default; turning it off is for fields that legitimately carry
      infinities).
    * ``max_growth`` — per-leg rms growth factor ceiling (None = off).
      Applied as ``rms > max_growth * prev_rms + atol``.
    * ``max_rms`` — absolute rms ceiling (None = off).
    * ``atol`` — additive slack so a near-zero field's round-off noise
      does not read as infinite relative growth.
    """

    check_finite: bool = True
    max_growth: float | None = None
    max_rms: float | None = None
    atol: float = 1e-12

    def judge(self, *, finite: bool, rms: float, prev_rms: float | None,
              leg: int) -> None:
        """Raise :class:`HealthViolation` if the leg's verdict falls
        outside the envelope; return None when healthy."""
        if self.check_finite and not finite:
            raise HealthViolation("nonfinite", leg, rms,
                                  "NaN/Inf in the carry")
        if self.max_rms is not None and rms > self.max_rms:
            raise HealthViolation(
                "rms_ceiling", leg, rms, f"ceiling {self.max_rms:g}")
        if (self.max_growth is not None and prev_rms is not None
                and rms > self.max_growth * prev_rms + self.atol):
            raise HealthViolation(
                "rms_drift", leg, rms,
                f"grew more than {self.max_growth:g}x from "
                f"{prev_rms:g} in one leg")


def probe(carry) -> tuple:
    """``(finite, rms)`` of a carry: one reduction on the carry's device
    in float32, as the reference's, both results stacked into one tensor
    and brought to the host in one transfer."""
    import torch

    w = torch.as_tensor(carry).float()
    stats = torch.stack([torch.isfinite(w).all().to(w.dtype),
                         w.square().mean().sqrt()]).tolist()
    return bool(stats[0]), float(stats[1])

"""Crash-safe resumable stencil campaigns (counterpart of
``repro.resilient``).

``StencilProgram.run``/``run_sharded`` are all-or-nothing; this package
runs the same ``T`` steps as temporal-block-aligned **legs** with
checkpointing, health monitoring, and bounded recovery, and a resumed
campaign is **bit-exact** equal to the uninterrupted run:

    from repro_torch.resilient import CampaignStore
    store = CampaignStore("/ckpt/heat3d")
    rep = prog.run_resumable(x, 512, store=store, every=2)  # leg = 2 blocks
    # ... SIGKILL / preemption / power loss ...
    rep = prog.run_resumable(x, 512, store=store)           # resumes

Pieces:

  * :class:`~repro_torch.resilient.store.CampaignStore` — atomic
    (tmp-dir + rename) checkpoints with async host-side serialization,
    a fingerprint manifest, and a content checksum; corrupt payloads are
    refused at load (``CorruptCheckpoint``) and fingerprint drift at
    resume is refused with the fixes spelled out (``ResumeMismatch``).
  * :mod:`~repro_torch.resilient.health` — ONE reduction and one host
    sync per leg, judged against a configurable ``HealthEnvelope``.
  * :mod:`~repro_torch.resilient.policy` — bounded retry/backoff
    (``RetryPolicy``), transient/permanent fault classification, and the
    typed ``CampaignFault`` bottom rung — every rung bounded, no path
    hangs.
  * :mod:`~repro_torch.resilient.runner` — the leg loop:
    ``run_campaign`` / ``resume_campaign``, with rollback to the last
    good checkpoint and elastic restore onto a smaller mesh when a
    device drops from a sharded campaign.

Fault injection for all of it lives in :mod:`repro_torch.faults`,
seeded and deterministic.
"""
from repro_torch.resilient.health import HealthEnvelope, HealthViolation
from repro_torch.resilient.policy import (CampaignFault, RetryPolicy,
                                          classify)
from repro_torch.resilient.runner import (CampaignReport, leg_schedule,
                                          resume_campaign, run_campaign)
from repro_torch.resilient.store import (CampaignStore, CheckpointError,
                                         CorruptCheckpoint, ResumeMismatch)

__all__ = [
    "CampaignFault",
    "CampaignReport",
    "CampaignStore",
    "CheckpointError",
    "CorruptCheckpoint",
    "HealthEnvelope",
    "HealthViolation",
    "ResumeMismatch",
    "RetryPolicy",
    "classify",
    "leg_schedule",
    "resume_campaign",
    "run_campaign",
]

"""Seeded fault injection for the resumable campaign runner, and later
the stencil service (the port's own copy of ``repro.faults``).

A system that only ever sees healthy traffic is untested by
construction, so the hardened layers — the campaign runner
(``repro_torch.resilient``), and the request path of the stencil
service when it is ported (ROADMAP Queue 1 item 11) — are validated the
other way around: :class:`FaultInjector` drives every failure mode they
defend against, from one seeded RNG, with **no wall-clock or unseeded
randomness in results** — the same :class:`FaultConfig` always produces
the same fault sequence, so the campaign tests
(``tests/test_torch_resilient.py``) are deterministic regression tests,
not flake generators.  ``tests/test_torch_faults.py`` holds this copy
equal to the reference's: the same config and seed give the same
sequence of every decision.

Three kinds of faults:

  * **dispatch faults** a service core consults at its hook points —
    transient errors (:class:`TransientFault` with ``kind='evicted'`` /
    ``'oom'``) that the retry/backoff + degradation ladder must absorb,
    plus injected dispatch delays that push in-flight requests past
    their deadlines;
  * **traffic faults** a driver weaves into synthetic load —
    NaN-poisoned inputs, oversized shapes, already-expired deadlines —
    via :meth:`FaultInjector.classify_request`;
  * **campaign faults** the resumable runner consults between legs —
    NaN blow-up at leg ``k``, a checkpoint corrupted on disk, a save
    "crashed" mid-``tmp`` (abandoned before the atomic rename), a
    device lost from the mesh mid-run.  Each is listed per leg index so
    a test pins exactly where the campaign gets hurt; the runner must
    resolve every one to a recovery or a typed
    :class:`~repro_torch.resilient.policy.CampaignFault` — nothing hangs.

This module also holds the injectable clocks (:class:`SimClock`,
:class:`MonotonicClock`) the runner paces its backoff with: simulated
time is what makes a soak run in seconds, deterministically.

    inj = FaultInjector(FaultConfig(seed=7, nan_at_leg=(3,)))
    prog.run_resumable(x, T, store=store, faults=inj, clock=SimClock())

This module is backend-free: importing it touches neither torch nor CUDA.
"""
from __future__ import annotations

import dataclasses
import random
import time


class TransientFault(RuntimeError):
    """An injected failure the retry/degradation machinery should absorb.

    ``kind`` ∈ {'evicted', 'oom', 'device_lost'}: a program/runner-cache
    eviction race (retryable at the same batch width — the rebuild
    succeeds), a simulated device OOM on an over-wide batch (retry at
    the same width keeps failing; the ladder must *narrow* the batch
    instead), or a device dropping out of the mesh mid-campaign (the
    runner must restore elastically onto a smaller mesh).
    """

    def __init__(self, kind: str, detail: str = ""):
        super().__init__(f"injected {kind}" + (f": {detail}" if detail else ""))
        self.kind = kind


# ================================================================== clocks ==
class SimClock:
    """Manually-advanced milliseconds — the deterministic soak clock.
    Backoff sleeps and injected delays advance it; nothing else does."""

    def __init__(self, start_ms: float = 0.0):
        self._now = float(start_ms)

    def now_ms(self) -> float:
        return self._now

    def advance(self, ms: float) -> None:
        if ms > 0:
            self._now += ms


class MonotonicClock:
    """Real clock: ``time.monotonic``; ``advance`` really sleeps
    (backoff must let the transient condition clear)."""

    def now_ms(self) -> float:
        return time.monotonic() * 1e3

    def advance(self, ms: float) -> None:
        if ms > 0:
            time.sleep(ms / 1e3)


# ================================================================== config ==
@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Knobs for :class:`FaultInjector` — all rates are per-event
    probabilities drawn from one RNG seeded with ``seed``; the
    ``*_at_leg`` knobs are explicit leg indices (1-based, matching the
    campaign runner's leg numbering).

    Dispatch-side (consumed by a service core):
      * ``evict_rate`` — before a dispatch, clear ``RUNNER_CACHE`` and
        raise ``TransientFault('evicted')`` once (retry rebuilds).
      * ``oom_batch_limit`` — dispatches wider than this many requests
        raise ``TransientFault('oom')`` *deterministically* (0 disables);
        the ladder must degrade to narrower batches or solo runs.
      * ``delay_ms_range`` — (lo, hi) extra milliseconds a dispatch takes
        (advanced on the service clock), so deadlines can expire while a
        request is in flight.
      * ``nan_output_rate`` — corrupt one output row of a healthy batch
        after compute (tests the guard's batch-mate isolation without a
        poisoned input).

    Traffic-side (consumed by drivers via :meth:`classify_request`):
      * ``nan_input_rate`` — request field arrives NaN-poisoned.
      * ``oversized_rate`` — request shape exceeds the admission cap.
      * ``expired_rate`` — request arrives with an already-spent deadline.

    Campaign-side (consumed by ``repro_torch.resilient.runner``):
      * ``nan_at_leg`` — poison the carry after computing each listed
        leg (a simulated numerical blow-up the health reduction must
        catch).  Transient by default: the injection is consumed, so the
        post-rollback retry of the leg runs clean.
      * ``nan_persistent`` — re-inject on every retry of a listed leg
        too, forcing the bounded retry ladder to exhaust into a typed
        ``CampaignFault`` (the no-hang regression case).
      * ``corrupt_ckpt_at_leg`` — after each listed leg's checkpoint
        lands, flip bytes in its on-disk payload; the store's checksum
        must refuse it at load and fall back to an earlier leg.
      * ``crash_save_at_leg`` — the listed legs' saves die mid-``tmp``
        (files written, atomic rename never happens) — what a SIGKILL
        mid-save leaves on disk; ``latest_leg`` must not see it.
      * ``device_loss_at_leg`` — before dispatching each listed leg of a
        *sharded* campaign, raise ``TransientFault('device_lost')``;
        the runner must restore elastically onto a smaller mesh (one
        loss per listed leg — consumed, like ``nan_at_leg``).
    """

    seed: int = 0
    evict_rate: float = 0.0
    oom_batch_limit: int = 0
    delay_ms_range: tuple = (0, 0)
    nan_output_rate: float = 0.0
    nan_input_rate: float = 0.0
    oversized_rate: float = 0.0
    expired_rate: float = 0.0
    nan_at_leg: tuple = ()
    nan_persistent: bool = False
    corrupt_ckpt_at_leg: tuple = ()
    crash_save_at_leg: tuple = ()
    device_loss_at_leg: tuple = ()


HEALTHY = "healthy"
TRAFFIC_KINDS = ("nan_input", "oversized", "expired")
CAMPAIGN_KINDS = ("nan_leg", "corrupt_ckpt", "crash_save", "device_lost")


class FaultInjector:
    """The seeded fault source; one instance per service/campaign run.

        inj = FaultInjector(FaultConfig(seed=3, evict_rate=0.5))
        inj.should_evict(), inj.should_evict()   # deterministic sequence
    """

    def __init__(self, config: FaultConfig | None = None):
        self.config = config or FaultConfig()
        self._rng = random.Random(self.config.seed)
        self.injected: dict = {"evicted": 0, "oom": 0, "delay_ms": 0,
                               "nan_output": 0, "nan_input": 0,
                               "oversized": 0, "expired": 0,
                               "nan_leg": 0, "corrupt_ckpt": 0,
                               "crash_save": 0, "device_lost": 0}
        # one-shot campaign injections: consumed the first time they fire
        # (unless pinned persistent), so the retry-after-rollback path is
        # exercised against a now-clean leg
        self._nan_pending = set(self.config.nan_at_leg)
        self._loss_pending = set(self.config.device_loss_at_leg)

    # ------------------------------------------------- dispatch hooks ----
    def should_evict(self) -> bool:
        """Roll the eviction-race die (counted when it comes up)."""
        hit = self._rng.random() < self.config.evict_rate
        if hit:
            self.injected["evicted"] += 1
        return hit

    def should_oom(self, batch_width: int) -> bool:
        """True when ``batch_width`` exceeds the configured OOM limit —
        deterministic, so retries at the same width keep failing and the
        ladder is forced to narrow."""
        limit = self.config.oom_batch_limit
        hit = bool(limit) and batch_width > limit
        if hit:
            self.injected["oom"] += 1
        return hit

    def dispatch_delay_ms(self) -> float:
        """Extra service time for this dispatch, in ms (0 when disabled)."""
        lo, hi = self.config.delay_ms_range
        if hi <= 0:
            return 0.0
        d = self._rng.uniform(lo, hi)
        self.injected["delay_ms"] += d
        return d

    def corrupt_output_row(self, batch_width: int) -> int | None:
        """Index of a batch row to NaN-poison post-compute, or None."""
        if self._rng.random() < self.config.nan_output_rate:
            self.injected["nan_output"] += 1
            return self._rng.randrange(batch_width)
        return None

    # -------------------------------------------------- traffic hooks ----
    def classify_request(self) -> str:
        """Draw the kind of the next synthetic request: ``'healthy'`` or
        one of ``TRAFFIC_KINDS`` — drivers shape the request to match."""
        r = self._rng.random()
        cfg = self.config
        edges = (("nan_input", cfg.nan_input_rate),
                 ("oversized", cfg.oversized_rate),
                 ("expired", cfg.expired_rate))
        acc = 0.0
        for kind, rate in edges:
            acc += rate
            if r < acc:
                self.injected[kind] += 1
                return kind
        return HEALTHY

    # ------------------------------------------------- campaign hooks ----
    def poison_leg(self, leg: int) -> bool:
        """True when leg ``leg``'s carry should be NaN-poisoned.  One
        shot per listed leg unless ``nan_persistent`` — the retry after
        rollback then sees a clean run of the same leg."""
        if self.config.nan_persistent:
            hit = leg in self.config.nan_at_leg
        else:
            hit = leg in self._nan_pending
            if hit:
                self._nan_pending.discard(leg)
        if hit:
            self.injected["nan_leg"] += 1
        return hit

    def lose_device(self, leg: int) -> bool:
        """True when a device should drop before dispatching ``leg`` of a
        sharded campaign (one loss per listed leg, consumed)."""
        hit = leg in self._loss_pending
        if hit:
            self._loss_pending.discard(leg)
            self.injected["device_lost"] += 1
        return hit

    def checkpoint_sabotage(self, leg: int) -> str | None:
        """What to do to leg ``leg``'s checkpoint on disk: ``'corrupt'``
        (flip payload bytes after the rename), ``'crash'`` (abandon the
        ``tmp`` dir before the rename — a mid-save SIGKILL), or None."""
        if leg in self.config.crash_save_at_leg:
            self.injected["crash_save"] += 1
            return "crash"
        if leg in self.config.corrupt_ckpt_at_leg:
            self.injected["corrupt_ckpt"] += 1
            return "corrupt"
        return None

    def stats(self) -> dict:
        """Counters of everything injected so far (reported by drivers so
        a soak's fault mix is visible next to its outcome mix)."""
        out = dict(self.injected)
        out["delay_ms"] = round(out["delay_ms"], 3)
        return out

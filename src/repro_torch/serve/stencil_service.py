"""Stencil-as-a-service: a hardened async batching front door (the port's
counterpart of ``repro.serve.stencil_service``).

The compile side ends at :class:`~repro_torch.api.program.StencilProgram`.
``StencilService`` puts a defense-in-depth request path in front of it,
built around the batching win — concurrent requests for the same stencil
are coalesced into ONE ``StencilProgram.run_batched`` dispatch, which on
the card is one kernel launch a sweep for the whole batch, the serving
analogue of the paper's amortize-everything-over-the-tile scheme (one
launch amortizes launch + plan cost across requests the way a temporal
block amortizes a tile load across steps).

The request path, outside-in (the reference's contract, DESIGN.md §13):

  1. **Admission control** — a bounded queue and per-tenant in-flight
     caps; over-limit submissions resolve immediately to a typed
     :class:`Rejected` (``reason='queue_full' | 'tenant_cap' |
     'oversized'``), never an unbounded backlog.  Shape/dtype/steps/
     boundary validation happens HERE, before coalescing, so a
     malformed request can never poison a batch: it resolves alone to
     :class:`InvalidRequest`.
  2. **Coalescing** — admitted requests are grouped by *shape bucket*:
     ``(spec.signature, shape, dtype, boundary, sweep depth, T)``.  A
     bucket dispatches when its oldest request has waited
     ``batch_window_ms`` or ``max_batch`` requests are ready.  The batch
     axis is padded up to the next configured width (powers of two by
     default) so the batched runner is built once per width, not once
     per arrival count; pad rows are discarded.  Spatial shapes are
     grouped *exactly*, never padded: embedding a zero-Dirichlet domain
     in a larger one changes its semantics (the boundary pins cells to
     zero every step; pad cells would evolve and feed back), so the
     service refuses silent corruption and batches only true shape
     twins — the §13.2 decision.
  3. **Deadlines** — ``deadline_ms`` is checked at admission (an
     already-expired request resolves to :class:`Expired` without
     queueing), at batch formation (expired requests are dropped from
     the batch instead of dispatched), and post-dispatch (a result that
     arrives late resolves to ``Expired`` rather than pretending the
     deadline held).
  4. **Dispatch, retry, and the degradation ladder** — transient
     failures (a program-cache eviction race — classified by consuming
     the ``ProgramCache`` eviction counters — or an injected fault)
     retry with exponential backoff + seeded jitter; a failure that
     persists degrades instead of erroring: full bucket batch → split
     halves (narrower widths) → unbatched ``StencilProgram.run`` per
     request → typed :class:`ServiceFault`.  Every rung is bounded;
     there is no path that hangs.
  5. **Poison isolation** — a configurable NaN/Inf output guard
     (``guard='reject' | 'propagate' | 'retry_solo'``) checks each
     request's own output row.  Batch rows are independent (each field
     of the batch is its own slab of the kernel's grid), so one NaN
     input never contaminates batch-mates; ``retry_solo``
     additionally re-runs a non-finite row alone to distinguish "my
     input was poison" (:class:`PoisonedOutput`) from "my batch was"
     (solo result returned).

Determinism: the core is **sans-io** — :class:`ServiceCore` is driven by
an injectable clock (:class:`SimClock` for tests/soaks — backoff, batch
windows and injected delays advance simulated time; :class:`MonotonicClock`
for real serving) and all jitter/fault randomness is seeded.  The asyncio
wrapper :class:`StencilService` runs the same core on the real clock with
dispatches on worker threads (hence the thread-safe ``ProgramCache``);
each dispatch makes the program's card the thread's current CUDA device,
and the kernels' launch counters are bumped under a lock, so they stay
exact with two threads dispatching at once.

Programs are compiled on ``ServiceConfig.device`` (``None``: the card;
``"cpu"``: the plain version); a request's field (a numpy array or a
tensor) moves to the program's device at dispatch, and results are
tensors on that device.

    svc = StencilService(ServiceConfig(max_batch=8))
    await svc.start()
    y = await svc.submit(ServeRequest(spec, x, total_t=16))
    await svc.stop()
    svc.stats()["p99_latency_ms"]

Synchronous/simulated use (the soak test and CLI driver):

    core = ServiceCore(ServiceConfig(), clock=SimClock())
    tk = core.submit(ServeRequest(spec, x, total_t=8))
    core.drain()                  # advances the sim clock past windows
    y = tk.result()               # value, or raises the typed error

Where a request's time goes.  Each ticket is stamped on the service
clock at admission (``admitted_ms``), at the start of the dispatch that
runs it (``dispatched_ms``) and at resolution (``latency_ms`` after
admission).  ``counters["dispatched"]`` counts the requests handed to a
dispatch, once however the ladder splits them, and
``counters["queue_wait_ms"]`` sums their waits from admission to that
dispatch's start: the mean wait in a bucket, and behind other buckets'
dispatches, is their quotient.  ``stats()``'s latency percentiles
cover the most recent :data:`LATENCY_WINDOW` resolutions;
``stats()["resolved"]`` and the rate count every one.  Under
``torch.profiler`` the core opens spans (``core/spans.py``; nothing is
recorded, and next to nothing paid, without a profiler):

  * ``repro_torch.serve.admit`` -- a submission: admission checks and
    the program lookup (``compile_stencil``);
  * ``repro_torch.serve.form`` -- batch formation under the lock, with
    the expiries it resolves;
  * ``repro_torch.serve.dispatch`` -- one batch down the ladder, end to
    end; inside it ``repro_torch.serve.stack`` (the fields moved and
    stacked with their pad rows), the program's ``repro_torch.chain.*``
    and ``repro_torch.launch.*`` spans, ``repro_torch.serve.guard`` (the
    finiteness check), ``repro_torch.serve.sync`` (reading its verdict
    alone: the host blocked on the card) and
    ``repro_torch.serve.resolve`` (the tickets resolved, their
    ``on_done`` callbacks included);
  * ``repro_torch.serve.solo`` -- an unbatched ``.run`` rung, or the
    guard's ``retry_solo`` re-run; ``repro_torch.serve.backoff`` -- a
    retry's wait.

Capture them with the card's operations on one clock::

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as p:
        while core.pending():
            core.pump()
    p.export_chrome_trace("serve.json")
"""
from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import itertools
import math
import random
import threading
from collections import Counter

import numpy as np
import torch

from repro_torch.api.boundary import ZERO, Boundary
from repro_torch.api.program import RUNNER_CACHE, compile_stencil
from repro_torch.core.spans import span
from repro_torch.core.stencil_spec import StencilSpec
from repro_torch.faults import (FaultInjector, MonotonicClock, SimClock,
                                TransientFault)

GUARDS = ("reject", "propagate", "retry_solo")
LATENCY_WINDOW = 4096        # resolutions ``stats()``'s percentiles cover


# ============================================================ typed errors ==
class ServeError(Exception):
    """Base of every typed request outcome that is not a result.

    Each carries a machine-readable ``reason``; the service resolves
    EVERY admitted request to either a value or exactly one of these —
    an unhandled exception escaping the request path is a bug (the soak
    test's core assertion).
    """

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class Rejected(ServeError):
    """Admission control said no: ``queue_full`` (bounded queue at
    capacity), ``tenant_cap`` (per-tenant in-flight limit), or
    ``oversized`` (domain exceeds ``max_cells``).  Backpressure, not
    failure — the client should shed or retry later."""


class InvalidRequest(ServeError):
    """The request can never succeed as posed (wrong rank, non-floating
    dtype, T out of bounds, boundary incompatible with the spec, ...).
    Resolved before coalescing so it fails alone."""


class Expired(ServeError):
    """The deadline passed; ``stage`` says where it was caught:
    ``admission`` | ``batch_formation`` | ``post_dispatch``."""

    def __init__(self, stage: str):
        super().__init__(f"deadline expired at {stage}")
        self.stage = stage


class PoisonedOutput(ServeError):
    """The request's own output is non-finite under ``guard='reject'``
    or after a ``retry_solo`` re-run confirmed the poison is the
    request's, not the batch's."""


class ServiceFault(ServeError):
    """Dispatch failed after the whole retry/degradation ladder — the
    typed bottom rung, in place of a hang or a raw traceback."""


# ================================================================= request ==
@dataclasses.dataclass
class ServeRequest:
    """One unit of work: run ``spec`` on field ``x`` for ``total_t``
    steps.  ``deadline_ms`` is relative to admission; ``t`` pins the
    sweep depth (default: the program's §6 plan depth)."""

    spec: StencilSpec
    x: object                      # tensor or numpy, shape == spec.ndim rank
    total_t: int
    tenant: str = "default"
    boundary: Boundary | None = None
    deadline_ms: float | None = None
    t: int | None = None


_ids = itertools.count()


class Ticket:
    """The resolution handle for one admitted (or admission-refused)
    request: exactly one of ``value``/``error`` is set when ``done``."""

    def __init__(self, request: ServeRequest, admitted_ms: float, on_done=None):
        self.id = next(_ids)
        self.request = request
        self.admitted_ms = admitted_ms
        self.deadline_at = (None if request.deadline_ms is None
                            else admitted_ms + request.deadline_ms)
        self.value = None
        self.error: ServeError | None = None
        self.done = False
        self.latency_ms: float | None = None
        self.dispatched_ms: float | None = None  # its dispatch's start
        self.batched_width: int | None = None   # how it was dispatched
        self._on_done = on_done

    def result(self):
        """The request's value; raises its typed ``ServeError`` instead
        when the request did not produce one."""
        if not self.done:
            raise RuntimeError(f"ticket {self.id} not resolved yet")
        if self.error is not None:
            raise self.error
        return self.value

    @property
    def ok(self) -> bool:
        return self.done and self.error is None

    def expired(self, now_ms: float) -> bool:
        return self.deadline_at is not None and now_ms > self.deadline_at


# ================================================================== config ==
@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """The service's defense-in-depth knobs (the reference's semantics).

    ``guard`` is the NaN/Inf output policy; ``batch_widths`` (derived
    when None) are the padded batch sizes the batched runner is built
    for; ``seed`` feeds the backoff jitter RNG (determinism: results
    never depend on wall clock or unseeded randomness).  ``device`` is
    where programs compile and run: ``None`` the card, ``"cpu"`` the
    plain version (the reference's ``interpret`` flag).  ``max_cells``
    keeps the reference's default, below the paper's domains: a deployment
    serving those raises it."""

    max_queue: int = 128
    max_inflight_per_tenant: int = 16
    batch_window_ms: float = 2.0
    max_batch: int = 8
    batch_widths: tuple | None = None
    guard: str = "retry_solo"
    max_retries: int = 2
    backoff_base_ms: float = 1.0
    backoff_factor: float = 2.0
    backoff_jitter_ms: float = 0.5
    max_cells: int = 1 << 22
    max_steps: int = 4096
    default_deadline_ms: float | None = None
    device: str | None = None
    seed: int = 0

    def __post_init__(self):
        if self.guard not in GUARDS:
            raise ValueError(f"guard must be one of {GUARDS}, "
                             f"got {self.guard!r}")
        if self.max_batch < 1 or self.max_queue < 1:
            raise ValueError("max_batch and max_queue must be >= 1")

    def widths(self) -> tuple:
        """Padded batch widths, ascending: powers of two capped at (and
        always including) ``max_batch``."""
        if self.batch_widths is not None:
            return tuple(sorted(set(self.batch_widths)))
        out = {self.max_batch}
        w = 1
        while w < self.max_batch:
            out.add(w)
            w *= 2
        return tuple(sorted(out))


class _Fallthrough(Exception):
    """Internal: this rung of the ladder gave up; try the next one."""


def _is_floating(dt) -> bool:
    if isinstance(dt, torch.dtype):
        return dt.is_floating_point
    try:
        return bool(np.issubdtype(np.dtype(dt), np.floating))
    except TypeError:
        return False


def _torch_dtype(dt) -> torch.dtype:
    """A field's dtype as torch's (numpy fields carry numpy's)."""
    if isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.zeros((), dtype=dt)).dtype


def _field(x, device: torch.device) -> torch.Tensor:
    """A request's field as a tensor on the program's device."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _on_device(device: torch.device):
    """The program's card as the current CUDA device of this thread (the
    asyncio front door dispatches on worker threads)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


@dataclasses.dataclass
class _Batch:
    program: object
    total_t: int
    tickets: list


# ==================================================================== core ==
class ServiceCore:
    """The sans-io engine: admission, coalescing, dispatch, resolution —
    synchronous, clock-injected, thread-safe.  :class:`StencilService`
    wraps it in asyncio; tests and the CLI drive it directly."""

    def __init__(self, config: ServiceConfig | None = None, *,
                 clock=None, faults: FaultInjector | None = None,
                 compile_fn=compile_stencil):
        self.config = config or ServiceConfig()
        self.clock = clock or MonotonicClock()
        self.faults = faults
        self._compile = compile_fn
        self._jitter = random.Random(self.config.seed)
        self._lock = threading.RLock()
        self._buckets: dict = {}            # key -> list[Ticket]
        self._programs: dict = {}           # key -> (program, total_t)
        self._tenant_inflight: Counter = Counter()
        self.counters: Counter = Counter()
        self._latencies_ms = collections.deque(maxlen=LATENCY_WINDOW)
        self._resolved = 0
        self._first_admit_ms: float | None = None
        self._last_resolve_ms: float | None = None

    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    # --------------------------------------------------------- admission ----
    def submit(self, request: ServeRequest, on_done=None) -> Ticket:
        """Admit (or refuse) one request.  Always returns a ticket; an
        admission refusal resolves it immediately with the typed error,
        so the caller never blocks on a request that was never queued."""
        with span("repro_torch.serve.admit"):
            now = self.clock.now_ms()
            if (request.deadline_ms is None
                    and self.config.default_deadline_ms is not None):
                request = dataclasses.replace(
                    request, deadline_ms=self.config.default_deadline_ms)
            tk = Ticket(request, now, on_done)
            err = self._admission_error(request, now)
            if err is not None:
                self._resolve(tk, error=err, count_admit=False)
                return tk
            key, prog = self._program_for(request)
            if isinstance(prog, ServeError):
                self._resolve(tk, error=prog, count_admit=False)
                return tk
            with self._lock:
                self.counters["admitted"] += 1
                self._tenant_inflight[request.tenant] += 1
                if self._first_admit_ms is None:
                    self._first_admit_ms = now
                self._programs[key] = (prog, request.total_t)
                self._buckets.setdefault(key, []).append(tk)
            return tk

    def _admission_error(self, request: ServeRequest,
                         now: float) -> ServeError | None:
        cfg = self.config
        with self._lock:
            queued = sum(len(b) for b in self._buckets.values())
            inflight = self._tenant_inflight[request.tenant]
        if queued >= cfg.max_queue:
            self._count("rejected_queue_full")
            return Rejected("queue_full")
        if inflight >= cfg.max_inflight_per_tenant:
            self._count("rejected_tenant_cap")
            return Rejected("tenant_cap")
        if not isinstance(request.spec, StencilSpec):
            self._count("invalid")
            return InvalidRequest(f"spec must be a StencilSpec, got "
                                  f"{type(request.spec).__name__}")
        shape = tuple(getattr(request.x, "shape", ()))
        if len(shape) != request.spec.ndim:
            self._count("invalid")
            return InvalidRequest(
                f"{request.spec.name} is {request.spec.ndim}-D; "
                f"got a rank-{len(shape)} field {shape}")
        if math.prod(shape) > cfg.max_cells:
            self._count("rejected_oversized")
            return Rejected("oversized")
        if not (0 <= request.total_t <= cfg.max_steps):
            self._count("invalid")
            return InvalidRequest(f"total_t must be in [0, {cfg.max_steps}], "
                                  f"got {request.total_t}")
        dt = getattr(request.x, "dtype", None)
        if dt is None or not _is_floating(dt):
            self._count("invalid")
            return InvalidRequest(f"field dtype must be floating, got {dt}")
        if request.deadline_ms is not None and request.deadline_ms <= 0:
            self._count("expired_admission")
            return Expired("admission")
        return None

    def _program_for(self, request: ServeRequest):
        """Shape-bucket key + compiled program; compile errors become a
        per-request :class:`InvalidRequest` (they fail alone, pre-batch)."""
        boundary = request.boundary or ZERO
        shape = tuple(int(n) for n in request.x.shape)
        dtype = _torch_dtype(request.x.dtype)
        key = (request.spec.signature, shape, dtype, boundary,
               request.t, request.total_t)
        try:
            prog = self._compile(request.spec, shape, dtype=dtype,
                                 t=request.t, boundary=boundary,
                                 device=self.config.device)
        except Exception as e:  # noqa: BLE001 — typed, never batch-fatal
            self._count("invalid")
            return key, InvalidRequest(f"compile failed: {e}")
        return key, prog

    # -------------------------------------------------------- coalescing ----
    @staticmethod
    def _round_robin(tickets: list) -> list:
        """Batch-formation order: tenants interleaved round-robin
        (first-appearance tenant order, oldest-first within a tenant),
        so a burst from one tenant cannot push every other tenant's
        requests out of the next ``max_batch`` slots — under contention
        each waiting tenant lands at least one request per formed batch.
        Deterministic: arrival order decides both orderings.  With a
        single tenant this is exactly the old FIFO."""
        by_tenant: dict = {}
        for tk in tickets:
            by_tenant.setdefault(tk.request.tenant, []).append(tk)
        if len(by_tenant) <= 1:
            return list(tickets)
        out, queues = [], list(by_tenant.values())
        while queues:
            still = []
            for q in queues:
                out.append(q.pop(0))
                if q:
                    still.append(q)
            queues = still
        return out

    def poll(self, force: bool = False) -> list:
        """Form due batches: a bucket dispatches when full
        (``max_batch``) or its oldest request has waited out the batch
        window (or ``force``, at drain).  Batch slots are filled in
        per-tenant round-robin order (:meth:`_round_robin`), so no
        tenant starves behind another tenant's burst.  Expired requests
        are resolved ``Expired('batch_formation')`` here — dropped from
        the batch instead of dispatched."""
        with span("repro_torch.serve.form"):
            now = self.clock.now_ms()
            cfg = self.config

            def due(tickets) -> bool:
                return bool(tickets) and (
                    force or len(tickets) >= cfg.max_batch
                    or now - min(tk.admitted_ms for tk in tickets)
                    >= cfg.batch_window_ms)

            batches, expired = [], []
            with self._lock:
                for key, tickets in self._buckets.items():
                    prog, total_t = self._programs[key]
                    while due(tickets):
                        ordered = self._round_robin(tickets)
                        taken, tickets[:] = (ordered[:cfg.max_batch],
                                             ordered[cfg.max_batch:])
                        if len({tk.request.tenant for tk in taken}) > 1:
                            self.counters["multi_tenant_batches"] += 1
                        live = []
                        for tk in taken:
                            (expired if tk.expired(now) else live).append(tk)
                        if live:
                            batches.append(_Batch(prog, total_t, live))
                for key in [k for k, v in self._buckets.items() if not v]:
                    del self._buckets[key]
            for tk in expired:
                self._count("expired_batch_formation")
                self._resolve(tk, error=Expired("batch_formation"))
            return batches

    def pending(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._buckets.values())

    # ---------------------------------------------------------- dispatch ----
    def dispatch(self, batch: _Batch) -> None:
        """Run one formed batch down the ladder, with the program's card
        as the thread's current device.  Defensive outer rim: whatever
        happens inside, every ticket resolves."""
        with span("repro_torch.serve.dispatch"):
            try:
                now = self.clock.now_ms()
                with self._lock:
                    self.counters["batches"] += 1
                    self.counters["dispatched"] += len(batch.tickets)
                    for tk in batch.tickets:
                        tk.dispatched_ms = now
                        self.counters["queue_wait_ms"] += now - tk.admitted_ms
                with _on_device(batch.program.device):
                    self._ladder(batch.program, batch.total_t,
                                 batch.tickets)
            except Exception as e:  # noqa: BLE001 — the no-hang guarantee
                for tk in batch.tickets:
                    if not tk.done:
                        self._resolve(tk, error=ServiceFault(
                            f"internal dispatch error: {e!r}"))

    def pump(self) -> int:
        """poll + dispatch inline (the synchronous driver loop); returns
        the number of batches dispatched."""
        batches = self.poll()
        for b in batches:
            self.dispatch(b)
        return len(batches)

    def drain(self) -> None:
        """Resolve everything still queued: advance past the batch
        window (sim clocks) and force-flush the buckets."""
        while self.pending():
            self.clock.advance(self.config.batch_window_ms)
            for b in self.poll(force=True):
                self.dispatch(b)

    # the degradation ladder: batch -> halves -> solo -> typed error
    def _ladder(self, prog, total_t: int, tickets: list) -> None:
        tickets = [tk for tk in tickets if not tk.done]
        if not tickets:
            return
        if len(tickets) == 1:
            self._solo(prog, total_t, tickets[0])
            return
        try:
            ys = self._attempt_batched(prog, total_t, tickets)
        except _Fallthrough:
            self._count("ladder_splits")
            mid = (len(tickets) + 1) // 2
            self._ladder(prog, total_t, tickets[:mid])
            self._ladder(prog, total_t, tickets[mid:])
            return
        # one fused finiteness reduction + one host sync for the whole
        # batch — a per-row ``isfinite(y).all()`` costs a device round
        # trip per request and eats the coalescing win it guards.  A row
        # is finite iff its min and max are (both propagate NaN): one
        # read of the rows, where ``isfinite(...).all`` also writes and
        # re-reads a mask as large as a quarter of them
        with span("repro_torch.serve.guard"):
            lo, hi = torch.aminmax(
                ys[:len(tickets)].reshape(len(tickets), -1), dim=1)
            finite = lo.isfinite() & hi.isfinite()
        with span("repro_torch.serve.sync"):
            finite = finite.tolist()
        with span("repro_torch.serve.resolve"):
            for i, tk in enumerate(tickets):
                self._guard_resolve(tk, ys[i], prog, total_t,
                                    width=len(tickets), finite=finite[i])

    def _attempt_batched(self, prog, total_t: int, tickets: list):
        """One ladder rung: the padded batched dispatch with bounded
        retry-on-transient.  Raises :class:`_Fallthrough` when this
        width is not going to work."""
        width = next(w for w in self.config.widths()
                     if w >= len(tickets))
        pad = width - len(tickets)
        self._count("pad_rows", pad)
        with span("repro_torch.serve.stack"):
            rows = [_field(tk.request.x, prog.device) for tk in tickets]
            xs = torch.stack(rows + rows[:1] * pad)
        evict_mark = RUNNER_CACHE.evictions
        for attempt in range(self.config.max_retries + 1):
            try:
                self._inject_dispatch_faults(width)
                ys = prog.run_batched(xs, total_t)
                return self._maybe_corrupt(ys, len(tickets))
            except TransientFault as e:
                self._count(f"transient_{e.kind}")
                if e.kind == "oom":
                    # deterministic at this width: narrowing is the fix,
                    # not retrying
                    raise _Fallthrough from e
                self._backoff(attempt)
            except Exception as e:  # noqa: BLE001
                # consume the cache eviction counters: a concurrent
                # eviction between runner lookup and call is transient
                now_evict = RUNNER_CACHE.evictions
                if now_evict > evict_mark and attempt < self.config.max_retries:
                    evict_mark = now_evict
                    self._count("transient_evicted")
                    self._backoff(attempt)
                    continue
                raise _Fallthrough from e
        raise _Fallthrough                    # retries exhausted

    def _solo(self, prog, total_t: int, tk: Ticket) -> None:
        """Bottom compute rung: unbatched ``.run`` with bounded retries;
        a persistent failure resolves the typed :class:`ServiceFault`."""
        with span("repro_torch.serve.solo"):
            self._count("solo_dispatches")
            for attempt in range(self.config.max_retries + 1):
                try:
                    self._inject_dispatch_faults(1)
                    y = prog.run(_field(tk.request.x, prog.device), total_t)
                    with span("repro_torch.serve.resolve"):
                        self._guard_resolve(tk, y, prog, total_t, width=1)
                    return
                except TransientFault as e:
                    self._count(f"transient_{e.kind}")
                    self._backoff(attempt)
                except Exception as e:  # noqa: BLE001
                    self._resolve(tk, error=ServiceFault(
                        f"solo dispatch failed: {e}"))
                    return
            self._resolve(tk, error=ServiceFault(
                f"retries exhausted after {self.config.max_retries + 1} "
                "transient failures"))

    def _inject_dispatch_faults(self, width: int) -> None:
        if self.faults is None:
            return
        delay = self.faults.dispatch_delay_ms()
        if delay:
            self.clock.advance(delay)
        if self.faults.should_evict():
            RUNNER_CACHE.clear()              # the real eviction race
            raise TransientFault("evicted", "runner cache cleared mid-flight")
        if self.faults.should_oom(width):
            raise TransientFault("oom", f"batch width {width}")

    def _maybe_corrupt(self, ys, n: int):
        if self.faults is None:
            return ys
        row = self.faults.corrupt_output_row(n)
        if row is not None and row < n:
            ys = ys.clone()
            ys[row] = float("nan")
        return ys

    def _backoff(self, attempt: int) -> None:
        cfg = self.config
        ms = (cfg.backoff_base_ms * cfg.backoff_factor ** attempt
              + self._jitter.uniform(0, cfg.backoff_jitter_ms))
        self._count("retries")
        with span("repro_torch.serve.backoff"):
            self.clock.advance(ms)

    # -------------------------------------------------- guard / resolve ----
    def _guard_resolve(self, tk: Ticket, y, prog, total_t: int, *,
                       width: int, solo_retry_done: bool = False,
                       finite: bool | None = None) -> None:
        """Post-dispatch rim: late results expire; non-finite outputs go
        through the configured guard; everything else resolves clean.
        ``finite`` carries a precomputed per-row verdict from the batched
        path's fused reduction; solo paths leave it ``None`` and check
        their single row here."""
        if tk.done:
            return
        if tk.expired(self.clock.now_ms()):
            self._count("expired_post_dispatch")
            self._resolve(tk, error=Expired("post_dispatch"))
            return
        if finite is None:
            with span("repro_torch.serve.guard"):
                finite = torch.isfinite(y).all()
            with span("repro_torch.serve.sync"):
                finite = bool(finite)
        if finite:
            tk.batched_width = width
            self._resolve(tk, value=y)
            return
        guard = self.config.guard
        self._count("nonfinite_outputs")
        if guard == "propagate":
            tk.batched_width = width
            self._resolve(tk, value=y)
        elif guard == "reject" or solo_retry_done:
            self._count("poisoned")
            self._resolve(tk, error=PoisonedOutput(
                "non-finite output" + (" (confirmed solo)"
                                       if solo_retry_done else "")))
        else:                                  # retry_solo: isolate blame
            self._count("guard_solo_retries")
            try:
                with span("repro_torch.serve.solo"):
                    y2 = prog.run(_field(tk.request.x, prog.device),
                                  total_t)
            except Exception as e:  # noqa: BLE001
                self._resolve(tk, error=ServiceFault(
                    f"guard solo retry failed: {e}"))
                return
            self._guard_resolve(tk, y2, prog, total_t, width=1,
                                solo_retry_done=True)

    def _resolve(self, tk: Ticket, value=None, error: ServeError | None = None,
                 count_admit: bool = True) -> None:
        now = self.clock.now_ms()
        with self._lock:
            if tk.done:
                return
            tk.value = value
            tk.error = error
            tk.done = True
            tk.latency_ms = now - tk.admitted_ms
            self._last_resolve_ms = now
            if count_admit:
                self._tenant_inflight[tk.request.tenant] -= 1
                self._latencies_ms.append(tk.latency_ms)
                self._resolved += 1
                self.counters["completed" if error is None
                              else "errored"] += 1
        if tk._on_done is not None:
            tk._on_done(tk)

    # --------------------------------------------------------------- stats --
    def stats(self) -> dict:
        """The service's health report: outcome counters, latency
        percentiles (service clock) over the most recent
        :data:`LATENCY_WINDOW` resolutions, throughput since the first
        admission, cache and fault-injector counters —
        ``launch/serve_stencil.py`` prints this verbatim."""
        with self._lock:
            lat = sorted(self._latencies_ms)
            out = dict(self.counters)
            out["pending"] = sum(len(b) for b in self._buckets.values())
            out["resolved"] = self._resolved
            if lat:
                out["p50_latency_ms"] = round(lat[len(lat) // 2], 3)
                out["p99_latency_ms"] = round(
                    lat[min(len(lat) - 1, int(len(lat) * 0.99))], 3)
                elapsed_ms = ((self._last_resolve_ms or 0)
                              - (self._first_admit_ms or 0))
                if elapsed_ms > 0:
                    out["requests_per_sec"] = round(
                        self._resolved / (elapsed_ms / 1e3), 2)
            out["runner_cache"] = RUNNER_CACHE.stats()
            if self.faults is not None:
                out["faults_injected"] = self.faults.stats()
            return out


# ============================================================ async front ==
class StencilService:
    """The asyncio front door over :class:`ServiceCore`: admission on the
    event loop, batch dispatch on worker threads (the default executor),
    one pump task forming batches on the real clock.

        svc = StencilService()
        await svc.start()
        try:
            y = await svc.submit(ServeRequest(spec, x, total_t=8))
        except Rejected as e:       # typed backpressure
            ...
        finally:
            await svc.stop()        # drains: every ticket resolves
    """

    def __init__(self, config: ServiceConfig | None = None, *,
                 faults: FaultInjector | None = None):
        self.core = ServiceCore(config, clock=MonotonicClock(),
                                faults=faults)
        self._pump_task = None
        self._dispatches: set = set()
        self._stopping = False

    async def start(self) -> None:
        self._stopping = False
        self._pump_task = asyncio.create_task(self._pump_loop())

    async def submit(self, request: ServeRequest):
        """Admit, await resolution, return the value — or raise the
        request's typed :class:`ServeError`."""
        loop = asyncio.get_running_loop()
        done = asyncio.Event()
        tk = self.core.submit(
            request,
            on_done=lambda _tk: loop.call_soon_threadsafe(done.set))
        if not tk.done:                      # admission refusals are sync
            await done.wait()
        return tk.result()

    async def _pump_loop(self) -> None:
        loop = asyncio.get_running_loop()
        tick_s = max(self.core.config.batch_window_ms / 2e3, 5e-4)
        while not self._stopping:
            self._launch(loop, self.core.poll())
            await asyncio.sleep(tick_s)

    def _launch(self, loop, batches) -> None:
        for b in batches:
            fut = loop.run_in_executor(None, self.core.dispatch, b)
            self._dispatches.add(fut)
            fut.add_done_callback(self._dispatches.discard)

    async def stop(self) -> None:
        """Stop pumping and drain: force-flush the buckets, await every
        in-flight dispatch — no admitted request is left unresolved."""
        self._stopping = True
        if self._pump_task is not None:
            await self._pump_task
            self._pump_task = None
        loop = asyncio.get_running_loop()
        self._launch(loop, self.core.poll(force=True))
        while self._dispatches:
            await asyncio.gather(*tuple(self._dispatches),
                                 return_exceptions=True)

    def stats(self) -> dict:
        return self.core.stats()

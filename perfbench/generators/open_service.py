"""Tenants submitting stencil runs to the stencil service in an open loop:
requests on a seeded schedule through ``ServiceCore`` on the real clock,
each timed from its scheduled send time to its result complete on the
card.

Traffic parameters: ``rate_per_s``, ``tenants``, ``steps``,
``domain_scales`` (each served shape as a share of the configuration's
domain), ``pool_per_shape`` (seeded fields a shape), ``service``
(``ServiceConfig``'s fields; ``max_cells`` ``"domain"`` is the largest
served shape) and ``check_per_shape``.

The check compares, against the reference on each request's own field:
every row of one batch of each size the run dispatched at each shape
(drawn from the seed among the batches of that size, so the last row of
every width is judged), and ``check_per_shape`` requests of each shape
drawn from the schedule.  The control is the reference one precision
down in the program's place on those very requests: in the service's
place it would be many times slower than the program, and the service
at the cell's rate would refuse most requests, giving no number.
"""
from __future__ import annotations

import collections
import contextlib
import math
import random
import time

from perfbench.generators import _stencil
from perfbench.trace import Profiler, span
from perfbench.window import Run, no_gc_pauses

CHECKS = ("served_max_abs_err",)
FAULTS = ("unchanged", "altered", "half_batch")


@contextlib.contextmanager
def plant(kind: str | None, cell):
    """The fault ``kind`` under the service's timed path; the control is
    put in place of each answer that the check judges."""
    if kind != "control":
        with _stencil.plant(kind, cell):
            yield
        return
    gap0 = cell.reference.gap

    def control_gap(config, y, **args):
        return gap0(config, cell.reference.control(config, **args), **args)

    cell.reference.gap = control_gap
    try:
        yield
    finally:
        cell.reference.gap = gap0


def open_schedule(traffic: dict, seed: int, seconds: float, n_shapes: int):
    """``[(due_s, tenant, shape_index, pool_index)]`` in due order.

    Every seed gets the same work: ``rate_per_s × seconds`` requests, the
    same multiset of gaps (the exponential distribution's quantiles,
    scaled so the last request is due at ``seconds``), shapes and tenants
    in equal shares; the seed only orders them and picks pool fields."""
    rng = random.Random(seed)
    rate = float(traffic["rate_per_s"])
    n = max(1, round(rate * seconds))
    gaps = [-math.log(1.0 - (j + 0.5) / n) / rate for j in range(n)]
    tenants = [j % int(traffic["tenants"]) for j in range(n)]
    shapes = [j % n_shapes for j in range(n)]
    for seq in (gaps, tenants, shapes):
        rng.shuffle(seq)
    scale = seconds / sum(gaps)
    out, due = [], 0.0
    for gap, tenant, shape in zip(gaps, tenants, shapes):
        due += gap * scale
        out.append((due, tenant, shape,
                    rng.randrange(int(traffic["pool_per_shape"]))))
    return out


def check_sample(schedule, traffic: dict, seed: int, n_shapes: int) -> set:
    """Indices of ``check_per_shape`` requests of each shape, drawn from
    the seed."""
    rng = random.Random(seed ^ 0x5EED)
    picked = set()
    for s in range(n_shapes):
        idx = [i for i, r in enumerate(schedule) if r[2] == s]
        picked.update(rng.sample(idx, min(len(idx),
                                          int(traffic["check_per_shape"]))))
    return picked


class BatchSample:
    """Every row of one batch of each (shape, size), drawn from the seed
    among the batches the run dispatches (a reservoir): :meth:`offer`
    each batch before it is dispatched; :attr:`ids` are the tickets
    whose results are held.  A batch that is replaced drops its results
    (unless ``also_kept`` holds them)."""

    def __init__(self, seed: int, also_kept: set):
        self.rng = random.Random(seed ^ 0xBA7C4)
        self.seen = collections.Counter()
        self.held: dict = {}
        self.ids: set = set()
        self.also_kept = also_kept

    def offer(self, key, tickets) -> None:
        self.seen[key] += 1
        if self.rng.random() * self.seen[key] >= 1.0:
            return
        for old in self.held.get(key, ()):
            self.ids.discard(old.id)
            if old.id not in self.also_kept:
                old.value = None
        self.held[key] = list(tickets)
        self.ids.update(tk.id for tk in tickets)


def served_shapes(traffic: dict, domain) -> list:
    return [tuple(max(1, round(n * s)) for n in domain)
            for s in traffic["domain_scales"]]


def served_inputs(cell):
    """The served shapes, the pool of fields of each (made on the device
    from the seed), the schedule and the indices of the requests drawn
    for the check."""
    tr = cell.traffic
    shapes = served_shapes(tr, cell.domain)
    pools = [cell.field((int(tr["pool_per_shape"]),) + shape).unbind(0)
             for shape in shapes]
    schedule = open_schedule(tr, cell.seed, cell.seconds, len(shapes))
    return shapes, pools, schedule, check_sample(schedule, tr, cell.seed,
                                                 len(shapes))


def run(cell) -> Run:
    from repro_torch.faults import MonotonicClock
    from repro_torch.serve.stencil_service import (Rejected, ServeRequest,
                                                   ServiceConfig,
                                                   ServiceCore)

    tr = cell.traffic
    steps = int(tr["steps"])
    spec = _stencil.spec(cell)
    shapes, pools, schedule, keep = served_inputs(cell)
    cell.sync()
    cell.mark("inputs")
    svc = dict(tr["service"])
    if svc.get("max_cells") == "domain":
        svc["max_cells"] = max(math.prod(s) for s in shapes)
    config = ServiceConfig(**svc, device=str(cell.device))
    tenants = [f"tenant{k}" for k in range(int(tr["tenants"]))]

    def request(shape, pool, tenant):
        return ServeRequest(spec, pools[shape][pool], total_t=steps,
                            tenant=tenants[tenant])

    # warm-up: every batch width the service pads to, at every shape
    warm = ServiceCore(config, clock=MonotonicClock())
    for s in range(len(shapes)):
        for width in config.widths():
            for j in range(width):
                warm.submit(request(s, j % len(pools[s]), j % len(tenants)))
            warm.drain()
    cell.sync()
    cell.mark("warm_up")
    del warm

    core = ServiceCore(config, clock=MonotonicClock())
    done_at, shape_of, kept_ids = {}, {}, set()
    batches_kept = BatchSample(cell.seed, kept_ids)

    def on_done(tk):
        done_at[tk.id] = time.monotonic()
        if tk.id not in kept_ids and tk.id not in batches_kept.ids:
            tk.value = None          # only the checked results are held

    tickets, lateness = [], []
    inflight = collections.deque()
    window = config.batch_window_ms / 1e3
    with no_gc_pauses(), Profiler(cell.trace) as prof:
        t0 = time.monotonic()
        setup_s = time.perf_counter() - cell.started
        due = [t0 + r[0] for r in schedule]
        i = 0
        while True:
            now = time.monotonic()
            while i < len(schedule) and due[i] <= now:
                _, tenant, shape, pool = schedule[i]
                with span("service.submit", cell.trace):
                    tk = core.submit(request(shape, pool, tenant),
                                     on_done=on_done)
                lateness.append((time.monotonic() - due[i]) * 1e3)
                shape_of[tk.id] = shape
                if i in keep:
                    kept_ids.add(tk.id)
                tickets.append(tk)
                inflight.append(tk)
                i += 1
            with span("service.poll", cell.trace):
                batches = core.poll()
            for b in batches:
                # the batch's tickets in the order of its rows
                batches_kept.offer((shape_of[b.tickets[0].id],
                                    len(b.tickets)), b.tickets)
                with span("service.dispatch", cell.trace):
                    core.dispatch(b)
            while inflight and inflight[0].done:
                inflight.popleft()
            if i == len(schedule) and not core.pending():
                break
            if batches:
                continue
            wake = due[i] if i < len(schedule) else math.inf
            if inflight:
                wake = min(wake, inflight[0].admitted_ms / 1e3 + window)
            pause = wake - time.monotonic()
            if pause > 0:
                with span("harness.wait", cell.trace):
                    time.sleep(pause)
        with span("harness.wait", cell.trace):
            cell.sync()
        t1 = time.monotonic()
    close = t0 + schedule[-1][0]
    checked = kept_ids | batches_kept.ids
    latencies, compare, failed, refused = [], [], 0, 0
    for idx, (tk, d) in enumerate(zip(tickets, due)):
        if tk.ok:
            latencies.append((done_at[tk.id] - d) * 1e3)
        else:
            failed += 1
            latencies.append(math.inf)
        if isinstance(tk.error, Rejected):
            refused += 1             # answered "refused": no result to check
        elif tk.id in checked:
            _, _, shape, pool = schedule[idx]
            compare.append(("served_max_abs_err", tk.value,
                            {"x": pools[shape][pool], "steps": steps}))
    return Run(setup_s=setup_s, window_s=t1 - t0, attempted=len(tickets),
               failed=failed, refused=refused, trace=prof.trace,
               counters=dict(core.counters),
               latencies_ms=latencies, lateness_ms=lateness,
               backlog_at_close=sum(1 for tk in tickets
                                    if done_at.get(tk.id, math.inf) > close),
               setup_stages=cell.marks, compare=compare,
               notes={"checked": len(compare),
                      "checked_batches": sorted(batches_kept.held)})

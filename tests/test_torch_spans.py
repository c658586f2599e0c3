"""The port's spans and the service's wait counters (``core/spans.py``,
``serve/stencil_service.py``, ``api/program.py``, the kernel wrappers),
and the benchmark's readers of them (``perfbench/metrics/``).

On the CPU, every program compiled with ``device="cpu"`` (the kernels'
plain versions):

  * with no profiler, ``span`` is one shared no-op and nothing on the
    ``.run`` or service path enters ``record_function``;
  * under ``torch.profiler``, the spans nest as the calls do: inside a
    caller's span, service spans inside ``repro_torch.serve.dispatch``,
    the chain's inside the dispatch, one launch span a sweep inside
    ``repro_torch.chain.run`` -- read back through the benchmark's own
    ``perfbench.trace.read_events``;
  * ``queue_wait_ms``, ``dispatched`` and ``Ticket.dispatched_ms`` are
    exact on ``SimClock``; ``stats()["resolved"]`` stays exact while the
    latency window stays at its bound;
  * the four readers against hand-computed values.
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench import harness, window
from perfbench.trace import WINDOW, Trace, read_events
from repro_torch.api import compile_stencil
from repro_torch.api.program import sweep_schedule
from repro_torch.core import spans
from repro_torch.core import stencil_spec as tspec
from repro_torch.serve import stencil_service
from repro_torch.serve.faults import FaultConfig, FaultInjector
from repro_torch.serve.stencil_service import (ServeRequest, ServiceConfig,
                                               ServiceCore, SimClock)

SERVE_SPANS = ("admit", "form", "dispatch", "stack", "guard", "sync",
               "resolve", "solo", "backoff")
CHAIN_SPANS = ("run", "pad", "crop", "build")


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: torch's default intra-op threads only oversubscribe
    the CPU the other test workers share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def field(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def core(**over) -> ServiceCore:
    faults = over.pop("faults", None)
    cfg = dict(max_batch=4, batch_window_ms=2.0, max_queue=64,
               max_inflight_per_tenant=64, device="cpu")
    cfg.update(over)
    return ServiceCore(ServiceConfig(**cfg), clock=SimClock(), faults=faults)


class OnceFaults:
    """A fault source that evicts the first batched attempt (one retry,
    one backoff) and poisons row 0 of the first batch's output (the
    guard's ``retry_solo`` re-run), then injects nothing."""

    def __init__(self):
        self.evicted = self.poisoned = False

    def dispatch_delay_ms(self) -> float:
        return 0.0

    def should_evict(self) -> bool:
        hit, self.evicted = not self.evicted, True
        return hit

    def should_oom(self, width: int) -> bool:
        return False

    def corrupt_output_row(self, width: int):
        hit, self.poisoned = not self.poisoned, True
        return 0 if hit else None

    def stats(self) -> dict:
        return {}


def traced(fn) -> Trace:
    """Run ``fn`` under the profiler, inside the caller's own span (the
    benchmark's window span), and read the trace back as the benchmark
    does."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            fn()
    return read_events(prof.profiler.kineto_results.events())


def named(trace: Trace, name: str) -> list:
    return [s for s in trace.spans if s[0] == name]


def inside(span, outer: list) -> bool:
    """``span`` lies within one of the ``outer`` spans (one thread, so
    lying within is nesting)."""
    return any(o[1] <= span[1] and span[2] <= o[2] for o in outer)


def drive(svc: ServiceCore, shape_a, shape_b) -> list:
    """Three requests of one shape (a padded batch), one of another (a
    solo rung), then the buckets flushed."""
    spec = tspec.get("j2d5pt")
    tks = [svc.submit(ServeRequest(spec, field(shape_a, seed=i), total_t=3))
           for i in range(3)]
    tks.append(svc.submit(ServeRequest(spec, field(shape_b, seed=9),
                                       total_t=3)))
    svc.clock.advance(svc.config.batch_window_ms)
    svc.pump()
    svc.drain()
    return tks


# ------------------------------------------------------------- the gate ----
def test_span_without_profiler_is_the_shared_noop():
    assert spans.span("repro_torch.x") is spans.span("repro_torch.y")
    assert spans.span("repro_torch.launch.stencil2d t={}", 5) \
        is spans.span("repro_torch.x")
    with spans.span("repro_torch.x"):
        pass


def test_no_record_function_entered_without_profiler(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    spec = tspec.get("j2d5pt")
    prog = compile_stencil(spec, (18, 22), t=3, device="cpu")
    x = torch.from_numpy(field((18, 22)))
    assert torch.isfinite(prog.run(x, 7)).all()
    assert prog.run_batched(torch.stack([x, x]), 4).shape == (2, 18, 22)
    svc = core(faults=OnceFaults())
    tks = drive(svc, (10, 14), (12, 14))
    assert all(tk.ok for tk in tks)
    assert svc.counters["retries"] == 1
    assert svc.counters["guard_solo_retries"] == 1


# ---------------------------------------------------- spans under tracing ----
def test_service_spans_nest_under_the_profiler():
    svc = core(faults=OnceFaults())
    tks = []
    tr = traced(lambda: tks.extend(drive(svc, (10, 18), (12, 18))))
    assert all(tk.ok for tk in tks)
    window_span = named(tr, WINDOW)
    program = [s for s in tr.spans if s[0].startswith("repro_torch.")]
    assert program and all(inside(s, window_span) for s in program)
    for short in SERVE_SPANS:
        assert named(tr, f"repro_torch.serve.{short}"), short
    for short in CHAIN_SPANS:
        assert named(tr, f"repro_torch.chain.{short}"), short
    dispatch = named(tr, "repro_torch.serve.dispatch")
    assert len(dispatch) == svc.counters["batches"] == 2
    for short in ("stack", "guard", "sync", "resolve", "solo", "backoff"):
        for s in named(tr, f"repro_torch.serve.{short}"):
            assert inside(s, dispatch), (short, s)
    # the solo rung's wait on the card is a sync span too
    sync = named(tr, "repro_torch.serve.sync")
    assert any(inside(y, [s]) for s in named(tr, "repro_torch.serve.solo")
               for y in sync)
    chain_run = named(tr, "repro_torch.chain.run")
    for short in CHAIN_SPANS:
        for s in named(tr, f"repro_torch.chain.{short}"):
            assert inside(s, dispatch), (short, s)
    launches = [s for s in program
                if s[0].startswith("repro_torch.launch.stencil2d ")]
    assert launches and all(inside(s, chain_run) for s in launches)
    # the batch of three went out at width 4, once after the retry and
    # once more for the poisoned row's solo re-run
    widths = {s[0].rsplit("batch=", 1)[1] for s in launches}
    assert widths == {"4", "1"}
    for s in named(tr, "repro_torch.serve.admit"):
        assert not inside(s, dispatch)


@pytest.mark.parametrize("name, shape, t, total_t", [
    ("j2d5pt", (26, 20), 3, 10),
    ("j2d5pt", (26, 20), 4, 8),
    ("j3d7pt", (6, 10, 7), 2, 5),
])
def test_run_opens_one_launch_span_a_sweep(name, shape, t, total_t):
    spec = tspec.get(name)
    prog = compile_stencil(spec, shape, t=t, device="cpu")
    x = torch.from_numpy(field(shape))
    tr = traced(lambda: prog.run(x, total_t))
    kernel = f"repro_torch.launch.stencil{len(shape)}d"
    launches = [s for s in tr.spans if s[0].startswith(kernel + " ")]
    schedule = sweep_schedule(total_t, t)
    assert len(launches) == len(schedule)
    chain_run = named(tr, "repro_torch.chain.run")
    assert len(chain_run) == 1
    assert all(inside(s, chain_run) for s in launches)
    depths = sorted(int(re.search(r" t=(\d+) ", s[0]).group(1))
                    for s in launches)
    assert depths == sorted(schedule)
    block = "x".join(str(n) for n in prog.geometry()["block"])
    full = [s for s in launches if f" t={t} " in s[0]]
    assert all(s[0] == f"{kernel} t={t} tile={block} batch=1" for s in full)
    assert len(named(tr, "repro_torch.chain.pad")) == len(
        {d for d in schedule})


# ------------------------------------------------------------- counters ----
def test_queue_wait_and_dispatched_exact_on_simclock():
    svc = core(max_batch=8)
    spec = tspec.get("j2d5pt")
    a = svc.submit(ServeRequest(spec, field((8, 8)), total_t=2))
    svc.clock.advance(1.0)
    b = svc.submit(ServeRequest(spec, field((8, 8), seed=1), total_t=2))
    assert a.dispatched_ms is None
    svc.clock.advance(1.0)
    assert svc.pump() == 1
    assert svc.counters["dispatched"] == 2
    assert svc.counters["queue_wait_ms"] == 3.0
    assert (a.admitted_ms, a.dispatched_ms) == (0.0, 2.0)
    assert (b.admitted_ms, b.dispatched_ms) == (1.0, 2.0)
    stats = svc.stats()
    assert (stats["dispatched"], stats["queue_wait_ms"]) == (2, 3.0)


def test_dispatched_counts_a_request_once_when_the_ladder_splits():
    svc = core(max_batch=4, faults=FaultInjector(FaultConfig(
        seed=0, oom_batch_limit=1)))
    spec = tspec.get("j2d5pt")
    tks = [svc.submit(ServeRequest(spec, field((8, 8), seed=i), total_t=2))
           for i in range(2)]
    svc.clock.advance(0.5)
    tks.append(svc.submit(ServeRequest(spec, field((8, 8), seed=5),
                                       total_t=2)))
    svc.clock.advance(1.5)
    svc.pump()
    assert all(tk.ok for tk in tks)
    assert svc.counters["ladder_splits"] >= 1
    assert svc.counters["batches"] == 1
    assert svc.counters["dispatched"] == 3
    assert svc.counters["queue_wait_ms"] == 2.0 + 2.0 + 1.5
    assert {tk.dispatched_ms for tk in tks} == {2.0}


def test_resolved_stays_exact_past_the_latency_window(monkeypatch):
    monkeypatch.setattr(stencil_service, "LATENCY_WINDOW", 8)
    svc = core(max_batch=4)
    spec = tspec.get("j2d5pt")
    n = 21
    for i in range(n):
        svc.submit(ServeRequest(spec, field((6, 6), seed=i), total_t=1))
        svc.clock.advance(1.0)
        svc.pump()
    svc.drain()
    stats = svc.stats()
    assert stats["resolved"] == n == stats["completed"]
    assert len(svc._latencies_ms) == 8
    recent = sorted(svc._latencies_ms)
    assert stats["p50_latency_ms"] == round(recent[len(recent) // 2], 3)
    assert stats["requests_per_sec"] > 0


# -------------------------------------------------------------- readers ----
def hand_made_run(counters=None, with_program_spans=True) -> window.Run:
    """Window 0–1000 ns.  Device: 0–150, 250–500, and one op after the
    window.  Program: a dispatch 100–400 with a sync 200–300 inside and a
    launch 120–140, a dispatch 500–600 with a launch 510–540, an admit
    600–700, a dispatch 900–1100 past the window's end; the harness waits
    700–900."""
    ops = [("k", 0, 150), ("k", 250, 500), ("k", 1100, 1200)]
    program = [("repro_torch.serve.dispatch", 100, 400),
               ("repro_torch.serve.sync", 200, 300),
               ("repro_torch.launch.stencil2d t=5 tile=8x32 batch=2",
                120, 140),
               ("repro_torch.serve.dispatch", 500, 600),
               ("repro_torch.launch.stencil2d t=5 tile=8x32 batch=1",
                510, 540),
               ("repro_torch.serve.admit", 600, 700),
               ("repro_torch.serve.dispatch", 900, 1100),
               ("repro_torch.serve.sync", 950, 1050),
               ("repro_torch.launch.stencil2d t=5 tile=8x32 batch=1",
                1000, 1010)]
    spans_ = [(WINDOW, 0, 1000), ("harness.wait", 700, 900)]
    if with_program_spans:
        spans_ += program
    return window.Run(setup_s=1.0, window_s=1e-6, attempted=3, failed=0,
                      trace=Trace((0, 1000), ops, spans_),
                      counters=dict(counters or {}))


def test_readers_on_a_hand_made_trace():
    read = harness.load_reader
    run = hand_made_run({"dispatched": 4, "queue_wait_ms": 10.0})
    # launches inside the window: 20 and 30 ns
    assert read("host_us_per_launch")(run, None) == pytest.approx(0.025)
    assert read("serve_queue_wait_ms")(run, None) == 2.5
    # dispatches inside the window: (300 − 100) + 100 ns over 2
    assert read("serve_host_ms_per_batch")(run, None) == pytest.approx(
        150e-6)
    # idle 150–250 and 500–1000; the program's union, clipped to the
    # window, 100–400, 500–700 and 900–1000: 100 + 200 + 100 ns in both
    assert read("device_idle_in_program.serve")(run, None) == \
        pytest.approx(40.0)
    assert read("device_idle.serve")(run, None) == pytest.approx(60.0)


@pytest.mark.parametrize("metric", [
    "host_us_per_launch", "serve_queue_wait_ms", "serve_host_ms_per_batch",
    "device_idle_in_program.serve"])
def test_readers_find_nothing_without_spans_or_counters(metric):
    read = harness.load_reader(metric)
    assert read(hand_made_run(with_program_spans=False), None) is None
    untraced = hand_made_run()
    untraced.trace = None
    assert read(untraced, None) is None
    assert read(hand_made_run({"dispatched": 0, "queue_wait_ms": 0.0},
                              with_program_spans=False), None) is None

"""The port's stencil service (``repro_torch.serve.stencil_service``) and its
driver (``repro_torch.launch.serve_stencil``) against the reference.

Every program is compiled with ``device="cpu"``, so each sweep runs the
kernel's plain version; on the card the same batch is one kernel launch a
sweep (``tests/test_torch_cuda.py``).  The fields are numpy-seeded and
handed to both packages:

  * a request resolved through ANY service path — a full padded batch, a
    narrower ladder rung, or the degraded solo ``.run`` bottom — equals
    the port's ``.run`` within 2e-5, and the reference's oracle
    (``repro.kernels.ref``) within 2e-5, under Dirichlet(0), periodic and
    reflect, with one interpret-mode program of the reference a family;
  * a seeded faulty tape gives the same outcome per request (value or
    error class, reason, stage, batch width, latency) and the same
    counters through the port's ``drive_sim`` as through the reference's
    (whose programs are wrapped over its plain oracle, to keep the
    reference's side cheap);
  * the typed admission errors, deadlines at every stage, the guards and
    the asyncio front door, as in ``tests/test_serve.py``.
"""
from __future__ import annotations

import asyncio
import random
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Boundary as RefBoundary
from repro.api import compile_stencil as jax_compile
from repro.core import stencil_spec as ref_spec
from repro.kernels import ref as jref
from repro.launch import serve_stencil as ref_launch
from repro.serve import faults as ref_faults
from repro.serve import stencil_service as ref_svc
from repro_torch.api import Boundary, ProgramCache, compile_stencil
from repro_torch.core import stencil_spec as tspec
from repro_torch.launch import serve_stencil as launch
from repro_torch.serve import faults as port_faults
from repro_torch.serve import stencil_service as port_svc
from repro_torch.serve.faults import FaultConfig, FaultInjector
from repro_torch.serve.stencil_service import (Expired, InvalidRequest,
                                               PoisonedOutput, Rejected,
                                               ServeError, ServeRequest,
                                               ServiceConfig, ServiceCore,
                                               SimClock, StencilService)

TOL = 2e-5
CASES = [("j2d5pt", (12, 14)), ("j3d7pt", (6, 8, 5))]
BOUNDARIES = [("dirichlet", 0.0), ("periodic", 0.0), ("reflect", 0.0)]


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: torch's default intra-op threads only oversubscribe
    the CPU the other test workers share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _core(**over) -> ServiceCore:
    cfg = dict(max_batch=4, batch_window_ms=1.0, max_queue=64,
               max_inflight_per_tenant=64, device="cpu")
    cfg.update(over)
    return ServiceCore(ServiceConfig(**cfg), clock=SimClock())


def field(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _direct(spec, x, total_t, boundary=None):
    prog = compile_stencil(spec, x.shape, boundary=boundary, device="cpu")
    return prog.run(torch.as_tensor(x), total_t)


def _held(got, want, what=""):
    err = float(np.max(np.abs(np.asarray(got, np.float64)
                              - np.asarray(want, np.float64))))
    assert err < TOL, f"{what}: max|err| {err:.3e}"


def _oracle(name, x, total_t, bkind="dirichlet"):
    """The reference's plain oracle on the same numpy field."""
    return jref.reference(jnp.asarray(x), ref_spec.get(name), total_t,
                          RefBoundary(bkind, 0.0))


# ------------------------------------------------- equivalence property ----
@pytest.mark.parametrize("name,shape", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("bkind,value", BOUNDARIES,
                         ids=[b[0] for b in BOUNDARIES])
def test_batched_bucket_matches_direct_run(name, shape, bkind, value):
    """3 requests through a width-4 bucket (one row is padding) equal the
    port's ``.run`` and the reference's oracle; under Dirichlet(0) also
    the reference's interpret-mode program."""
    spec, boundary = tspec.get(name), Boundary(bkind, value)
    core = _core()
    xs = [field(shape, seed=i) for i in range(3)]
    tks = [core.submit(ServeRequest(spec, x, total_t=4, boundary=boundary))
           for x in xs]
    core.drain()
    assert core.counters["pad_rows"] >= 1
    for x, tk in zip(xs, tks):
        assert tk.ok, tk.error
        assert tk.batched_width == 3
        got = tk.result()
        _held(got, _direct(spec, x, 4, boundary), "vs .run")
        _held(got, _oracle(name, x, 4, bkind), "vs the reference's oracle")
    if bkind == "dirichlet":
        prog = jax_compile(ref_spec.get(name), shape, t=2)
        _held(tks[0].result(), prog.run(jnp.asarray(xs[0]), 4),
              "vs the reference's interpret-mode program")


@pytest.mark.parametrize("name,shape", CASES, ids=[c[0] for c in CASES])
def test_degraded_ladder_matches_direct_run(name, shape):
    """Under forced OOM above width 2 plus eviction races, every request
    degrades through the ladder yet still equals the direct result."""
    spec = tspec.get(name)
    core = _core()
    core.faults = FaultInjector(FaultConfig(seed=3, evict_rate=0.4,
                                            oom_batch_limit=2))
    xs = [field(shape, seed=10 + i) for i in range(6)]
    tks = [core.submit(ServeRequest(spec, x, total_t=4)) for x in xs]
    core.drain()
    assert core.counters["ladder_splits"] >= 1
    assert core.counters["transient_evicted"] >= 1
    for x, tk in zip(xs, tks):
        assert tk.ok, tk.error
        assert tk.batched_width <= 2
        _held(tk.result(), _direct(spec, x, 4), "vs .run")
        _held(tk.result(), _oracle(name, x, 4), "vs the reference's oracle")


@pytest.mark.parametrize("name,shape", CASES, ids=[c[0] for c in CASES])
def test_unbatched_path_matches_direct_run(name, shape):
    """max_batch=1: the service bottoms out on the solo ``.run`` rung."""
    spec = tspec.get(name)
    core = _core(max_batch=1)
    x = field(shape, seed=0)
    tk = core.submit(ServeRequest(spec, torch.from_numpy(x), total_t=6))
    core.drain()
    assert tk.ok and tk.batched_width == 1
    assert core.counters["solo_dispatches"] == 1
    _held(tk.result(), _direct(spec, x, 6), "vs .run")
    _held(tk.result(), _oracle(name, x, 6), "vs the reference's oracle")


def test_numpy_and_float64_fields_keep_their_dtype():
    """A numpy field moves to the program's device; a float64 field gets
    a float64 program (its own bucket)."""
    spec = tspec.get("j2d5pt")
    core = _core()
    x = field((10, 12), seed=4)
    a = core.submit(ServeRequest(spec, x, total_t=3))
    b = core.submit(ServeRequest(spec, x.astype(np.float64), total_t=3))
    core.drain()
    assert a.result().dtype == torch.float32
    assert b.result().dtype == torch.float64
    assert core.counters["batches"] == 2
    _held(b.result(), _direct(spec, x.astype(np.float64), 3))


# ------------------------------------------------------- outcome tape ----
class _RefOracleProgram:
    """The reference's plain oracle behind the program interface the
    service calls (eager, so no per-shape compile)."""

    def __init__(self, spec, boundary):
        self.spec, self.boundary = spec, boundary

    def run(self, x, total_t):
        return jref.reference_unrolled(x, self.spec, total_t, self.boundary)

    def run_batched(self, xs, total_t):
        return jnp.stack([self.run(x, total_t) for x in xs])


def _ref_compile(spec, shape, *, dtype, t, boundary, interpret):
    return _RefOracleProgram(spec, boundary)


def _tape_outcomes(package, seed=7, n=40):
    svc, lnc, flt = package
    cfg = svc.ServiceConfig(max_batch=4, batch_window_ms=8.0,
                            max_cells=1 << 14, max_queue=256,
                            max_inflight_per_tenant=256, seed=seed,
                            **({"device": "cpu"} if svc is not ref_svc
                               else {}))
    inj = flt.FaultInjector(flt.FaultConfig(
        seed=seed, nan_input_rate=0.08, oversized_rate=0.04,
        expired_rate=0.04, evict_rate=0.15, oom_batch_limit=2,
        delay_ms_range=(0, 5)))
    if svc is ref_svc:
        core = svc.ServiceCore(cfg, clock=svc.SimClock(), faults=inj,
                               compile_fn=_ref_compile)
        tape = lnc.synth_requests(n, random.Random(seed), inj, 200.0,
                                  cfg.max_cells)
    else:
        core = svc.ServiceCore(cfg, clock=svc.SimClock(), faults=inj)
        tape = lnc.synth_requests(n, random.Random(seed), inj, 200.0,
                                  cfg.max_cells, device="cpu")
    tickets = lnc.drive_sim(core, tape)
    outcomes = [(kind, tk.request.spec.name, tuple(tk.request.x.shape),
                 tk.request.tenant, tk.request.total_t,
                 "ok" if tk.ok else type(tk.error).__name__,
                 getattr(tk.error, "reason", None),
                 getattr(tk.error, "stage", None), tk.batched_width,
                 tk.latency_ms) for tk, kind in tickets]
    stats = core.stats()
    stats.pop("runner_cache")           # the caches' own stats differ
    return outcomes, stats, tickets


def test_faulty_tape_outcomes_equal_the_reference():
    got, got_stats, tickets = _tape_outcomes((port_svc, launch, port_faults))
    want, want_stats, _ = _tape_outcomes((ref_svc, ref_launch, ref_faults))
    assert got == want
    # the port's own counters, which the reference lacks, against the
    # tickets' stamps: every admitted request dispatched once
    dispatched = [tk for tk, _ in tickets if tk.dispatched_ms is not None]
    assert got_stats.pop("dispatched") == len(dispatched) \
        == got_stats["admitted"] - got_stats.get("expired_batch_formation", 0)
    assert got_stats.pop("queue_wait_ms") == pytest.approx(
        sum(tk.dispatched_ms - tk.admitted_ms for tk in dispatched))
    assert got_stats == want_stats
    # the tape exercised every rung and fault kind it was built for
    for k in ("transient_evicted", "transient_oom", "ladder_splits",
              "poisoned", "rejected_oversized", "expired_admission"):
        assert got_stats.get(k, 0) >= 1, k
    kinds = {o[0] for o in got}
    assert {"healthy", "nan_input", "oversized", "expired"} <= kinds
    for tk, kind in tickets:              # served values are the oracle's
        if tk.ok and kind == "healthy":
            _held(tk.result(), _direct(tk.request.spec,
                                       tk.request.x.numpy(),
                                       tk.request.total_t))


def test_sixty_second_simulated_soak_with_faults():
    """The reference's soak on the port: every request resolves to a value
    or a typed error; healthy ones equal ``.run``; deterministic."""
    seed, n = 7, 120
    cfg = ServiceConfig(max_batch=4, batch_window_ms=8.0, max_cells=1 << 14,
                        max_queue=4 * n, max_inflight_per_tenant=4 * n,
                        seed=seed, device="cpu")

    def soak():
        inj = FaultInjector(FaultConfig(
            seed=seed, nan_input_rate=0.08, oversized_rate=0.04,
            expired_rate=0.04, evict_rate=0.06, oom_batch_limit=2,
            delay_ms_range=(0, 5)))
        core = ServiceCore(cfg, clock=SimClock(), faults=inj)
        tape = launch.synth_requests(n, random.Random(seed), inj,
                                     n / 60.0, cfg.max_cells, device="cpu")
        return core, launch.drive_sim(core, tape)

    core, tickets = soak()
    assert len(tickets) == n and core.pending() == 0
    checked = 0
    for tk, kind in tickets:
        assert tk.done, f"unresolved {kind} request"
        if not tk.ok:
            assert isinstance(tk.error, ServeError), tk.error
        elif kind == "healthy":
            _held(tk.result(), _direct(tk.request.spec, tk.request.x.numpy(),
                                       tk.request.total_t))
            checked += 1
    assert checked >= n // 2
    turned_away = sum(
        1 for tk, _ in tickets
        if isinstance(tk.error, (Rejected, InvalidRequest))
        or (isinstance(tk.error, Expired) and tk.error.stage == "admission"))
    assert core.stats()["resolved"] == n - turned_away
    _, again = soak()
    assert ([(k, tk.ok, tk.latency_ms) for tk, k in again]
            == [(k, tk.ok, tk.latency_ms) for tk, k in tickets])


# ------------------------------------------------------------- admission ----
def test_queue_full_rejects_typed():
    core = _core(max_queue=2)
    spec = tspec.get("j2d5pt")
    tks = [core.submit(ServeRequest(spec, field((8, 8), seed=i), total_t=2))
           for i in range(3)]
    assert tks[0].error is None and tks[1].error is None
    assert isinstance(tks[2].error, Rejected)
    assert tks[2].error.reason == "queue_full"
    core.drain()


def test_tenant_cap_rejects_typed():
    core = _core(max_inflight_per_tenant=1)
    spec = tspec.get("j2d5pt")
    a, b, c = (core.submit(ServeRequest(spec, field((8, 8), seed=i),
                                        total_t=2, tenant=who))
               for i, who in enumerate(("alice", "alice", "bob")))
    assert a.error is None and c.error is None
    assert isinstance(b.error, Rejected) and b.error.reason == "tenant_cap"
    core.drain()
    assert a.ok and c.ok


def test_round_robin_prevents_tenant_starvation():
    core = _core(max_batch=4)
    spec = tspec.get("j2d5pt")
    noisy = [core.submit(ServeRequest(spec, field((8, 8), seed=i),
                                      total_t=2, tenant="noisy"))
             for i in range(8)]
    quiet = core.submit(ServeRequest(spec, field((8, 8), seed=99),
                                     total_t=2, tenant="quiet"))
    batches = core.poll(force=True)
    assert len(batches) == 3
    first = [tk.request.tenant for tk in batches[0].tickets]
    assert "quiet" in first, f"quiet tenant starved: first batch {first}"
    assert [tk for tk in batches[0].tickets
            if tk.request.tenant == "noisy"] == noisy[:3]
    assert core.counters["multi_tenant_batches"] == 1
    for b in batches:
        core.dispatch(b)
    assert quiet.ok and all(tk.ok for tk in noisy)


def test_round_robin_single_tenant_is_fifo():
    core = _core(max_batch=4)
    spec = tspec.get("j2d5pt")
    tks = [core.submit(ServeRequest(spec, field((8, 8), seed=i), total_t=2,
                                    tenant="solo")) for i in range(6)]
    batches = core.poll(force=True)
    assert [tk for b in batches for tk in b.tickets] == tks
    assert core.counters["multi_tenant_batches"] == 0
    for b in batches:
        core.dispatch(b)


def test_oversized_and_invalid_resolve_alone():
    core = _core(max_cells=64)
    spec = tspec.get("j2d5pt")
    big = core.submit(ServeRequest(spec, torch.zeros((16, 16)), total_t=2))
    assert isinstance(big.error, Rejected) and big.error.reason == "oversized"
    wrong_rank = core.submit(ServeRequest(spec, torch.zeros((8,)),
                                          total_t=2))
    assert isinstance(wrong_rank.error, InvalidRequest)
    bad_t = core.submit(ServeRequest(spec, torch.zeros((8, 8)), total_t=-1))
    assert isinstance(bad_t.error, InvalidRequest)
    for ints in (torch.zeros((8, 8), dtype=torch.int32),
                 np.zeros((8, 8), np.int32)):
        tk = core.submit(ServeRequest(spec, ints, total_t=2))
        assert isinstance(tk.error, InvalidRequest), tk.error
    not_a_spec = core.submit(ServeRequest("j2d5pt", torch.zeros((8, 8)),
                                          total_t=2))
    assert isinstance(not_a_spec.error, InvalidRequest)
    assert core.pending() == 0          # nothing joined a bucket


def test_compile_failure_is_invalid_request():
    """A boundary the tap set cannot take fails alone at admission."""
    core = _core()
    spec = tspec.define_stencil([((0, 0), 1.0), ((0, 1), 0.5),
                                 ((1, 0), 0.5)])
    tk = core.submit(ServeRequest(spec, field((8, 8)), total_t=4,
                                  boundary=Boundary.dirichlet(0.5)))
    assert isinstance(tk.error, InvalidRequest)
    assert "compile failed" in tk.error.reason


# ------------------------------------------------------------- deadlines ----
def test_deadline_checked_at_every_stage():
    spec = tspec.get("j2d5pt")
    x = field((8, 8))

    core = _core()
    tk = core.submit(ServeRequest(spec, x, total_t=2, deadline_ms=0.0))
    assert isinstance(tk.error, Expired) and tk.error.stage == "admission"

    core = _core(batch_window_ms=50.0)
    tk = core.submit(ServeRequest(spec, x, total_t=2, deadline_ms=10.0))
    live = core.submit(ServeRequest(spec, x, total_t=2))
    core.clock.advance(30.0)
    for b in core.poll(force=True):
        core.dispatch(b)
    core.drain()
    assert isinstance(tk.error, Expired)
    assert tk.error.stage == "batch_formation"
    assert live.ok

    core = _core(batch_window_ms=0.0)
    core.faults = FaultInjector(FaultConfig(seed=0, delay_ms_range=(40, 40)))
    tk = core.submit(ServeRequest(spec, x, total_t=2, deadline_ms=20.0))
    core.drain()
    assert isinstance(tk.error, Expired)
    assert tk.error.stage == "post_dispatch"

    core = _core(default_deadline_ms=0.0)     # the config's default
    tk = core.submit(ServeRequest(spec, x, total_t=2))
    assert isinstance(tk.error, Expired) and tk.error.stage == "admission"


# ------------------------------------------------------ poison isolation ----
@pytest.mark.parametrize("guard,expect", [
    ("reject", PoisonedOutput),
    ("retry_solo", PoisonedOutput),
    ("propagate", None),
])
def test_nan_input_never_contaminates_batch_mates(guard, expect):
    spec = tspec.get("j2d5pt")
    core = _core(guard=guard, batch_window_ms=0.0)
    healthy_x = field((8, 8), seed=1)
    poison_x = healthy_x.copy()
    poison_x[3, 3] = np.nan
    poisoned = core.submit(ServeRequest(spec, poison_x, total_t=2))
    healthy = core.submit(ServeRequest(spec, healthy_x, total_t=2))
    core.drain()
    if expect is None:
        assert poisoned.ok
        assert not bool(torch.isfinite(poisoned.result()).all())
    else:
        assert isinstance(poisoned.error, expect)
    assert healthy.ok
    _held(healthy.result(), _direct(spec, healthy_x, 2))


@pytest.mark.parametrize("poison", [np.inf, -np.inf, np.nan])
def test_nonfinite_row_is_caught_by_the_batch_guard(poison):
    """The batch's one reduction flags a row holding +inf, -inf or NaN,
    and only that row."""
    spec = tspec.get("j2d5pt")
    core = _core(guard="reject", batch_window_ms=0.0)
    xs = [field((8, 8), seed=i) for i in range(3)]
    xs[1][2, 5] = poison
    tks = [core.submit(ServeRequest(spec, x, total_t=1)) for x in xs]
    core.drain()
    assert [tk.ok for tk in tks] == [True, False, True]
    assert isinstance(tks[1].error, PoisonedOutput)
    assert core.counters["nonfinite_outputs"] == 1


def test_corrupted_output_row_is_retried_solo():
    """An injected NaN in a healthy batch's output row: ``retry_solo``
    re-runs that request alone and serves the clean result."""
    spec = tspec.get("j2d5pt")
    core = _core(batch_window_ms=0.0)
    core.faults = FaultInjector(FaultConfig(seed=0, nan_output_rate=1.0))
    xs = [field((8, 8), seed=i) for i in range(2)]
    tks = [core.submit(ServeRequest(spec, x, total_t=2)) for x in xs]
    core.drain()
    assert core.counters["guard_solo_retries"] == 1
    for x, tk in zip(xs, tks):
        assert tk.ok
        _held(tk.result(), _direct(spec, x, 2))


def test_result_raises_typed_error():
    core = _core(max_cells=16)
    tk = core.submit(ServeRequest(tspec.get("j2d5pt"), torch.zeros((8, 8)),
                                  total_t=2))
    with pytest.raises(Rejected):
        tk.result()


# --------------------------------------------------------- cache counters ----
def test_program_cache_concurrent_get_or_build_builds_once():
    cache = ProgramCache(8, name="t")
    builds = []

    def build():
        builds.append(1)
        return "v"

    def worker():
        assert cache.get_or_build("k", build) == "v"

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1
    s = cache.stats()
    assert s["misses"] == 1 and s["hits"] == 7 and s["evictions"] == 0


def test_program_cache_eviction_counter():
    cache = ProgramCache(2, name="t")
    for i in range(4):
        cache.put(i, i)
    assert cache.stats()["evictions"] == 2
    cache.clear()
    assert cache.stats()["evictions"] == 4


# ------------------------------------------------------------ async front ----
def test_asyncio_front_door_round_trip():
    spec = tspec.get("j2d5pt")
    xs = [field((8, 8), seed=i) for i in range(4)]

    async def go():
        svc = StencilService(ServiceConfig(max_batch=4, batch_window_ms=1.0,
                                           device="cpu"))
        await svc.start()
        try:
            ys = await asyncio.gather(
                *[svc.submit(ServeRequest(spec, x, total_t=2)) for x in xs])
        finally:
            await svc.stop()
        return ys, svc.stats()

    ys, stats = asyncio.run(go())
    assert stats["completed"] == 4
    for x, y in zip(xs, ys):
        _held(y, _direct(spec, x, 2))


# ------------------------------------------------------------ the driver ----
@pytest.mark.parametrize("argv", [
    ["--requests", "50", "--faults"],
    ["--requests", "16", "--asyncio", "--rate", "2000"],
], ids=["sim", "asyncio"])
def test_driver_exits_zero(argv, capsys):
    assert launch.main(["--device", "cpu", *argv]) == 0
    out = capsys.readouterr().out
    assert "[serve]" in out


def test_driver_tape_consumes_the_rng_as_the_reference():
    """Same seed: the same arrival times, specs, shapes, tenants, steps
    and fault kinds as the reference's tape, and the port's own fields."""
    def tape(lnc, flt, **kw):
        inj = flt.FaultInjector(flt.FaultConfig(
            seed=5, nan_input_rate=0.2, oversized_rate=0.2,
            expired_rate=0.2))
        return lnc.synth_requests(30, random.Random(5), inj, 100.0, 1 << 14,
                                  **kw)

    got = tape(launch, port_faults, device="cpu")
    want = tape(ref_launch, ref_faults)
    assert ([(t, r.spec.name, tuple(r.x.shape), r.tenant, r.total_t,
              r.deadline_ms, k) for t, r, k in got]
            == [(t, r.spec.name, tuple(r.x.shape), r.tenant, r.total_t,
                 r.deadline_ms, k) for t, r, k in want])
    for _, r, kind in got:
        finite = bool(torch.isfinite(r.x).all())
        assert finite == (kind != "nan_input")


def test_launch_counter_loses_no_count_across_threads():
    """The asyncio front door launches from worker threads: the kernels'
    launch counters are bumped under a lock (``_build.count_launch``), so
    many threads switching every microsecond lose no count."""
    import sys

    from repro_torch.kernels import _build

    def wrapper():
        pass

    wrapper.launches = 0
    threads, per = 16, 2000

    def bump():
        for _ in range(per):
            _build.count_launch(wrapper)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=bump) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert wrapper.launches == threads * per

"""Serving driver: synthetic Poisson traffic through the stencil service
(the port's counterpart of ``repro.launch.serve_stencil``).

Generates a seeded arrival process over a mix of stencil specs, shapes,
step counts and tenants, optionally weaving in every fault kind the
service defends against (NaN inputs, oversized shapes, already-expired
deadlines, forced cache evictions, simulated OOM, delayed dispatch), and
drives :class:`~repro_torch.serve.stencil_service.ServiceCore` on a simulated
clock — the run is **deterministic**: same flags, same outcome mix.

The tape consumes its seeded ``random.Random`` exactly as the
reference's does, so one seed gives both packages the same arrival
times, specs, shapes, tenants and fault kinds; the field values come
from the port's own numpy-seeded ``init_domain``.

The exit code is the robustness assertion: 0 iff zero unhandled
exceptions escaped the request path AND every request resolved to a
result or a typed error.  The stats report is printed either way.
Requests run on the card unless ``--device cpu`` asks for the plain
version.

    PYTHONPATH=src python -m repro_torch.launch.serve_stencil \\
        --requests 200 --faults --seed 7
    PYTHONPATH=src python -m repro_torch.launch.serve_stencil \\
        --device cpu --requests 50 --faults

``--asyncio`` runs the same traffic through the real-clock asyncio front
door (:class:`StencilService`) instead — non-deterministic timings, same
resolution guarantees."""
from __future__ import annotations

import argparse
import random
import sys

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.stencil_spec import get
from repro_torch.serve.faults import FaultConfig, FaultInjector, HEALTHY
from repro_torch.serve.stencil_service import (ServeError, ServeRequest,
                                               ServiceConfig, ServiceCore,
                                               SimClock, StencilService)
from repro_torch.stencils.data import init_domain

# the served mix: 2-D and 3-D, radius 1 and 2, two shapes per spec —
# enough bucket diversity to exercise coalescing (the reference's mix)
MIX = (
    ("j2d5pt", ((16, 20), (24, 16))),
    ("j2d9pt", ((20, 20),)),
    ("j3d7pt", ((8, 8, 6),)),
)
TENANTS = ("alice", "bob", "carol", "mallory")


def synth_requests(n: int, rng: random.Random, inj: FaultInjector | None,
                   rate_hz: float, max_cells: int, total_t: int = 4,
                   device=None):
    """The seeded arrival tape: ``[(arrival_ms, ServeRequest, kind)]``,
    fields on ``device`` (default: the card).

    Poisson arrivals (exponential gaps at ``rate_hz``); each request's
    fault kind is drawn from the injector's traffic rates (``'healthy'``
    when faults are off) and shapes the request accordingly."""
    device = resolve_device(device)
    out, t_ms = [], 0.0
    for i in range(n):
        t_ms += rng.expovariate(rate_hz) * 1e3
        name, shapes = MIX[rng.randrange(len(MIX))]
        spec = get(name)
        shape = shapes[rng.randrange(len(shapes))]
        kind = inj.classify_request() if inj is not None else HEALTHY
        x = init_domain(spec, shape, seed=rng.randrange(1 << 20),
                        device=device)
        deadline = None
        if kind == "nan_input":
            x[tuple(0 for _ in shape)] = float("nan")
        elif kind == "oversized":
            # rank-correct but over the admission cell cap
            side = int(max_cells ** (1 / spec.ndim)) + 2
            shape = tuple(side for _ in range(spec.ndim))
            x = torch.zeros(shape, dtype=torch.float32, device=device)
        elif kind == "expired":
            deadline = 0.0
        out.append((t_ms, ServeRequest(spec, x, total_t=total_t,
                                       tenant=rng.choice(TENANTS),
                                       deadline_ms=deadline), kind))
    return out


def drive_sim(core: ServiceCore, tape) -> list:
    """Replay the arrival tape on the core's sim clock: advance to each
    arrival, submit, pump due batches; then drain.  Returns
    ``[(ticket, kind)]`` in arrival order."""
    clock = core.clock
    tickets = []
    for t_ms, req, kind in tape:
        clock.advance(t_ms - clock.now_ms())
        tickets.append((core.submit(req), kind))
        core.pump()
    core.drain()
    return tickets


def report(core: ServiceCore, tickets, *, show: bool = True) -> int:
    """Print the stats report; return the number of robustness violations
    (unresolved tickets — unhandled exceptions already propagated)."""
    unresolved = [tk for tk, _ in tickets if not tk.done]
    by_kind: dict = {}
    for tk, kind in tickets:
        outcome = ("ok" if tk.ok else type(tk.error).__name__)
        by_kind.setdefault(kind, {}).setdefault(outcome, 0)
        by_kind[kind][outcome] += 1
    if show:
        print("[serve] outcome by injected kind:")
        for kind in sorted(by_kind):
            print(f"  {kind:12s} {by_kind[kind]}")
        stats = core.stats()
        print("[serve] stats:")
        for k in sorted(stats):
            print(f"  {k:26s} {stats[k]}")
        print(f"[serve] unresolved: {len(unresolved)}")
    return len(unresolved)


def run(n_requests: int = 200, *, seed: int = 0, rate_hz: float = 200.0,
        faults: bool = False, guard: str = "retry_solo",
        window_ms: float = 8.0, max_batch: int = 8,
        show: bool = True, device=None) -> int:
    """The deterministic sim-clock run; returns the violation count."""
    cfg = ServiceConfig(guard=guard, batch_window_ms=window_ms,
                        max_batch=max_batch, max_cells=1 << 14,
                        max_queue=max(64, n_requests), seed=seed,
                        device=device)
    inj = FaultInjector(FaultConfig(
        seed=seed, nan_input_rate=0.06, oversized_rate=0.03,
        expired_rate=0.03, evict_rate=0.05, oom_batch_limit=max_batch // 2,
        delay_ms_range=(0, 4))) if faults else None
    rng = random.Random(seed)
    core = ServiceCore(cfg, clock=SimClock(), faults=inj)
    tape = synth_requests(n_requests, rng, inj, rate_hz, cfg.max_cells,
                          device=device)
    tickets = drive_sim(core, tape)
    bad = report(core, tickets, show=show)
    # stats report must be non-empty and every request typed-resolved
    if not core.stats().get("resolved"):
        print("[serve] FAIL: empty stats report")
        return bad + 1
    return bad


async def run_asyncio(n_requests: int, *, seed: int, rate_hz: float,
                      guard: str, device=None) -> int:
    """The real-clock asyncio path: same mix, actual awaited submits."""
    import asyncio

    rng = random.Random(seed)
    svc = StencilService(ServiceConfig(guard=guard, batch_window_ms=4.0,
                                       max_queue=max(64, n_requests),
                                       seed=seed, device=device))
    tape = synth_requests(n_requests, rng, None, rate_hz, 1 << 14,
                          device=device)
    await svc.start()

    async def one(req):
        try:
            return await svc.submit(req)
        except ServeError as e:
            return e

    results = await asyncio.gather(*[one(req) for _, req, _ in tape])
    await svc.stop()
    stats = svc.stats()
    ok = sum(1 for r in results if not isinstance(r, ServeError))
    print(f"[serve] asyncio: {ok}/{len(results)} ok, "
          f"batches={stats.get('batches', 0)}, "
          f"p99={stats.get('p99_latency_ms', 0)}ms, "
          f"rps={stats.get('requests_per_sec', 0)}")
    return 0 if len(results) == n_requests else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="synthetic Poisson traffic through the stencil service")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="Poisson arrival rate, requests/sec (sim clock)")
    ap.add_argument("--faults", action="store_true",
                    help="enable seeded fault injection (NaN inputs, "
                         "oversized shapes, expired deadlines, evictions, "
                         "OOM, delays)")
    ap.add_argument("--guard", choices=("reject", "propagate", "retry_solo"),
                    default="retry_solo")
    ap.add_argument("--window-ms", type=float, default=8.0)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--asyncio", action="store_true",
                    help="drive the real-clock asyncio front door instead")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where requests run: the card (default) or the "
                         "CPU's plain version")
    args = ap.parse_args(argv)
    if args.asyncio:
        import asyncio
        return asyncio.run(run_asyncio(args.requests, seed=args.seed,
                                       rate_hz=args.rate, guard=args.guard,
                                       device=args.device))
    bad = run(args.requests, seed=args.seed, rate_hz=args.rate,
              faults=args.faults, guard=args.guard,
              window_ms=args.window_ms, max_batch=args.max_batch,
              device=args.device)
    print(f"[serve] {'FAIL' if bad else 'OK'} — "
          f"{args.requests} requests, {bad} robustness violations")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

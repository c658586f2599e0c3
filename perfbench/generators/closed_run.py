"""One caller in a closed loop: ``y = prog.run(x, steps)``, each output the
next call's input, as one long simulation of a stencil configuration.

Traffic parameters: ``steps_per_call``.  At most two calls are in
flight, so the card never waits on the host and the window ends with the
last call it holds.  The check compares the first call (from the seed's
field) and one later call drawn from the seed, each against the
reference run from that call's own input.
"""
from __future__ import annotations

import math
import random
import time

from perfbench.generators import _stencil
from perfbench.trace import Profiler, span
from perfbench.window import Run, no_gc_pauses

CHECKS = ("start_max_abs_err", "sample_max_abs_err")
FAULTS = ("unchanged", "altered")
plant = _stencil.plant


def kernel_launches() -> int:
    """Launches of both stencil kernels so far, from their wrappers'
    counters."""
    from repro_torch.kernels import stencil2d, stencil3d

    return (stencil2d.ebisu2d_padded.launches
            + stencil3d.ebisu3d_padded.launches)


def run(cell) -> Run:
    from repro_torch.api import compile_stencil

    steps = int(cell.traffic["steps_per_call"])
    spec = _stencil.spec(cell)
    x0 = cell.field(cell.domain)
    cell.sync()
    cell.mark("inputs")
    prog = compile_stencil(spec, cell.domain, dtype=cell.dtype,
                           device=cell.device)
    prog.run(x0, steps)                  # builds the kernel and the chain
    cell.sync()
    cell.mark("warm_up")
    rng = random.Random(cell.seed)
    first = sampled = None
    launched = kernel_launches()
    with no_gc_pauses(), Profiler(cell.trace) as prof:
        t0 = time.perf_counter()
        y, pending, calls = x0, None, 0
        while True:
            with span("program.run", cell.trace):
                out = prog.run(y, steps)
            calls += 1
            if calls == 1:
                first = ("start_max_abs_err", out, {"x": x0, "steps": steps})
            elif rng.random() * (calls - 1) < 1.0:
                # a uniform draw from the calls after the first
                sampled = ("sample_max_abs_err", out,
                           {"x": y, "steps": steps})
            done = cell.event()
            if pending is not None:      # at most two calls in flight
                with span("harness.wait", cell.trace):
                    pending.synchronize()
            pending, y = done, out
            if time.perf_counter() - t0 >= cell.seconds:
                break
        with span("harness.wait", cell.trace):
            cell.sync()
        t1 = time.perf_counter()
    del y, out, pending
    cells = math.prod(cell.domain)
    return Run(setup_s=t0 - cell.started, window_s=t1 - t0,
               attempted=calls, failed=0, trace=prof.trace,
               counters={"kernel_launches": kernel_launches() - launched},
               calls=calls, cells=cells, depth=prog.t,
               geometry=prog.geometry(),
               useful_cell_updates=calls * steps * cells,
               setup_stages=cell.marks,
               compare=[c for c in (first, sampled) if c is not None])

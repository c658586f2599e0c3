"""ptxas's report of the 3-D kernel's tap-set libraries across radii: the
registers, spill-store bytes and stack-frame bytes of each instantiation
(f32 and f64) for a star and a dense 128-tap set at every radius, at the
planner's register budget or at the budgets given.

    python -m repro_torch.launch.stencil3d_registers
    python -m repro_torch.launch.stencil3d_registers --regs 64 56 48 40 32

``--regs`` sets the registers of z partial sums a thread may hold
(``planner.max_cells_per_thread`` is 64 up to radius 2 and 48 beyond);
each line gives the tap set, its radius, the budget, the cells a thread
in f32 and f64, the build's seconds, and ptxas's ``[registers, spill
stores, stack frame]`` per instantiation.  It needs ``nvcc`` (it builds
the libraries, in parallel, into ``kernels/_build/``) and launches
nothing.  The card tests build the same tap sets at the planner's budget
(``tests/test_torch_cuda.py``).
"""
from __future__ import annotations

import argparse
import json
import re
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.core.planner import max_cells_per_thread
from repro_torch.core.stencil_spec import (StencilSpec, define_stencil,
                                           star_taps)
from repro_torch.kernels import _build, stencil3d_gen


def dense_spec(radius: int, n: int = 128, seed: int = 0) -> StencilSpec:
    """``n`` taps of the ``(2·radius+1)³`` cube: the centre and the six
    axis ends, the rest drawn from a seeded permutation (so most
    in-plane offsets of the radius are used, each with its own ``dz``)."""
    rng = np.random.default_rng(seed + radius)
    r = range(-radius, radius + 1)
    ends = [(0, 0, 0)] + [tuple(s * radius * (a == b) for b in range(3))
                          for a in range(3) for s in (1, -1)]
    rest = [(z, y, x) for z in r for y in r for x in r
            if (z, y, x) not in ends]
    pick = ends + [rest[i] for i in rng.permutation(len(rest))[:n - 7]]
    return define_stencil([(o, 1.0 + 0.01 * i) for i, o in enumerate(pick)],
                          name=f"dense-r{radius}", normalize=True)


def probe_specs(radii=range(1, 9)) -> list[StencilSpec]:
    """A star and a dense set (:func:`dense_spec`) at each radius."""
    return [spec for rad in radii
            for spec in (define_stencil(star_taps(3, rad),
                                        name=f"star-r{rad}", normalize=True),
                         dense_spec(rad))]


def header_at(spec: StencilSpec, regs: int | None) -> tuple[str, int, int]:
    """The tap set's header at ``regs`` registers of partial sums (the
    planner's budget if ``None``), with the cells a thread in f32 and
    f64."""
    text = stencil3d_gen.header(tuple(spec.taps))
    rad = spec.radius
    k = [max_cells_per_thread(rad, size) if regs is None
         else max(1, regs * 4 // (2 * rad * size)) for size in (4, 8)]
    for name, cells in zip(("ST3_SLOTS_F32", "ST3_SLOTS_F64"), k):
        text = re.sub(rf"#define {name} \d+", f"#define {name} {cells}", text)
    return text, k[0], k[1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--regs", type=int, nargs="*", default=[None],
                    help="registers of partial sums a thread (default: "
                         "the planner's budget)")
    args = ap.parse_args(argv)
    jobs, seen = [], set()
    for spec in probe_specs():
        for regs in args.regs:
            text, k32, k64 = header_at(spec, regs)
            if text not in seen:
                seen.add(text)
                jobs.append((spec, regs, k32, k64, text))

    def build(job):
        t0 = time.perf_counter()
        _build.build("stencil3d", job[4])
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(jobs)) as pool:
        seconds = list(pool.map(build, jobs))
    for (spec, regs, k32, k64, text), sec in zip(jobs, seconds):
        frames = _build.ptxas_frames(_build.build_log("stencil3d", text))
        by_type = {("f64" if "kernelId" in kernel else "f32"): v
                   for kernel, v in frames.items()}
        print(json.dumps(dict(spec=spec.name, radius=spec.radius,
                              taps=len(spec.taps), regs=regs, k_f32=k32,
                              k_f64=k64, seconds=round(sec, 2), **by_type)),
              flush=True)


if __name__ == "__main__":
    main()

"""ptxas's report of the stencil kernels' tap-set libraries across radii:
the registers, spill-store bytes and stack-frame bytes of each
instantiation (f32 and f64) for a star and a dense 128-tap set at every
radius 1–8, or dense sets of other sizes (``--taps``).

    python -m repro_torch.launch.stencil_registers
    python -m repro_torch.launch.stencil_registers --regs 64 56 48 40 32
    python -m repro_torch.launch.stencil_registers --ndim 2 [--rows 8 16]
    python -m repro_torch.launch.stencil_registers --taps 343 729 \
        --radii 3 4 8

For the 3-D template (``csrc/stencil3d.cu``, the default) ``--regs``
sets the registers of z partial sums a thread may hold
(``planner.max_cells_per_thread`` is 64 up to radius 2 and 48 beyond);
each line gives the tap set, its radius, the budget, the cells a thread
in f32 and f64.  For the 2-D template (``csrc/stencil2d.cu``, ``--ndim
2``) ``--rows`` sets the rows a thread computes (``R``,
``planner.rows_per_thread_2d``).  ``--taps`` builds a dense set of
each given size per radius (the whole box where it has fewer taps), in
place of the star and the 128-tap set.  Each line also gives the build's
seconds and ptxas's ``[registers, spill stores, stack frame]`` per
instantiation.  It needs ``nvcc`` (it builds the libraries, in parallel,
into ``kernels/_build/``) and launches nothing.  The card tests build the
same tap sets at the planner's bounds (``tests/test_torch_cuda.py``).
"""
from __future__ import annotations

import argparse
import itertools
import json
import re
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.core.planner import max_cells_per_thread, rows_per_thread_2d
from repro_torch.core.stencil_spec import (StencilSpec, define_stencil,
                                           star_taps)
from repro_torch.kernels import _build, stencil2d_gen, stencil3d_gen

_PREFIX = {2: "2d-", 3: ""}


def dense_spec(radius: int, n: int = 128, seed: int = 0,
               ndim: int = 3) -> StencilSpec:
    """``n`` taps of the ``(2·radius+1)^ndim`` box (all of them where it
    has fewer): the centre and the axis ends, the rest drawn from a
    seeded permutation (in 3-D most in-plane offsets of the radius are
    used, each with its own ``dz``; in 2-D most column offsets, each
    with its own ``dy``)."""
    rng = np.random.default_rng(seed + radius)
    r = range(-radius, radius + 1)
    ends = [(0,) * ndim] + [tuple(s * radius * (a == b) for b in range(ndim))
                            for a in range(ndim) for s in (1, -1)]
    rest = [o for o in itertools.product(r, repeat=ndim) if o not in ends]
    pick = ends + [rest[i] for i in
                   rng.permutation(len(rest))[:n - len(ends)]]
    size = "" if n == 128 else f"-{len(pick)}t"
    return define_stencil([(o, 1.0 + 0.01 * i) for i, o in enumerate(pick)],
                          name=f"dense-{_PREFIX[ndim]}r{radius}{size}",
                          normalize=True)


def probe_specs(radii=range(1, 9), ndim: int = 3,
                taps=None) -> list[StencilSpec]:
    """A star and a dense set (:func:`dense_spec`) at each radius; or,
    with ``taps``, a dense set of each of those sizes at each radius
    (one set where the box has fewer taps than several sizes)."""
    if taps is None:
        return [spec for rad in radii
                for spec in (define_stencil(star_taps(ndim, rad),
                                            name=f"star-{_PREFIX[ndim]}"
                                                 f"r{rad}",
                                            normalize=True),
                             dense_spec(rad, ndim=ndim))]
    out = []
    for rad in radii:
        box = (2 * rad + 1) ** ndim
        for n in sorted({min(n, box) for n in taps}):
            out.append(dense_spec(rad, n, ndim=ndim))
    return out


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


def header_at_2d(spec: StencilSpec, rows: int | None) -> tuple[str, int,
                                                                 int]:
    """The 2-D tap set's header at ``rows`` rows a thread (the planner's
    ``R`` if ``None``), with the rows in f32 and f64."""
    text = stencil2d_gen.header(tuple(spec.taps))
    r = [rows_per_thread_2d(spec.radius, size, len(spec.taps))
         if rows is None else rows
         for size in (4, 8)]
    for name, n in zip(("ST2_ROWS_F32", "ST2_ROWS_F64"), r):
        text = re.sub(rf"#define {name} \d+", f"#define {name} {n}", text)
    return text, r[0], r[1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ndim", type=int, choices=(2, 3), default=3,
                    help="the 3-D template (default) or the 2-D one")
    ap.add_argument("--regs", type=int, nargs="*", default=[None],
                    help="3-D: registers of partial sums a thread "
                         "(default: the planner's budget)")
    ap.add_argument("--rows", type=int, nargs="*", default=[None],
                    help="2-D: rows a thread computes (default: the "
                         "planner's R)")
    ap.add_argument("--taps", type=int, nargs="+", default=None,
                    help="dense sets of these sizes, in place of a star "
                         "and a 128-tap set per radius")
    ap.add_argument("--radii", type=int, nargs="+", default=range(1, 9),
                    help="the radii to probe (default 1-8)")
    args = ap.parse_args(argv)
    name = "stencil3d" if args.ndim == 3 else "stencil2d"
    at = header_at if args.ndim == 3 else header_at_2d
    knob = "regs" if args.ndim == 3 else "rows"
    per = "k" if args.ndim == 3 else "rows"
    jobs, seen = [], set()
    for spec in probe_specs(args.radii, args.ndim, args.taps):
        for value in getattr(args, knob):
            text, n32, n64 = at(spec, value)
            if text not in seen:
                seen.add(text)
                jobs.append((spec, value, n32, n64, text))

    def build(job):
        t0 = time.perf_counter()
        _build.build(name, job[4])
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(jobs)) as pool:
        seconds = list(pool.map(build, jobs))
    for (spec, value, n32, n64, text), sec in zip(jobs, seconds):
        frames = _build.ptxas_frames(_build.build_log(name, text))
        by_type = {("f64" if "kernelId" in kernel else "f32"): v
                   for kernel, v in frames.items()}
        print(json.dumps({"spec": spec.name, "radius": spec.radius,
                          "taps": len(spec.taps), knob: value,
                          f"{per}_f32": n32, f"{per}_f64": n64,
                          "seconds": round(sec, 2), **by_type}),
              flush=True)


if __name__ == "__main__":
    main()

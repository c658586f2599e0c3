"""Stencil driver of the port: the paper's 2-D suite, end to end.

    python -m repro_torch.launch.stencil_run --stencil j2d5pt,j2d9pt \\
        [--scale N] [--t N] [--boundary periodic] [--device cuda|cpu]

For each stencil it compiles a program on a Table-2 domain cut by
``--scale`` (``--scale 1`` is the paper's own domain), runs one sweep of
depth ``--t`` (or ``.run`` as chained sweeps when ``--t`` is deeper than
the plan), prints the plan and ``maxerr`` against the port's oracle, and
asserts it is below 1e-4.  ``--device`` defaults to the card.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.api import Boundary, compile_stencil
from repro_torch.core.stencil_spec import TABLE2, StencilSpec, get
from repro_torch.kernels import ref
from repro_torch.stencils.data import init_domain, reduced_domain


def parse_boundary(text: str) -> Boundary:
    """'dirichlet[:v]' | 'periodic' | 'reflect' | 'neumann[:flux]'."""
    kind, _, val = text.partition(":")
    if kind == "dirichlet":
        return Boundary.dirichlet(float(val) if val else 0.0)
    if kind == "periodic":
        return Boundary.periodic()
    if kind == "reflect":
        return Boundary.reflect()
    if kind == "neumann":
        return Boundary.neumann(float(val) if val else 0.0)
    raise argparse.ArgumentTypeError(
        f"unknown boundary {text!r}; use dirichlet[:v] | periodic | "
        f"reflect | neumann[:flux]")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_single(spec: StencilSpec | str, *, t: int | None = None,
               scale: int = 64, boundary: Boundary | None = None,
               device=None, check: bool = True) -> torch.Tensor:
    spec = get(spec) if isinstance(spec, str) else spec
    shape = reduced_domain(spec, scale)
    boundary = boundary or Boundary.dirichlet(0.0)
    # unnormalized Dirichlet admits only depth-1 sweeps (affine closure)
    depth_cap = 1 if (boundary.kind == "dirichlet" and boundary.value != 0.0
                      and abs(spec.tap_sum - 1.0) > 1e-6) else None
    prog = compile_stencil(spec, shape, boundary=boundary, t=depth_cap,
                           device=device)
    depth = t or min(prog.t, 6)
    x = init_domain(spec, shape, device=prog.device)
    t0 = time.perf_counter()
    if depth > prog.t:
        y = prog.run(x, depth)
        how = f"run(T={depth}, t={prog.t})"
    else:
        y = prog.apply(x, t=depth)
        how = "single-sweep"
    _sync(prog.device)
    dt = time.perf_counter() - t0
    g = prog.geometry(min(depth, prog.t))
    line = (f"[stencil] {spec.name:11s} domain={shape} t={depth} {how} "
            f"boundary={boundary!r} device={prog.device} "
            f"plan(t={prog.plan.t}, tile={g['block']}, grid={g['grid']}, "
            f"threads={g['threads']}, smem={g['smem_bytes']}B) "
            f"{dt * 1e3:.1f}ms")
    if check:
        want = ref.reference(x, spec, depth, boundary=boundary)
        err = float((y - want).abs().max())
        line += f" maxerr={err:.2e}"
        assert err < 1e-4, line
    print(line, flush=True)
    return y


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stencil", default="all",
                    help="2-D Table-2 names (comma-separated) or 'all'")
    ap.add_argument("--t", type=int, default=None)
    ap.add_argument("--scale", type=int, default=64,
                    help="divide each Table-2 extent by N (1 = full size)")
    ap.add_argument("--boundary", type=parse_boundary, default=None,
                    metavar="dirichlet[:v]|periodic|reflect|neumann[:flux]")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the card")
    args = ap.parse_args(argv)
    names = ([n for n, s in TABLE2.items() if s.ndim == 2]
             if args.stencil == "all" else args.stencil.split(","))
    for n in names:
        run_single(n, t=args.t, scale=args.scale, boundary=args.boundary,
                   device=args.device)


if __name__ == "__main__":
    main()

"""Command-line runner of the port: the paper's Table-2 suite, custom
stencils and coupled systems, end to end.

    python -m repro_torch.launch.stencil_run --stencil j2d5pt,j3d7pt \\
        [--scale N] [--t N] [--boundary periodic] [--device cuda|cpu]
    python -m repro_torch.launch.stencil_run \\
        --taps '[[[0,0],0.6],[[0,1],0.1],[[0,-1],0.1],[[1,0],0.1],[[-1,0],0.1]]' \\
        [--normalize] [--name mine] [--t 2] [--out y.npy]
    python -m repro_torch.launch.stencil_run --spec-json my_stencil.json
    python -m repro_torch.launch.stencil_run --system gray-scott --t 4

For each stencil it compiles a program on a Table-2 domain cut by
``--scale`` (``--scale 1`` is the paper's own domain), runs one sweep of
depth ``--t`` (or ``.run`` as chained sweeps when ``--t`` is deeper than
the plan), prints the plan and ``maxerr`` against the port's oracle, and
asserts it is below 1e-4.  A custom stencil (``--taps`` or
``--spec-json``) runs the same way on a domain of its own, after a
``[spec]`` line of its derived §5 cost model (on the H100 datasheet
model); ``--out`` saves the final field with ``np.save``.  ``--system``
runs a coupled system's fused chain and checks it against the unfused
lockstep reference.  ``--device`` defaults to the card.
"""
from __future__ import annotations

import argparse
import time

import torch

import numpy as np

from repro_torch.api import (Boundary, compile_stencil, define_stencil,
                             parse_taps, spec_from_json)
from repro_torch.core import roofline as rl
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


def cost_summary_line(spec: StencilSpec,
                      hw: rl.HardwareModel = rl.H100) -> str:
    """One line of the derived §5 cost model (flagging any overrides)."""
    c = rl.spec_cost_summary(spec, hw)
    over = f" overrides={','.join(c['overridden'])}" if c["overridden"] else ""
    return (f"[spec]    {spec.name:11s} {c['ndim']}D r={c['radius']} "
            f"{c['npoints']}pt {c['shape_kind']} tap_sum={c['tap_sum']:.4g} | "
            f"flops/cell={c['flops_per_cell']:g} "
            f"a_sm={c['a_sm']:g} a_sm_rst={c['a_sm_rst']:g}{over} | "
            f"eq17 t*={c['desired_depth_eq17']:.1f} "
            f"eq23 w_min={c['min_tile_width_eq23']:.0f}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_single(spec: StencilSpec | str, *, t: int | None = None,
               scale: int = 64, boundary: Boundary | None = None,
               device=None, check: bool = True,
               summary: bool = False) -> torch.Tensor:
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
    if summary:
        print(cost_summary_line(spec), flush=True)
    line = (f"[stencil] {spec.name:11s} domain={shape} t={depth} {how} "
            f"boundary={boundary!r} device={prog.device} "
            f"plan(t={prog.plan.t}, tile={g['block']}, grid={g['grid']}, "
            f"threads={g['threads']}, "
            f"smem={g.get('kernel_smem_bytes', g['smem_bytes'])}B) "
            f"{dt * 1e3:.1f}ms")
    if check:
        want = ref.reference(x, spec, depth, boundary=boundary)
        err = float((y - want).abs().max())
        line += f" maxerr={err:.2e}"
        assert err < 1e-4, line
    print(line, flush=True)
    return y


def run_system_cli(name: str, *, t: int | None = None, scale: int = 64,
                   boundary: Boundary | None = None,
                   total_t: int | None = None, check: bool = True,
                   device=None) -> dict:
    """Drive a coupled system end to end: compile the library system on a
    ``scale``-wide domain, run ``T`` steps as fused multi-field sweeps,
    and (optionally) check the result is finite and matches the unfused
    per-field-per-step lockstep reference.

        python -m repro_torch.launch.stencil_run --system gray-scott --t 4
    """
    from repro_torch.core.device import resolve_device
    from repro_torch.systems import compile_system, get_system

    spec = get_system(name)
    boundary = boundary or Boundary.periodic()
    shape = (scale,) * spec.ndim
    prog = compile_system(spec, shape, t=t or 4, boundary=boundary)
    total = total_t if total_t is not None else 2 * prog.t + 1
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    fields = {f: torch.from_numpy(
        rng.uniform(0.2, 0.8, shape).astype(np.float32)).to(device)
        for f in spec.fields}
    t0 = time.perf_counter()
    out = prog.run(fields, total)
    _sync(device)
    dt = time.perf_counter() - t0
    line = (f"[system]  {spec.name:20s} fields={len(spec.fields)} "
            f"domain={shape} T={total} t={prog.t} "
            f"boundary={boundary!r} device={device} {dt * 1e3:.1f}ms")
    if check:
        assert all(bool(torch.isfinite(v).all()) for v in out.values()), \
            f"{spec.name}: non-finite output"
        want = prog.run_lockstep(fields, total)
        err = max(float((out[f] - want[f]).abs().max())
                  for f in spec.fields)
        line += f" maxerr_vs_lockstep={err:.2e}"
        assert err < 2e-5, line
    print(line, flush=True)
    return out


# flags of the reference's CLI whose paths are not ported yet
_LATER = {"mesh": "ROADMAP Queue 1 item 8 (sharded deep-halo execution)",
          "distributed": "ROADMAP Queue 1 item 8 (sharded deep-halo "
                         "execution)",
          "checkpoint_dir": "ROADMAP Queue 1 item 10 (resilient campaigns)",
          "resume": "ROADMAP Queue 1 item 10 (resilient campaigns)",
          "every": "ROADMAP Queue 1 item 10 (resilient campaigns)",
          "kill_after_leg": "ROADMAP Queue 1 item 10 (resilient campaigns)"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stencil", default="all",
                    help="Table-2 names, 2-D or 3-D (comma-separated), or "
                         "'all'")
    ap.add_argument("--taps", default=None, metavar="'[[[0,0],0.6],...]'",
                    help="define a custom stencil from a JSON tap list")
    ap.add_argument("--spec-json", default=None, metavar="FILE",
                    help="define a custom stencil from a JSON spec file")
    ap.add_argument("--normalize", action="store_true",
                    help="rescale --taps coefficients to sum to 1")
    ap.add_argument("--name", default=None,
                    help="name for the --taps stencil")
    ap.add_argument("--system", default=None, metavar="NAME",
                    help="run a coupled multi-field system (gray-scott | "
                         "fdtd-acoustic | advection-diffusion)")
    ap.add_argument("--t", type=int, default=None)
    ap.add_argument("--scale", type=int, default=64,
                    help="divide each Table-2 extent by N (1 = full size);"
                         " a --system domain's extent")
    ap.add_argument("--boundary", type=parse_boundary, default=None,
                    metavar="dirichlet[:v]|periodic|reflect|neumann[:flux]")
    ap.add_argument("--T", type=int, default=None, dest="total_t",
                    help="total steps of a --system run (default 2*t+1)")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="np.save the final field of one stencil to FILE")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the card")
    for flag, kw in (("--mesh", {}), ("--distributed", dict(nargs="?",
                                                            const=True)),
                     ("--checkpoint-dir", {}), ("--resume", {}),
                     ("--every", {}), ("--kill-after-leg", {})):
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS, **kw)
    args = ap.parse_args(argv)
    for key, item in _LATER.items():
        if getattr(args, key) is not None:
            ap.error(f"--{key.replace('_', '-')} is not ported to "
                     f"repro_torch yet: {item}")
    if args.taps and args.spec_json:
        ap.error("--taps and --spec-json are mutually exclusive")
    if args.system:
        if args.taps or args.spec_json or args.out:
            ap.error("--system runs single-device fused system programs; "
                     "it composes with --t/--T/--scale/--boundary only")
        run_system_cli(args.system, t=args.t, scale=args.scale,
                       boundary=args.boundary, total_t=args.total_t,
                       device=args.device)
        return
    if args.taps or args.spec_json:
        spec = (define_stencil(parse_taps(args.taps),
                               normalize=args.normalize, name=args.name)
                if args.taps else spec_from_json(args.spec_json))
        if not isinstance(spec, StencilSpec):
            ap.error("--spec-json holds a coupled system (a 'fields' "
                     "object); run a library system with --system")
        specs, summary = [spec], True
    else:
        names = (list(TABLE2) if args.stencil == "all"
                 else args.stencil.split(","))
        specs, summary = names, False
    if args.out and len(specs) > 1:
        ap.error("--out saves one field: name one stencil")
    for spec in specs:
        y = run_single(spec, t=args.t, scale=args.scale,
                       boundary=args.boundary, device=args.device,
                       summary=summary)
    if args.out:
        np.save(args.out, y.cpu().numpy())
        print(f"[stencil] final field -> {args.out}", flush=True)


if __name__ == "__main__":
    main()

"""Command-line runner of the port: the paper's Table-2 suite, custom
stencils and coupled systems, end to end.

    python -m repro_torch.launch.stencil_run --stencil j2d5pt,j3d7pt \\
        [--scale N] [--t N] [--boundary periodic] [--device cuda|cpu]
    python -m repro_torch.launch.stencil_run \\
        --taps '[[[0,0],0.6],[[0,1],0.1],[[0,-1],0.1],[[1,0],0.1],[[-1,0],0.1]]' \\
        [--normalize] [--name mine] [--t 2] [--out y.npy]
    python -m repro_torch.launch.stencil_run --spec-json my_stencil.json
    python -m repro_torch.launch.stencil_run --system gray-scott --t 4
    python -m repro_torch.launch.stencil_run --stencil j2d5pt --mesh 2x2 \\
        [--T 25] [--device cpu]
    python -m repro_torch.launch.stencil_run --stencil j2d5pt --distributed
    python -m repro_torch.launch.stencil_run --stencil j2d5pt \\
        --checkpoint-dir ck --T 24 [--every 2] [--resume auto] \\
        [--kill-after-leg 2] [--out y.npy]

For each stencil it compiles a program on a Table-2 domain cut by
``--scale`` (``--scale 1`` is the paper's own domain), runs one sweep of
depth ``--t`` (or ``.run`` as chained sweeps when ``--t`` is deeper than
the plan), prints the plan and ``maxerr`` against the port's oracle, and
asserts it is below 1e-4.  A custom stencil (``--taps`` or
``--spec-json``) runs the same way on a domain of its own, after a
``[spec]`` line of its derived §5 cost model (on the H100 datasheet
model); ``--out`` saves the final field with ``np.save``.  ``--system``
runs a coupled system's fused chain and checks it against the unfused
lockstep reference.  ``--mesh ZxY`` compiles the program onto a device
mesh and runs ``T`` steps through ``run_sharded`` — deep ghost zones
exchanged once per temporal block — checked against the oracle; the
mesh takes the shards it needs: CPU shards with ``--device cpu``, the
visible GPUs cycled on the card (on one card, every shard on
``cuda:0``).  ``--distributed`` runs the older plain scheme of
``core/distributed.py`` over one shard per visible GPU (one CPU shard
with ``--device cpu``).  ``--checkpoint-dir`` runs the steps as a
checkpointed resumable campaign (``--every`` temporal blocks a leg,
``--resume auto|never|always``); ``--kill-after-leg K`` SIGKILLs the
process once leg K's checkpoint has landed (exit 137), for
crash-restart tests.  ``--device`` defaults to the card.
"""
from __future__ import annotations

import argparse
import math
import time

import torch

import numpy as np

from repro_torch.api import (Boundary, compile_stencil, define_stencil,
                             parse_taps, spec_from_json)
from repro_torch.core import roofline as rl
from repro_torch.core.stencil_spec import TABLE2, StencilSpec, get
from repro_torch.kernels import ref
from repro_torch.stencils.data import init_domain, reduced_domain


def parse_mesh(text: str) -> tuple[int, ...]:
    """'8' | '2x4' | '2,4' → mesh shape tuple (axis k shards tensor dim k)."""
    try:
        shape = tuple(int(p) for p in text.replace(",", "x").split("x"))
        if not shape or any(n < 1 for n in shape):
            raise ValueError
        return shape
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"bad mesh {text!r}; use an int ('8') or a shape ('2x4')")


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


def _mesh_for(mesh_shape, device):
    """The stencil mesh of ``mesh_shape``, granting the shards it needs:
    CPU shards with ``device="cpu"``, else the visible GPUs cycled."""
    from repro_torch.core.device import resolve_device
    from repro_torch.launch.mesh import ensure_fake_devices, make_stencil_mesh

    device = resolve_device(device)
    n = math.prod(mesh_shape)
    return make_stencil_mesh(mesh_shape, devices=ensure_fake_devices(
        n, "cpu" if device.type == "cpu" else "cuda"))


def _mesh_domain(spec: StencilSpec, mesh_shape, scale: int,
                 t: int | None) -> tuple[int, ...]:
    """The reduced domain, each sharded dim rounded up to uniform shards
    wide enough for the block halo."""
    shape = list(reduced_domain(spec, scale))
    for d, n in enumerate(mesh_shape):
        min_shard = (t or 2) * spec.radius + 1
        shape[d] = n * max(-(-shape[d] // n), min_shard)
    return tuple(shape)


def run_sharded(spec: StencilSpec | str, mesh_shape: tuple[int, ...], *,
                t: int | None = None, scale: int = 64,
                boundary: Boundary | None = None, total_t: int | None = None,
                device=None, check: bool = True) -> torch.Tensor:
    """Drive ``compile_stencil(..., mesh=)`` + ``run_sharded`` end to end:
    shard the domain over the mesh, run ``T`` steps with one deep-halo
    exchange per temporal block, and (optionally) check against the
    per-step oracle.  Domain dims are rounded up to shard uniformly."""
    from repro_torch.api import planned_exchange_rounds
    from repro_torch.core.distributed import ppermute
    from repro_torch.launch.mesh import device_summary

    spec = get(spec) if isinstance(spec, str) else spec
    boundary = boundary or Boundary.dirichlet(0.0)
    shape = _mesh_domain(spec, mesh_shape, scale, t)
    if t is None:
        # default depth: run_single's cap, further bounded so the block
        # halo t*radius fits inside one shard (one neighbour hop)
        caps = [shape[d] // n // spec.radius
                for d, n in enumerate(mesh_shape) if n > 1]
        cap = min(caps) - (boundary.kind == "reflect") if caps else 6
        t = max(1, min(6, cap))
    mesh = _mesh_for(mesh_shape, device)
    prog = compile_stencil(spec, shape, t=t, boundary=boundary, mesh=mesh)
    total = total_t if total_t is not None else 2 * prog.t + 1
    x = init_domain(spec, shape, device=prog.device)
    t0 = time.perf_counter()
    before = ppermute.calls
    y = prog.run_sharded(x, total)
    copies = ppermute.calls - before
    _sync(prog.device)
    dt = time.perf_counter() - t0
    rounds = planned_exchange_rounds(total, prog.t)
    line = (f"[sharded] {spec.name:11s} domain={shape} "
            f"mesh={'x'.join(map(str, mesh_shape))} "
            f"devices={device_summary(mesh.devices.flat)} T={total} "
            f"t={prog.t} exchanges={rounds} (vs {total} per-step) "
            f"ppermutes={copies} {dt * 1e3:.1f}ms")
    if check:
        want = ref.reference(x, spec, total, boundary=boundary)
        err = float((y - want).abs().max())
        line += f" maxerr={err:.2e}"
        assert err < 1e-4, line
    print(line, flush=True)
    return y


def run_campaign_cli(spec: StencilSpec | str, *, checkpoint_dir: str,
                     mesh_shape: tuple[int, ...] | None = None,
                     t: int | None = None, scale: int = 64,
                     boundary: Boundary | None = None,
                     total_t: int | None = None, every: int = 1,
                     resume: str = "auto", kill_after_leg: int | None = None,
                     out: str | None = None, device=None):
    """Drive a checkpointed campaign: ``T`` steps as legs of ``every``
    temporal blocks, checkpointing into ``checkpoint_dir``, resumable
    after a crash and bit-exact equal to the uninterrupted run.
    ``kill_after_leg`` SIGKILLs the process after that leg's checkpoint
    lands — the crash-restart smoke:

        python -m repro_torch.launch.stencil_run --stencil j2d5pt \\
            --checkpoint-dir /tmp/ck --T 24 --kill-after-leg 2  # dies (137)
        python -m repro_torch.launch.stencil_run --stencil j2d5pt \\
            --checkpoint-dir /tmp/ck --T 24 --resume auto --out y.npy
    """
    from repro_torch.resilient import CampaignStore

    spec = get(spec) if isinstance(spec, str) else spec
    boundary = boundary or Boundary.dirichlet(0.0)
    if mesh_shape:
        shape = _mesh_domain(spec, mesh_shape, scale, t)
        prog = compile_stencil(spec, shape, t=t or 2, boundary=boundary,
                               mesh=_mesh_for(mesh_shape, device))
    else:
        shape = reduced_domain(spec, scale)
        prog = compile_stencil(spec, shape, t=t, boundary=boundary,
                               device=device)
    total = total_t if total_t is not None else 2 * prog.t + 1
    x = init_domain(spec, shape, device=prog.device)
    store = CampaignStore(checkpoint_dir)
    on_leg = None
    if kill_after_leg is not None:
        import os
        import signal

        def on_leg(leg, steps_done):
            if leg >= kill_after_leg:
                store.wait()     # the landed checkpoint survives the kill
                print(f"[campaign] injected crash after leg {leg} "
                      f"({steps_done}/{total} steps)", flush=True)
                os.kill(os.getpid(), signal.SIGKILL)

    t0 = time.perf_counter()
    runner = (prog.run_sharded_resumable if mesh_shape
              else prog.run_resumable)
    rep = runner(x, total, store=store, every=every, resume=resume,
                 on_leg=on_leg)
    _sync(prog.device)
    dt = time.perf_counter() - t0
    resumed = (f" resumed@leg{rep.resumed_from}"
               if rep.resumed_from is not None else "")
    print(f"[campaign] {spec.name:11s} domain={shape} T={total} "
          f"t={prog.t} legs={rep.legs_total} every={every}"
          f"{resumed} ckpts={rep.checkpoints_written} "
          f"rms={rep.final_rms:.4g} device={prog.device} "
          f"{dt * 1e3:.1f}ms", flush=True)
    if out:
        np.save(out, rep.result.cpu().numpy())
        print(f"[campaign] final field -> {out}", flush=True)
    return rep


def run_distributed(name: str, *, t_total: int = 4, t_block: int = 2,
                    scale: int = 64, shards: int | None = None,
                    device=None) -> torch.Tensor:
    """The older plain scheme (``core/distributed.make_distributed_stencil``)
    over a 1-D mesh of ``shards`` devices sharding dim 0: by default one
    shard per visible GPU, or one CPU shard with ``device="cpu"``."""
    from repro_torch.core.device import resolve_device
    from repro_torch.core.distributed import make_distributed_stencil
    from repro_torch.launch.mesh import device_summary, make_mesh

    spec = get(name)
    device = resolve_device(device)
    if shards is None:
        shards = 1 if device.type == "cpu" else torch.cuda.device_count()
    devices = ([device] * shards if device.type == "cpu" or shards == 1
               else None)
    mesh = make_mesh((shards,), ("data",), devices=devices)
    shape = list(reduced_domain(spec, scale))
    shape[0] = (shape[0] + shards - 1) // shards * shards
    fn, layout = make_distributed_stencil(spec, mesh, {0: "data"},
                                          tuple(shape), t_total, t_block)
    x = init_domain(spec, tuple(shape), device=device)
    t0 = time.perf_counter()
    y = layout.assemble(fn(layout.split(x)), device)
    _sync(device)
    dt = time.perf_counter() - t0
    want = ref.reference(x, spec, t_total)
    err = float((y - want).abs().max())
    print(f"[stencil-dist] {name:11s} domain={tuple(shape)} shards={shards} "
          f"devices={device_summary(mesh.devices.flat)} "
          f"t={t_total}(x{t_block}) {dt * 1e3:.1f}ms maxerr={err:.2e}",
          flush=True)
    assert err < 1e-4
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
    ap.add_argument("--mesh", type=parse_mesh, default=None,
                    metavar="N|ZxY",
                    help="device mesh for run_sharded (axis k shards dim "
                         "k): CPU shards with --device cpu, the visible "
                         "GPUs cycled on the card")
    ap.add_argument("--T", type=int, default=None, dest="total_t",
                    help="total steps of a --system, --mesh or "
                         "--checkpoint-dir run (default 2*t+1)")
    ap.add_argument("--distributed", action="store_true",
                    help="the plain deep-halo scheme of "
                         "core/distributed.py, one shard per visible GPU")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="run as a checkpointed resumable campaign into DIR")
    ap.add_argument("--resume", default="auto",
                    choices=("auto", "never", "always"),
                    help="campaign resume mode (default auto: pick up the "
                         "newest good checkpoint in --checkpoint-dir)")
    ap.add_argument("--every", type=int, default=1, metavar="N",
                    help="temporal blocks per campaign leg (default 1)")
    ap.add_argument("--kill-after-leg", type=int, default=None, metavar="K",
                    help="SIGKILL the process after leg K's checkpoint "
                         "lands (crash-restart testing)")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="np.save the final field of one stencil to FILE")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the card")
    args = ap.parse_args(argv)
    if args.taps and args.spec_json:
        ap.error("--taps and --spec-json are mutually exclusive")
    if args.mesh and args.distributed:
        ap.error("--mesh (run_sharded) and --distributed (the plain "
                 "reference scheme) are mutually exclusive")
    if args.checkpoint_dir and args.distributed:
        ap.error("--checkpoint-dir (resumable campaigns) drives compiled "
                 "programs; --distributed is the plain reference scheme")
    if args.kill_after_leg is not None and not args.checkpoint_dir:
        ap.error("--kill-after-leg needs --checkpoint-dir")
    if args.system:
        if args.taps or args.spec_json or args.out or args.mesh \
                or args.distributed or args.checkpoint_dir:
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
        if args.distributed:
            ap.error("--distributed drives the Table-2 suite; custom specs "
                     "run single-device (for now)")
        specs, summary = [spec], True
    else:
        names = (list(TABLE2) if args.stencil == "all"
                 else args.stencil.split(","))
        specs, summary = names, False
    if args.out and len(specs) > 1:
        ap.error("--out saves one field: name one stencil")
    if args.checkpoint_dir:
        if len(specs) > 1:
            ap.error("--checkpoint-dir runs one campaign: name one stencil")
        run_campaign_cli(
            specs[0], checkpoint_dir=args.checkpoint_dir,
            mesh_shape=args.mesh, t=args.t, scale=args.scale,
            boundary=args.boundary, total_t=args.total_t, every=args.every,
            resume=args.resume, kill_after_leg=args.kill_after_leg,
            out=args.out, device=args.device)
        return
    for spec in specs:
        if args.mesh:
            if summary:
                print(cost_summary_line(spec), flush=True)
            y = run_sharded(spec, args.mesh, t=args.t, scale=args.scale,
                            boundary=args.boundary, total_t=args.total_t,
                            device=args.device)
        elif args.distributed:
            y = run_distributed(spec, scale=args.scale, device=args.device)
        else:
            y = run_single(spec, t=args.t, scale=args.scale,
                           boundary=args.boundary, device=args.device,
                           summary=summary)
    if args.out:
        np.save(args.out, y.cpu().numpy())
        print(f"[stencil] final field -> {args.out}", flush=True)


if __name__ == "__main__":
    main()

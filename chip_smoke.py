#!/usr/bin/env python3
"""Smoke test and measurement of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one card

It builds the port's two CUDA kernels from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, started together), then drives the port's main
path — ``compile_stencil(...).apply`` and ``.run`` — in two counted runs:

* 2-D (``stencil2d``): the four 2-D Table-2 stencils at their Table-2
  domains (8352², 8064², 8784², 8640²), f32, at the EBISU depth of
  Table 3 (t = 12, 8, 6, 4), plus one periodic and one f64 program of
  j2d5pt;
* 3-D (``stencil3d``): the five 3-D Table-2 stencils at the paper's
  2560×288×384, f32, at t = 8, 5, 6, 5, 6, plus one periodic and one f64
  program of j3d7pt, and one ``mode="stream"`` apply of j2d5pt at 8352²
  (the 2-D field streamed through the 3-D kernel as 8352×1×8352).

Both kernels' launch counts are zeroed just before each run and read
just after it, and must show every launch the sweep schedules call for.

Then, outside the counted run, it holds every result against the port's
plain PyTorch oracle on the card (max |err| < 1e-4 in f32, < 1e-10 in
f64), holds each kernel against its plain version on the main path's own
padded inputs (the 3-D kernel also against a second launch, bit for
bit), and times with CUDA events (warm-up, then the median of 20
launches): the kernel's ms per sweep (f32, and f64 as the paper ran),
the plain version's, ``.run``'s end to end, and a yardstick,
``library_ms`` = ``t`` chained ``torch.nn.functional.conv2d`` (3-D:
``conv3d``) calls with zero padding and TF32 off (the port never calls
it).  The bound of a sweep is the larger of its bytes (the ``height × width``
domain read once, the padded layout the next sweep reads written once;
the kernel reads no padded cell) over 3.35 TB/s and its
``flops_per_cell·t·cells`` over 67 TFLOP/s fp32 (34 fp64), the H100 SXM
datasheet peaks; ``bound_copy_ms`` puts the measured device-to-device
copy rate in place of 3.35 TB/s.  ``ms_f32_at_f64_tile`` times the f32
sweep at the smaller tile the planner picks for f64, which tells the
tile's cost from the type's.

The last lines are the card's ``name, power.limit``, one JSON object of
the kernels, and ``{"ok": true, "device": {...}}``.  Any failed phase
raises, and the script exits non-zero without printing that last line;
so it does without a CUDA device or outside a checkout.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPLACES = "src/repro/kernels/stencil2d.py:54"
SOURCE = "src/repro_torch/kernels/csrc/stencil2d.cu"
REPLACES_3D = "src/repro/kernels/stencil3d.py:134"
SOURCE_3D = "src/repro_torch/kernels/csrc/stencil3d.cu"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED {what}")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn, reps: int, warmup: int) -> float:
    """Median over ``reps`` of one call of ``fn``, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.api import Boundary, compile_stencil
    from repro_torch.core.roofline import H100, hardware_for
    from repro_torch.core.stencil_spec import TABLE3_DEPTHS, get
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import stencil2d as st
    from repro_torch.kernels import stencil3d as st3
    from repro_torch.stencils.data import init_domain

    dev = torch.device("cuda", 0)
    smi = smi_line()
    print(f"[card] {smi}", flush=True)
    hw = hardware_for(dev)
    print(f"[card] {hw.sm_count} SMs, {int(hw.onchip_bytes)} B shared memory "
          f"per block, {int(hw.l2_bytes)} B L2 (the planner's model "
          f"{hw.name})", flush=True)
    print(f"[versions] python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}", flush=True)

    # ---- build ---------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:   # one nvcc each
        logs = dict(zip(_build.SOURCES, pool.map(_build.build,
                                                 _build.SOURCES)))
    print(f"[build] {time.perf_counter() - t0:.2f}s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    # ---- the 2-D main path, counted -------------------------------------
    names = ["j2d5pt", "j2d9pt", "j2d9pt-gol", "j2d25pt"]
    cases = {}
    st.ebisu2d_padded.launches = 0
    st3.ebisu3d_padded.launches = 0
    for name in names:
        spec = get(name)
        t = TABLE3_DEPTHS[name]["ebisu"]
        before = st.ebisu2d_padded.launches
        t0 = time.perf_counter()
        prog = compile_stencil(spec, spec.domain, t=t)
        x = init_domain(spec, device=dev, seed=0)
        y1 = prog.apply(x)
        yT = prog.run(x, 2 * t + 1)
        torch.cuda.synchronize()
        cases[name] = dict(prog=prog, x=x, y1=y1, yT=yT, t=t,
                           launches=st.ebisu2d_padded.launches - before,
                           host_s=time.perf_counter() - t0)
    j5 = get("j2d5pt")
    x5 = cases["j2d5pt"]["x"]
    prog_p = compile_stencil(j5, j5.domain, t=12,
                             boundary=Boundary.periodic())
    y_per = prog_p.run(x5, 25)
    prog_d = compile_stencil(j5, j5.domain, t=12, dtype=torch.float64)
    x5d = x5.double()
    y_d1 = prog_d.apply(x5d)
    y_dT = prog_d.run(x5d, 25)
    torch.cuda.synchronize()
    launches = st.ebisu2d_padded.launches
    print(f"[main path] stencil2d launches: {launches}", flush=True)
    check(st3.ebisu3d_padded.launches == 0, "the 2-D path launched stencil3d")
    # apply = 1 sweep; run(2t+1) = sweeps of t, t, 1 — for every program
    for name, c in cases.items():
        check(c["launches"] == 4, f"{name}: {c['launches']} launches, not 4")
    check(launches == 4 * len(names) + 3 + 4,
          f"main path launched the kernel {launches} times, not "
          f"{4 * len(names) + 7}")

    # ---- correctness, uncounted -----------------------------------------
    max_err = 0.0

    def held(got, want, tol, what):
        err = float((got.double() - want.double()).abs().max())
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
        check(err < tol, f"{what}: max|err| {err:.3e} >= {tol:g}")
        print(f"[check] {what}: max|err| {err:.3e} (< {tol:g})", flush=True)
        return err

    for name, c in cases.items():
        spec, prog, x, t = get(name), c["prog"], c["x"], c["t"]
        check(c["y1"].shape == x.shape and c["yT"].shape == x.shape,
              f"{name}: output shape")
        held(c["y1"], ref.reference(x, spec, t), 1e-4,
             f"{name} apply(t={t}) vs oracle")
        held(c["yT"], ref.reference(x, spec, 2 * t + 1), 1e-4,
             f"{name} run({2 * t + 1}) vs oracle")
        g = prog.geometry()
        (bh, bw), (hp, wp) = g["block"], g["padded"]
        xp = torch.zeros((hp, wp), dtype=torch.float32, device=dev)
        xp[:x.shape[0], :x.shape[1]] = x
        got = st.ebisu2d_padded(xp, spec, t, height=x.shape[0],
                                width=x.shape[1], bh=bh, bw=bw)
        want = st.ebisu2d_padded_plain(xp, spec, t, height=x.shape[0],
                                       width=x.shape[1])
        max_err = max(max_err, held(got, want, 1e-4,
                                    f"{name} kernel vs plain sweep"))
        c.update(xp=xp, geometry=g)
    held(y_per, ref.reference(x5, j5, 25, boundary=Boundary.periodic()),
         1e-4, "j2d5pt periodic run(25) vs oracle")
    held(y_d1, ref.reference(x5d, j5, 12), 1e-10, "j2d5pt f64 apply(12)")
    held(y_dT, ref.reference(x5d, j5, 25), 1e-10, "j2d5pt f64 run(25)")
    g = prog_d.geometry()
    xpd = torch.zeros(g["padded"], dtype=torch.float64, device=dev)
    xpd[:x5d.shape[0], :x5d.shape[1]] = x5d
    max_err = max(max_err, held(
        st.ebisu2d_padded(xpd, j5, 12, height=j5.domain[0],
                          width=j5.domain[1], bh=g["block"][0],
                          bw=g["block"][1]),
        st.ebisu2d_padded_plain(xpd, j5, 12, height=j5.domain[0],
                                width=j5.domain[1]),
        1e-10, "j2d5pt f64 kernel vs plain sweep"))

    # ---- timing, uncounted ----------------------------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    buf = torch.empty_like(cases["j2d5pt"]["xp"])
    src = cases["j2d5pt"]["xp"]
    copy_ms = median_ms(lambda: buf.copy_(src), 20, 3)
    copy_bps = 2 * src.numel() * src.element_size() / (copy_ms * 1e-3)
    print(f"[timing] device-to-device copy {copy_bps / 1e9:.1f} GB/s",
          flush=True)
    rows = []
    for name, c in cases.items():
        spec, t, x, xp, g = get(name), c["t"], c["x"], c["xp"], c["geometry"]
        (bh, bw), (hp, wp) = g["block"], g["padded"]
        height, width = x.shape
        out = torch.empty_like(xp)
        kern_ms = median_ms(lambda: st.ebisu2d_padded(
            xp, spec, t, height=height, width=width, bh=bh, bw=bw, out=out),
            20, 3)
        plain_ms = median_ms(lambda: st.ebisu2d_padded_plain(
            xp, spec, t, height=height, width=width), 10, 1)
        rad = spec.radius
        w = torch.zeros((1, 1, 2 * rad + 1, 2 * rad + 1), device=dev)
        for (dy, dx), coef in spec.taps:
            w[0, 0, dy + rad, dx + rad] = coef

        def library(v=x[None, None]):
            for _ in range(t):
                v = F.conv2d(v, w, padding=rad)
            return v

        lib_ms = median_ms(library, 10, 1)
        held(library()[0, 0], c["y1"], 1e-4, f"{name} conv2d yardstick")
        run_ms = median_ms(lambda: c["prog"].run(x, 2 * t + 1), 5, 1)
        nbytes = (height * width + hp * wp) * xp.element_size()
        flops = spec.flops_per_cell * t * height * width
        t_bytes, t_ops = nbytes / H100.b_gm, flops / H100.thr_cmp
        # the paper's own setting: the same sweep in f64, at the f64 tile
        gd = compile_stencil(spec, spec.domain, t=t,
                             dtype=torch.float64).geometry()
        xpd = torch.zeros(gd["padded"], dtype=torch.float64, device=dev)
        xpd[:height, :width] = x
        outd = torch.empty_like(xpd)
        ms_f64 = median_ms(lambda: st.ebisu2d_padded(
            xpd, spec, t, height=height, width=width, bh=gd["block"][0],
            bw=gd["block"][1], out=outd), 20, 3)
        bound_f64 = max((height * width + xpd.numel()) * 8 / H100.b_gm,
                        flops / H100.thr_cmp_fp64)
        # the f32 sweep at the f64 tile: the tile's cost apart from the type
        xpf, outf = xpd.float(), outd.float()
        del xpd, outd
        held(st.ebisu2d_padded(xpf, spec, t, height=height, width=width,
                               bh=gd["block"][0], bw=gd["block"][1],
                               out=outf)[:height, :width], c["y1"], 1e-4,
             f"{name} f32 kernel at the f64 tile vs apply")
        ms_f32_small = median_ms(lambda: st.ebisu2d_padded(
            xpf, spec, t, height=height, width=width, bh=gd["block"][0],
            bw=gd["block"][1], out=outf), 20, 3)
        del xpf, outf
        row = dict(stencil=name, t=t, domain=[height, width],
                   tile=[bh, bw], padded=[hp, wp],
                   smem_bytes=g["smem_bytes"], ms=kern_ms,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bound_copy_ms=max(nbytes / copy_bps, t_ops) * 1e3,
                   roofline_share=max(t_bytes, t_ops) / (kern_ms * 1e-3),
                   gb_per_s=nbytes / (kern_ms * 1e-3) / 1e9,
                   cell_steps_per_s=height * width * t / (kern_ms * 1e-3),
                   tile_f64=list(gd["block"]), ms_f64=ms_f64,
                   ms_f32_at_f64_tile=ms_f32_small,
                   bound_ms_f64=bound_f64 * 1e3,
                   launches=c["launches"], run_steps=2 * t + 1,
                   run_ms=run_ms,
                   run_cell_steps_per_s=height * width * (2 * t + 1)
                   / (run_ms * 1e-3),
                   host_s_first_call=c["host_s"])
        rows.append(row)
        print("[timing] " + json.dumps(row), flush=True)

    entry_2d = kernel_entry("stencil2d", SOURCE, REPLACES, launches,
                            max_err, rows,
                            "sums of one sweep of each 2-D Table-2 stencil "
                            "at its Table-2 domain and EBISU depth, f32")
    del cases, x5, x5d, y_per, y_d1, y_dT, buf, src
    torch.cuda.empty_cache()

    entry_3d = three_d(dev, held)
    print(f"[card] {smi_line()}", flush=True)
    print(json.dumps({"kernels": [entry_2d, entry_3d]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def kernel_entry(name, source, replaces, launches, max_err, rows,
                 times_are, **extra) -> dict:
    """One kernel's object of the ``kernels`` line: the per-stencil rows
    and their sums."""
    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": max_err,
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": ("bytes" if sum(r["bound_by"] == "bytes" for r in rows)
                     * 2 >= len(rows) else "operations"),
        "library_ms": total["library_ms"], "times_are": times_are,
        "per_stencil": rows, **extra}


def three_d(dev, held) -> dict:
    """The 3-D main path, counted; then its checks and timings,
    uncounted.  Returns the ``stencil3d`` entry of the ``kernels`` line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.api import Boundary, compile_stencil
    from repro_torch.core.roofline import H100
    from repro_torch.core.stencil_spec import (TABLE3_DEPTHS, get,
                                               lift_2d_to_3d)
    from repro_torch.kernels import ref
    from repro_torch.kernels import stencil2d as st
    from repro_torch.kernels import stencil3d as st3
    from repro_torch.stencils.data import init_domain

    names = ["j3d7pt", "j3d13pt", "j3d17pt", "j3d27pt", "poisson"]
    cases = {}
    st.ebisu2d_padded.launches = 0
    st3.ebisu3d_padded.launches = 0
    for name in names:
        spec = get(name)
        t = TABLE3_DEPTHS[name]["ebisu"]
        before = st3.ebisu3d_padded.launches
        t0 = time.perf_counter()
        prog = compile_stencil(spec, spec.domain, t=t)
        x = init_domain(spec, seed=0)
        y1 = prog.apply(x)
        yT = prog.run(x, 2 * t + 1)
        torch.cuda.synchronize()
        cases[name] = dict(prog=prog, x=x, y1=y1, yT=yT, t=t,
                           launches=st3.ebisu3d_padded.launches - before,
                           host_s=time.perf_counter() - t0)
    j7 = get("j3d7pt")
    x7 = cases["j3d7pt"]["x"]
    y_per = compile_stencil(j7, j7.domain, t=8,
                            boundary=Boundary.periodic()).run(x7, 17)
    prog_d = compile_stencil(j7, j7.domain, t=8, dtype=torch.float64)
    x7d = x7.double()
    y_d1 = prog_d.apply(x7d)
    y_dT = prog_d.run(x7d, 17)
    j5 = get("j2d5pt")
    prog_s = compile_stencil(j5, j5.domain, t=12, mode="stream")
    x5 = init_domain(j5, seed=0)
    before = st3.ebisu3d_padded.launches
    y_s = prog_s.apply(x5)
    stream_launches = st3.ebisu3d_padded.launches - before
    torch.cuda.synchronize()
    launches = st3.ebisu3d_padded.launches
    print(f"[main path 3-D] stencil3d launches: {launches}", flush=True)
    check(st.ebisu2d_padded.launches == 0, "the 3-D path launched stencil2d")
    for name, c in cases.items():
        check(c["launches"] == 4, f"{name}: {c['launches']} launches, not 4")
    check(stream_launches == 1,
          f"stream apply: {stream_launches} launches, not 1")
    want = 4 * len(names) + 3 + 4 + 1
    check(launches == want,
          f"3-D path launched the kernel {launches} times, not {want}")

    # ---- correctness, uncounted -----------------------------------------
    max_err = 0.0

    def kernel_vs_plain(spec, t, x, g, dtype, tol, what):
        """The kernel twice (bit-identical) and its plain version, on the
        main path's own padded input; returns the padded input."""
        xp = torch.zeros(g["padded"], dtype=dtype, device=dev)
        if x.dim() == 2:
            xp[:x.shape[0], 0, :x.shape[1]] = x
            shape = (x.shape[0], 1, x.shape[1])
        else:
            xp[:x.shape[0], :x.shape[1], :x.shape[2]] = x
            shape = tuple(x.shape)
        kw = dict(zip(("zdim", "ydim", "xdim"), shape))
        zc, ty, tx = g["block"]
        got = st3.ebisu3d_padded(xp, spec, t, zc=zc, ty=ty, tx=tx, **kw)
        again = st3.ebisu3d_padded(xp, spec, t, zc=zc, ty=ty, tx=tx, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{what}: a second launch differs")
        err = held(got, st3.ebisu3d_padded_plain(xp, spec, t, **kw), tol,
                   f"{what} kernel vs plain sweep (repeat bit-identical)")
        return xp, err

    for name, c in cases.items():
        spec, prog, x, t = get(name), c["prog"], c["x"], c["t"]
        check(c["y1"].shape == x.shape and c["yT"].shape == x.shape,
              f"{name}: output shape")
        held(c["y1"], ref.reference(x, spec, t), 1e-4,
             f"{name} apply(t={t}) vs oracle")
        held(c["yT"], ref.reference(x, spec, 2 * t + 1), 1e-4,
             f"{name} run({2 * t + 1}) vs oracle")
        c["geometry"] = prog.geometry()
        del c["yT"]
    held(y_per, ref.reference(x7, j7, 17, boundary=Boundary.periodic()),
         1e-4, "j3d7pt periodic run(17) vs oracle")
    held(y_d1, ref.reference(x7d, j7, 8), 1e-10, "j3d7pt f64 apply(8)")
    held(y_dT, ref.reference(x7d, j7, 17), 1e-10, "j3d7pt f64 run(17)")
    del y_per, y_d1, y_dT
    g = prog_d.geometry()
    xpd, err = kernel_vs_plain(j7, 8, x7d, g, torch.float64, 1e-10,
                               "j3d7pt f64")
    max_err = max(max_err, err)
    del xpd, x7d
    held(y_s, ref.reference(x5, j5, 12), 1e-4,
         "j2d5pt stream apply(12) vs oracle")
    lifted = prog_s.geometry()
    xps, err = kernel_vs_plain(lift_2d_to_3d(j5), 12, x5, lifted,
                               torch.float32, 1e-4, "j2d5pt stream")
    max_err = max(max_err, err)
    torch.cuda.empty_cache()

    # ---- timing, uncounted, one stencil at a time -----------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def bound(cells, padded, t, flops_per_cell, itemsize, fp64=False):
        nbytes = (cells + padded) * itemsize
        flops = flops_per_cell * t * cells
        t_bytes = nbytes / H100.b_gm
        t_ops = flops / (H100.thr_cmp_fp64 if fp64 else H100.thr_cmp)
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations"), nbytes

    rows = []
    for name in names:
        c = cases.pop(name)
        spec, t, x, g = get(name), c["t"], c["x"], c["geometry"]
        zc, ty, tx = g["block"]
        cells = x.numel()
        xp, err = kernel_vs_plain(spec, t, x, g, torch.float32, 1e-4, name)
        max_err = max(max_err, err)
        kw = dict(zip(("zdim", "ydim", "xdim"), x.shape))
        out = torch.empty_like(xp)
        kern_ms = median_ms(lambda: st3.ebisu3d_padded(
            xp, spec, t, zc=zc, ty=ty, tx=tx, out=out, **kw), 20, 3)
        plain_ms = median_ms(lambda: st3.ebisu3d_padded_plain(
            xp, spec, t, **kw), 5, 1)
        rad = spec.radius
        w = torch.zeros((1, 1) + (2 * rad + 1,) * 3, device=dev)
        for (dz, dy, dx), coef in spec.taps:
            w[0, 0, dz + rad, dy + rad, dx + rad] = coef

        def library(v=x[None, None]):
            for _ in range(t):
                v = F.conv3d(v, w, padding=rad)
            return v

        lib_ms = median_ms(library, 5, 1)
        held(library()[0, 0], c["y1"], 1e-4, f"{name} conv3d yardstick")
        del c["y1"]
        run_ms = median_ms(lambda: c["prog"].run(x, 2 * t + 1), 5, 1)
        b_s, b_by, nbytes = bound(cells, xp.numel(), t, spec.flops_per_cell,
                                  4)
        del xp, out
        gd = compile_stencil(spec, spec.domain, t=t,
                             dtype=torch.float64).geometry()
        xpd = torch.zeros(gd["padded"], dtype=torch.float64, device=dev)
        xpd[:x.shape[0], :x.shape[1], :x.shape[2]] = x
        outd = torch.empty_like(xpd)
        ms_f64 = median_ms(lambda: st3.ebisu3d_padded(
            xpd, spec, t, zc=gd["block"][0], ty=gd["block"][1],
            tx=gd["block"][2], out=outd, **kw), 20, 3)
        b64, _, _ = bound(cells, xpd.numel(), t, spec.flops_per_cell, 8,
                          fp64=True)
        del xpd, outd, x
        torch.cuda.empty_cache()
        row = dict(stencil=name, t=t, domain=list(spec.domain),
                   tile=[zc, ty, tx], grid=list(g["grid"]),
                   padded=list(g["padded"]), smem_bytes=g["smem_bytes"],
                   ms=kern_ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b_s * 1e3, bound_by=b_by,
                   roofline_share=b_s / (kern_ms * 1e-3),
                   gb_per_s=nbytes / (kern_ms * 1e-3) / 1e9,
                   gflop_per_s=spec.flops_per_cell * t * cells
                   / (kern_ms * 1e-3) / 1e9,
                   cell_steps_per_s=cells * t / (kern_ms * 1e-3),
                   tile_f64=list(gd["block"]), ms_f64=ms_f64,
                   bound_ms_f64=b64 * 1e3, launches=c["launches"],
                   run_steps=2 * t + 1, run_ms=run_ms,
                   run_cell_steps_per_s=cells * (2 * t + 1)
                   / (run_ms * 1e-3),
                   host_s_first_call=c["host_s"])
        rows.append(row)
        print("[timing] " + json.dumps(row), flush=True)

    # the stream sweep: j2d5pt at 8352² as 8352×1×8352, t=12
    zc, ty, tx = lifted["block"]
    kw = dict(zdim=j5.domain[0], ydim=1, xdim=j5.domain[1])
    spec_l = lift_2d_to_3d(j5)
    outs = torch.empty_like(xps)
    s_ms = median_ms(lambda: st3.ebisu3d_padded(
        xps, spec_l, 12, zc=zc, ty=ty, tx=tx, out=outs, **kw), 20, 3)
    s_plain = median_ms(lambda: st3.ebisu3d_padded_plain(
        xps, spec_l, 12, **kw), 5, 1)
    b_s, b_by, nbytes = bound(x5.numel(), xps.numel(), 12,
                              j5.flops_per_cell, 4)
    stream = dict(stencil="j2d5pt stream", t=12, domain=list(j5.domain),
                  tile=[zc, ty, tx], grid=list(lifted["grid"]),
                  padded=list(lifted["padded"]),
                  smem_bytes=lifted["smem_bytes"], ms=s_ms,
                  plain_ms=s_plain, bound_ms=b_s * 1e3, bound_by=b_by,
                  roofline_share=b_s / (s_ms * 1e-3),
                  gb_per_s=nbytes / (s_ms * 1e-3) / 1e9,
                  launches=stream_launches)
    print("[timing] " + json.dumps(stream), flush=True)
    return kernel_entry(
        "stencil3d", SOURCE_3D, REPLACES_3D, launches, max_err, rows,
        "sums of one sweep of each 3-D Table-2 stencil at 2560x288x384 "
        "and EBISU depth, f32; the stream sweep is listed apart",
        stream=stream)


if __name__ == "__main__":
    sys.exit(main())

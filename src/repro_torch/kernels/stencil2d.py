"""EBISU-2D on the card: the wrapper of the CUDA tile kernel
(``csrc/stencil2d.cu``) and its plain PyTorch version.

Counterpart of the reference's Pallas strip kernel
(``repro/kernels/stencil2d.py::_strip_kernel``, launched by
``ebisu2d_padded``).  The function both compute is one *sweep* on the
padded layout: ``xp`` is ``(hp, wp)`` with the ``height × width`` domain
at the origin and zeros outside it; the result is ``t`` zero-Dirichlet
steps of the tap set, in the same layout, again zero outside the domain.
A leading batch axis ``(B, hp, wp)`` holds ``B`` independent fields, all
swept by one launch (the reference vmaps its kernel over it).

  * On a CUDA tensor, :func:`ebisu2d_padded` launches the kernel (or
    raises) and adds one to ``ebisu2d_padded.launches`` (under a lock,
    so threads that launch at once lose no count).
  * On a CPU tensor it runs :func:`ebisu2d_padded_plain`: the tap
    engine's ``chain`` over the padded array, masked to the domain after
    every step.  No CUDA tensor ever takes the plain version.

The kernel tiles both axes: a CTA computes a ``bh × bw`` tile of output
cells from a ``t·rad`` rim on every side, its ``t`` steps ping-ponged
between two shared buffers, each thread computing ``R`` vertically
consecutive cells of a step in registers (:func:`tile_schedule`; see the
source's header).  The source is a template: its taps come from a
header generated per tap set (``kernels/stencil2d_gen.py``), one library
per tap set, built at first use (``_build``).  What bounds it: the
domain read and the padded layout written once against HBM's rate; above
that, the tiles' overlap, the trapezoid's redundant cell-updates and the
instructions around each FMA.  The padded layout rounds rows up to a
multiple of ``bh`` and columns to a multiple of ``bw`` (which is itself a
multiple of one warp, 32 columns); the reference's 128-column padding
was a TPU lane artifact.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.core.planner import (COL_ALIGN, THREADS, _pad_to,
                                      axis_reach, rows_per_thread_2d)
from repro_torch.core.spans import span
from repro_torch.core.stencil_spec import StencilSpec
from repro_torch.kernels import _build, stencil2d_gen
from repro_torch.kernels.taps import engine_for, split_star

MAX_RADIUS = 8
# the most taps a tap-set library is built for: the whole box of the
# largest radius, so every set that validate_spec accepts
MAX_TAPS = (2 * MAX_RADIUS + 1) ** 2
MAX_BATCH = 65535       # fields a launch takes: the grid's z extent


def strip_geometry(spec: StencilSpec, t: int, bh: int,
                   bw: int) -> tuple[int, int, int]:
    """The ``(bh, bw, halo)`` a launch uses: any ``bh ≥ 1`` rows (the
    kernel reads its rim from neighbouring tiles, so ``halo`` may exceed
    ``bh``), ``bw`` rounded up to a multiple of 32 columns."""
    if bh < 1 or bw < 1 or t < 1:
        raise ValueError(f"tile ({bh}, {bw}) and depth t={t} must be >= 1")
    return bh, _pad_to(bw, COL_ALIGN), spec.halo(t)


def padded_shape_2d(spec: StencilSpec, t: int, bh: int, bw: int,
                    height: int, width: int) -> tuple[int, int]:
    """Padded layout of a launch: rows to a multiple of ``bh``, columns
    to a multiple of ``bw`` (both as :func:`strip_geometry` resolves)."""
    bh, bw, _ = strip_geometry(spec, t, bh, bw)
    return _pad_to(height, bh), _pad_to(width, bw)


def tile_schedule(spec: StencilSpec, t: int, bh: int, bw: int,
                  height: int, width: int, itemsize: int = 4) -> dict:
    """What a launch's CTAs compute, counted from its geometry (nothing
    here is measured): per step ``s = 1..t`` the live region ``(ny,
    nx)`` (the output tile widened by ``(t-s)·reach`` per axis), the rows
    a thread computes (``rows``: ``R`` of :func:`rows_per_thread_2d`, or
    1 where the region has fewer), the thread items (a block of rows in
    one column), the passes of the CTA's threads over them and the share
    of those passes' lanes that hold an item (``lane_use``), the
    cell-updates computed (the last block of a column overlaps its
    neighbour) and the shared reads (each column offset once per input
    row some tap of that column needs for the block).  Sums over the
    launch: ``cell_updates`` (the trapezoid's), ``computed_updates``,
    ``shared_reads``; and the CTAs that run the kernel's interior
    variant (``interior_ctas``: the loaded tile inside the domain)."""
    bh, bw, halo = strip_geometry(spec, t, bh, bw)
    hp, wp = padded_shape_2d(spec, t, bh, bw, height, width)
    ry, rx = axis_reach(spec, 0), axis_reach(spec, 1)
    r = rows_per_thread_2d(spec.radius, itemsize, len(spec.taps))
    column_dys = [{dy for dy, _ in terms}
                  for _, terms in stencil2d_gen.tap_columns(spec.taps)]
    steps = []
    for s in range(1, t + 1):
        ny, nx = bh + 2 * (t - s) * ry, bw + 2 * (t - s) * rx
        rows = r if ny >= r else 1
        items = -(-ny // rows) * nx
        passes = -(-items // THREADS)
        steps.append(dict(s=s, ny=ny, nx=nx, rows=rows, items=items,
                          passes=passes,
                          lane_use=items / (passes * THREADS),
                          computed=items * rows,
                          reads=items * sum(
                              len({dy + j for dy in dys for j in range(rows)})
                              for dys in column_dys)))

    def inside(n, tile, reach, dim):
        return sum(1 for i in range(n)
                   if i * tile - t * reach >= 0
                   and (i + 1) * tile + t * reach <= dim)

    grid = (hp // bh, wp // bw)
    ctas = math.prod(grid)
    return dict(grid=grid, rows_per_thread=r, steps=steps, ctas=ctas,
                interior_ctas=(inside(grid[0], bh, ry, height)
                               * inside(grid[1], bw, rx, width)),
                cell_updates=ctas * sum(st["ny"] * st["nx"]
                                        for st in steps),
                computed_updates=ctas * sum(st["computed"] for st in steps),
                shared_reads=ctas * sum(st["reads"] for st in steps))


@functools.lru_cache(maxsize=None)
def kernel_taps(taps) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(dy, dx, coef)`` in the order the plain version sums them: for a
    star set the center, then each axis's arms; otherwise tap order.
    The single source of the tap order: the header generator
    (``stencil2d_gen.tap_columns``) reads it."""
    if len(taps) > MAX_TAPS:
        raise ValueError(f"the CUDA 2-D kernel takes at most {MAX_TAPS} "
                         f"taps (MAX_TAPS); this stencil has {len(taps)}")
    rad = max(max(abs(o) for o in off) for off, _ in taps)
    if rad > MAX_RADIUS:
        raise ValueError(f"the CUDA kernel takes radius <= {MAX_RADIUS}; "
                         f"this stencil has radius {rad}")
    star = split_star(taps, 2)
    if star is None:
        ordered = list(taps)
    else:
        center, arms = star
        ordered = [((0, 0), center)] if center != 0.0 else []
        for axis, axis_arms in enumerate(arms):
            ordered += [((o, 0) if axis == 0 else (0, o), c)
                        for o, c in axis_arms]
    dy = np.array([off[0] for off, _ in ordered], np.int32)
    dx = np.array([off[1] for off, _ in ordered], np.int32)
    coef = np.array([c for _, c in ordered], np.float64)
    return dy, dx, coef


def _check_padded(xp: torch.Tensor, spec: StencilSpec, t: int, height: int,
                  width: int, bh: int, bw: int) -> None:
    if spec.ndim != 2:
        raise ValueError(f"{spec.name} is {spec.ndim}-D; ebisu2d_padded "
                         "takes 2-D stencils")
    if xp.dim() not in (2, 3):
        raise ValueError(f"padded field must be 2-D, or 2-D with a leading "
                         f"batch axis, got shape {tuple(xp.shape)}")
    if xp.dim() == 3 and not 1 <= xp.shape[0] <= MAX_BATCH:
        raise ValueError(f"a launch takes 1 to {MAX_BATCH} fields; the "
                         f"batch axis holds {xp.shape[0]}")
    hp, wp = xp.shape[-2:]
    if hp % bh or wp % bw or height > hp or width > wp:
        raise ValueError(
            f"padded shape {(hp, wp)} must be a multiple of the tile "
            f"({bh}, {bw}) and hold the {height}x{width} domain "
            "(see padded_shape_2d)")


def ebisu2d_padded_plain(xp: torch.Tensor, spec: StencilSpec, t: int, *,
                         height: int, width: int) -> torch.Tensor:
    """The plain version of one sweep: ``t`` masked steps of the tap
    engine over the whole padded array, and each field of a leading batch
    axis (any device)."""
    mask = torch.zeros(xp.shape[-2:], dtype=xp.dtype, device=xp.device)
    mask[:height, :width] = 1
    return engine_for(spec.taps, 2).chain(xp * mask, t, mask)


def ebisu2d_padded(xp: torch.Tensor, spec: StencilSpec, t: int, *,
                   height: int, width: int, bh: int, bw: int,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """One sweep of ``t`` steps on the padded layout, or on each field
    of a batch of them (see the module docstring), in one launch; writes
    into ``out`` when given (it must not alias ``xp``).  CUDA tensors go
    to the kernel, CPU tensors to the plain version."""
    bh, bw, _ = strip_geometry(spec, t, bh, bw)
    with span("repro_torch.launch.stencil2d t={} tile={}x{} batch={}", t, bh,
              bw, xp.shape[0] if xp.dim() == 3 else 1):
        _check_padded(xp, spec, t, height, width, bh, bw)
        if out is None:
            out = torch.empty_like(xp)
        elif (out.shape != xp.shape or out.dtype != xp.dtype
              or out.device != xp.device):
            raise ValueError("out must match xp in shape, dtype and device")
        if xp.device.type == "cpu":
            out.copy_(ebisu2d_padded_plain(xp, spec, t, height=height,
                                           width=width))
            return out
        if xp.device.type != "cuda":
            raise ValueError(f"ebisu2d_padded runs on cuda or cpu tensors, "
                             f"got {xp.device}")
        _launch(xp, out, spec, t, height, width, bh, bw)
    _build.count_launch(ebisu2d_padded)
    return out


ebisu2d_padded.launches = 0


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8 + [
    ctypes.c_void_p]


def tapset_header(spec: StencilSpec) -> str:
    """The generated header of ``spec``'s tap set (refuses what no
    library is built for: more than ``MAX_TAPS`` taps, radius beyond
    ``MAX_RADIUS``)."""
    kernel_taps(spec.taps)
    return stencil2d_gen.header(tuple(spec.taps))


@functools.lru_cache(maxsize=None)
def _entry_points(header: str):
    """``({dtype: launcher}, error_string)`` of one tap set's library,
    built at first use, their argument types set once."""
    lib = _build.library("stencil2d", header)
    fns = {}
    for dtype, name in ((torch.float32, "stencil2d_f32"),
                        (torch.float64, "stencil2d_f64")):
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    err = lib.stencil2d_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fns, err


def _launch(xp: torch.Tensor, out: torch.Tensor, spec: StencilSpec, t: int,
            height: int, width: int, bh: int, bw: int) -> None:
    if xp.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the CUDA kernel computes in float32 or float64, "
                         f"got {xp.dtype}")
    if not (xp.is_contiguous() and out.is_contiguous()):
        raise ValueError("ebisu2d_padded needs contiguous tensors")
    if out.data_ptr() == xp.data_ptr():
        raise ValueError("out must not alias xp: CTAs read xp while others "
                         "write out")
    fns, error_string = _entry_points(tapset_header(spec))
    hp, wp = xp.shape[-2:]
    batch = xp.shape[0] if xp.dim() == 3 else 1
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        err = fns[xp.dtype](xp.data_ptr(), out.data_ptr(), batch, hp, wp,
                            height, width, t, bh, bw, stream)
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(
            f"stencil2d launch failed ({msg}): {spec.name} t={t} tile "
            f"({bh}, {bw}) padded {tuple(xp.shape)} {xp.dtype}")


def ebisu2d(x: torch.Tensor, spec: StencilSpec, t: int, *, bh: int,
            bw: int, compute_dtype=None) -> torch.Tensor:
    """Apply ``t`` zero-Dirichlet temporally-blocked steps of ``spec`` to
    a 2-D field: pad into a ``compute_dtype`` buffer (default float32),
    run one sweep, crop, cast back.  The other boundary kinds are the
    program's (``api.program._build_chain``)."""
    cdtype = compute_dtype or torch.float32
    height, width = x.shape
    hp, wp = padded_shape_2d(spec, t, bh, bw, height, width)
    xp = torch.zeros((hp, wp), dtype=cdtype, device=x.device)
    xp[:height, :width] = x
    out = ebisu2d_padded(xp, spec, t, height=height, width=width, bh=bh,
                         bw=bw)
    return out[:height, :width].to(x.dtype)

"""EBISU-3D on the card: the wrapper of the CUDA z-streaming kernel
(``csrc/stencil3d.cu``) and its plain PyTorch version.

Counterpart of the reference's Pallas streaming kernel
(``repro/kernels/stencil3d.py::_stream_kernel``, launched by
``ebisu3d_padded``).  The function both compute is one *sweep* on the
padded layout: ``xp`` is ``(zp, yp, xp)`` with the ``zdim × ydim × xdim``
domain at the origin and zeros outside it; the result is ``t``
zero-Dirichlet steps of the tap set, in the same layout, again zero
outside the domain.  A leading batch axis ``(B, zp, yp, xp)`` holds ``B``
independent fields, all swept by one launch (the reference vmaps its
kernel over it).

  * On a CUDA tensor, :func:`ebisu3d_padded` launches the kernel (or
    raises) and adds one to ``ebisu3d_padded.launches`` (under a lock,
    so threads that launch at once lose no count).
  * On a CPU tensor it runs :func:`ebisu3d_padded_plain`: the tap
    engine's ``chain`` over the padded array, masked to the domain after
    every step.  No CUDA tensor ever takes the plain version.

A CTA computes a ``(zc, ty, tx)`` tile of output cells, streaming its z
column through ``t`` time levels, ``B`` planes per barrier, with each
cell's z partial sums in registers (see the source's header).  The
source is a template: its taps come from a header generated per tap set
(``kernels/stencil3d_gen.py``), one library per tap set, built at first
use (``_build``).
The layout pads z to a multiple of ``zc`` and each tiled in-plane axis to
a multiple of its tile.  An untiled in-plane axis (no tile, or a tile
that covers the domain) is not padded: its edge is the boundary.  The
reference's 128-lane x padding, its (8, 128)-aligned scratch and its
halo-multiple chunk rounding were TPU artifacts and are gone.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.core.planner import (_pad_to, budget_planes_3d,
                                      kernel_smem_bytes_3d,
                                      kernel_threads_3d, level_regions_3d,
                                      ring_extents_3d, smem_bytes_3d)
from repro_torch.core.spans import span
from repro_torch.core.stencil_spec import StencilSpec
from repro_torch.kernels import _build, stencil3d_gen
from repro_torch.kernels.taps import engine_for, split_star

MAX_RADIUS = 8
# the most taps a tap-set library is built for: the whole box of the
# largest radius, so every set that validate_spec accepts (dense sets of
# 343 to 4913 taps at radius 3-8 build with no spill or stack frame:
# python -m repro_torch.launch.stencil_registers --taps 343 4913)
MAX_TAPS = (2 * MAX_RADIUS + 1) ** 3
MAX_GRID_Z = 65535      # z chunks of a launch, over all fields of a batch


def chunk_geometry(spec: StencilSpec, t: int, zc: int) -> tuple[int, int]:
    """The ``(zc, halo)`` a launch uses: any ``zc >= 1`` planes (the
    kernel streams its ``zc + 2·halo`` input planes one at a time, so
    the chunk needs no rounding to the halo)."""
    if zc < 1 or t < 1:
        raise ValueError(f"z chunk {zc} and depth t={t} must be >= 1")
    return zc, spec.halo(t)


def launch_geometry_3d(spec: StencilSpec, t: int,
                       shape: tuple[int, int, int], *, zc: int,
                       ty: int | None = None, tx: int | None = None,
                       itemsize: int = 4) -> dict:
    """The launch a 3-D sweep over ``shape`` executes: grid, block
    ``(zc, ty, tx)``, halo, per-axis tiled flags, the padded layout, the
    threads of a CTA (``threads``, ``None`` if the kernel refuses the
    launch) and the cells each owns at most (``cells_per_thread``, which
    the wrapper passes to the kernel's launcher), the
    planner's shared-memory budget (``smem_bytes``, ``ring`` planes per
    level) beside what the kernel allocates (``kernel_smem_bytes``), the
    cells each CTA loads (``fetched_cells``) and writes (``body_cells``),
    and the stencil applications the whole launch computes, trapezoid
    included (``cell_updates``).  ``ty``/``tx`` are resolved by
    ``planner.resolve_axis`` (the reference's ``xy_tile``): ``None``, or
    a tile that covers the domain, leaves the axis untiled; tiles
    narrower than the halo are fine, since the kernel reads its rim from
    the neighbouring tiles."""
    zdim, ydim, xdim = shape
    zc, halo = chunk_geometry(spec, t, zc)
    rings = ring_extents_3d(spec, t, shape, ty, tx)
    (ty, tx), (tiled_y, tiled_x) = rings["tile"], rings["tiled"]
    zp = _pad_to(zdim, zc)
    yp = _pad_to(ydim, ty) if tiled_y else ydim
    xp = _pad_to(xdim, tx) if tiled_x else xdim
    ey0, ex0 = rings["extents"][0]
    fy, fx = rings["frame"]
    spread = kernel_threads_3d(spec, t, shape, ty, tx, itemsize)
    grid = (zp // zc, yp // ty, xp // tx)
    return dict(grid=grid, block=(zc, ty, tx),
                halo=halo, tiled=(True, tiled_y, tiled_x),
                padded=(zp, yp, xp),
                threads=None if spread is None else _pad_to(sum(spread[0]),
                                                            32),
                cells_per_thread=None if spread is None else spread[1],
                ring=budget_planes_3d(spec.radius),
                smem_bytes=smem_bytes_3d(spec, t, shape, ty, tx, itemsize),
                kernel_smem_bytes=kernel_smem_bytes_3d(spec, t, shape, ty,
                                                       tx, itemsize),
                fetched_cells=(zc + 2 * halo) * (ey0 - 2 * fy)
                * (ex0 - 2 * fx),
                body_cells=zc * ty * tx,
                cell_updates=math.prod(grid) * sum(
                    ny * nx * (zc + 2 * (t - s) * spec.radius)
                    for s, (ny, nx) in enumerate(
                        level_regions_3d(spec, t, shape, ty, tx), 1)))


def padded_shape_3d(spec: StencilSpec, t: int, shape: tuple[int, int, int],
                    *, zc: int, ty: int | None = None,
                    tx: int | None = None) -> tuple[int, int, int]:
    """Padded layout of a launch (see :func:`launch_geometry_3d`)."""
    return launch_geometry_3d(spec, t, shape, zc=zc, ty=ty, tx=tx)["padded"]


@functools.lru_cache(maxsize=None)
def kernel_taps(taps) -> tuple[np.ndarray, ...]:
    """``(dz, dy, dx, coef)`` in the order the plain version sums them:
    for a star set the center, then each axis's arms; otherwise tap
    order.  The single source of the tap order: the header generator
    (``stencil3d_gen.tap_groups``) reads it."""
    if len(taps) > MAX_TAPS:
        raise ValueError(f"the CUDA 3-D kernel takes at most {MAX_TAPS} "
                         f"taps (MAX_TAPS); this stencil has {len(taps)}")
    rad = max(max(abs(o) for o in off) for off, _ in taps)
    if rad > MAX_RADIUS:
        raise ValueError(f"the CUDA kernel takes radius <= {MAX_RADIUS}; "
                         f"this stencil has radius {rad}")
    star = split_star(taps, 3)
    if star is None:
        ordered = list(taps)
    else:
        center, arms = star
        ordered = [((0, 0, 0), center)] if center != 0.0 else []
        for axis, axis_arms in enumerate(arms):
            for o, c in axis_arms:
                off = [0, 0, 0]
                off[axis] = o
                ordered.append((tuple(off), c))
    cols = [np.array([off[a] for off, _ in ordered], np.int32)
            for a in range(3)]
    return (*cols, np.array([c for _, c in ordered], np.float64))


def _check_padded(xp: torch.Tensor, shape: tuple[int, int, int],
                  geom: dict) -> None:
    if xp.dim() not in (3, 4) or tuple(xp.shape[-3:]) != geom["padded"]:
        raise ValueError(
            f"padded shape {tuple(xp.shape)} is not the layout "
            f"{geom['padded']} of the {shape} domain at tile "
            f"{geom['block']} (see padded_shape_3d), with or without a "
            "leading batch axis")
    if xp.dim() == 4:
        chunks = geom["grid"][0] * xp.shape[0]
        if xp.shape[0] < 1 or chunks > MAX_GRID_Z:
            raise ValueError(
                f"a launch takes at most {MAX_GRID_Z} z chunks over the "
                f"batch; {xp.shape[0]} fields of {geom['grid'][0]} chunks "
                f"make {chunks}")


def ebisu3d_padded_plain(xp: torch.Tensor, spec: StencilSpec, t: int, *,
                         zdim: int, ydim: int, xdim: int) -> torch.Tensor:
    """The plain version of one sweep: ``t`` masked steps of the tap
    engine over the whole padded array, and each field of a leading batch
    axis (any device)."""
    mask = torch.zeros(xp.shape[-3:], dtype=xp.dtype, device=xp.device)
    mask[:zdim, :ydim, :xdim] = 1
    return engine_for(spec.taps, 3).chain(xp * mask, t, mask)


def ebisu3d_padded(xp: torch.Tensor, spec: StencilSpec, t: int, *,
                   zdim: int, ydim: int, xdim: int, zc: int,
                   ty: int | None = None, tx: int | None = None,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """One sweep of ``t`` steps on the padded layout, or on each field
    of a batch of them (see the module docstring), in one launch; writes
    into ``out`` when given (it must not alias ``xp``).  CUDA tensors go
    to the kernel, CPU tensors to the plain version."""
    if spec.ndim != 3:
        raise ValueError(f"{spec.name} is {spec.ndim}-D; ebisu3d_padded "
                         "takes 3-D stencils (lift a 2-D one with "
                         "lift_2d_to_3d)")
    shape = (zdim, ydim, xdim)
    with span("repro_torch.launch.stencil3d t={} tile={}x{}x{} batch={}", t,
              zc, ty, tx, xp.shape[0] if xp.dim() == 4 else 1):
        geom = launch_geometry_3d(spec, t, shape, zc=zc, ty=ty, tx=tx,
                                  itemsize=xp.element_size())
        _check_padded(xp, shape, geom)
        if out is None:
            out = torch.empty_like(xp)
        elif (out.shape != xp.shape or out.dtype != xp.dtype
              or out.device != xp.device):
            raise ValueError("out must match xp in shape, dtype and device")
        if xp.device.type == "cpu":
            out.copy_(ebisu3d_padded_plain(xp, spec, t, zdim=zdim,
                                           ydim=ydim, xdim=xdim))
            return out
        if xp.device.type != "cuda":
            raise ValueError(f"ebisu3d_padded runs on cuda or cpu tensors, "
                             f"got {xp.device}")
        _launch(xp, out, spec, t, shape, geom)
    _build.count_launch(ebisu3d_padded)
    return out


ebisu3d_padded.launches = 0


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 12 + [
    ctypes.c_void_p]


def tapset_header(spec: StencilSpec) -> str:
    """The generated header of ``spec``'s tap set (refuses what no
    library is built for: more than ``MAX_TAPS`` taps, radius beyond
    ``MAX_RADIUS``)."""
    kernel_taps(spec.taps)
    return stencil3d_gen.header(tuple(spec.taps))


def library_for(spec: StencilSpec) -> ctypes.CDLL:
    """The kernel library of ``spec``'s tap set, built at first use."""
    return _build.library("stencil3d", tapset_header(spec))


def launch_shape(spec: StencilSpec, t: int, shape: tuple[int, int, int],
                 geom: dict, itemsize: int) -> tuple[int, int]:
    """``(threads of a CTA, shared-memory bytes)`` of a launch, as the
    library's own launcher computes them (``stencil3d_shape``, which
    launches nothing); raises ``RuntimeError`` where the launch would
    fail."""
    lib = library_for(spec)
    fn = lib.stencil3d_shape
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    block, smem = ctypes.c_int(), ctypes.c_longlong()
    err = fn(itemsize, *shape, t, *geom["block"],
             geom["cells_per_thread"] or 0, ctypes.addressof(block),
             ctypes.addressof(smem))
    if err != 0:
        raise RuntimeError(f"stencil3d refuses the launch: {spec.name} "
                           f"t={t} tile {geom['block']} itemsize {itemsize}")
    return block.value, smem.value


def _launch(xp: torch.Tensor, out: torch.Tensor, spec: StencilSpec, t: int,
            shape: tuple[int, int, int], geom: dict) -> None:
    if xp.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the CUDA kernel computes in float32 or float64, "
                         f"got {xp.dtype}")
    if not (xp.is_contiguous() and out.is_contiguous()):
        raise ValueError("ebisu3d_padded needs contiguous tensors")
    if out.data_ptr() == xp.data_ptr():
        raise ValueError("out must not alias xp: CTAs read xp while others "
                         "write out")
    lib = library_for(spec)
    fn = lib.stencil3d_f32 if xp.dtype == torch.float32 else lib.stencil3d_f64
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    zc, ty, tx = geom["block"]
    batch = xp.shape[0] if xp.dim() == 4 else 1
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        err = fn(xp.data_ptr(), out.data_ptr(), batch, *geom["padded"],
                 *shape, t, zc, ty, tx, geom["cells_per_thread"] or 0,
                 stream)
    if err != 0:
        lib.stencil3d_error_string.restype = ctypes.c_char_p
        lib.stencil3d_error_string.argtypes = [ctypes.c_int]
        msg = lib.stencil3d_error_string(err).decode()
        raise RuntimeError(
            f"stencil3d launch failed ({msg}): {spec.name} t={t} tile "
            f"{geom['block']} padded {tuple(xp.shape)} {xp.dtype}")


def ebisu3d(x: torch.Tensor, spec: StencilSpec, t: int, *, zc: int,
            ty: int | None = None, tx: int | None = None,
            compute_dtype=None) -> torch.Tensor:
    """Apply ``t`` zero-Dirichlet temporally-blocked steps of a 3-D
    ``spec`` by z-streaming: pad into a ``compute_dtype`` buffer (default
    float32), run one sweep, crop, cast back.  The other boundary kinds
    are the program's (``api.program._build_chain``)."""
    cdtype = compute_dtype or torch.float32
    zdim, ydim, xdim = x.shape
    padded = padded_shape_3d(spec, t, x.shape, zc=zc, ty=ty, tx=tx)
    xp = torch.zeros(padded, dtype=cdtype, device=x.device)
    xp[:zdim, :ydim, :xdim] = x
    out = ebisu3d_padded(xp, spec, t, zdim=zdim, ydim=ydim, xdim=xdim,
                         zc=zc, ty=ty, tx=tx)
    return out[:zdim, :ydim, :xdim].to(x.dtype)

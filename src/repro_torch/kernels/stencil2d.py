"""EBISU-2D on the card: the wrapper of the CUDA tile kernel
(``csrc/stencil2d.cu``) and its plain PyTorch version.

Counterpart of the reference's Pallas strip kernel
(``repro/kernels/stencil2d.py::_strip_kernel``, launched by
``ebisu2d_padded``).  The function both compute is one *sweep* on the
padded layout: ``xp`` is ``(hp, wp)`` with the ``height × width`` domain
at the origin and zeros outside it; the result is ``t`` zero-Dirichlet
steps of the tap set, in the same layout, again zero outside the domain.

  * On a CUDA tensor, :func:`ebisu2d_padded` launches the kernel (or
    raises) and adds one to ``ebisu2d_padded.launches``.
  * On a CPU tensor it runs :func:`ebisu2d_padded_plain`: the tap
    engine's ``chain`` over the padded array, masked to the domain after
    every step.  No CUDA tensor ever takes the plain version.

The kernel tiles both axes: a CTA computes a ``bh × bw`` tile of output
cells from a ``t·rad`` rim on every side (see the source's header).  The
padded layout rounds rows up to a multiple of ``bh`` and columns to a
multiple of ``bw`` (which is itself a multiple of one warp, 32 columns);
the reference's 128-column padding was a TPU lane artifact.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.planner import COL_ALIGN, THREADS, _pad_to
from repro_torch.core.stencil_spec import StencilSpec
from repro_torch.kernels import _build
from repro_torch.kernels.taps import engine_for, split_star

MAX_TAPS = 128          # STENCIL2D_MAX_TAPS in csrc/stencil2d.cu
MAX_RADIUS = 8          # STENCIL2D_MAX_RADIUS


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


@functools.lru_cache(maxsize=None)
def kernel_taps(taps) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(dy, dx, coef)`` in the order the plain version sums them: for a
    star set the center, then each axis's arms; otherwise tap order."""
    if len(taps) > MAX_TAPS:
        raise ValueError(f"the CUDA kernel takes at most {MAX_TAPS} taps; "
                         f"this stencil has {len(taps)}")
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
    if xp.dim() != 2:
        raise ValueError(f"padded field must be 2-D, got shape "
                         f"{tuple(xp.shape)}")
    hp, wp = xp.shape
    if hp % bh or wp % bw or height > hp or width > wp:
        raise ValueError(
            f"padded shape {(hp, wp)} must be a multiple of the tile "
            f"({bh}, {bw}) and hold the {height}x{width} domain "
            "(see padded_shape_2d)")


def ebisu2d_padded_plain(xp: torch.Tensor, spec: StencilSpec, t: int, *,
                         height: int, width: int) -> torch.Tensor:
    """The plain version of one sweep: ``t`` masked steps of the tap
    engine over the whole padded array (any device)."""
    mask = torch.zeros(xp.shape, dtype=xp.dtype, device=xp.device)
    mask[:height, :width] = 1
    return engine_for(spec.taps, 2).chain(xp * mask, t, mask)


def ebisu2d_padded(xp: torch.Tensor, spec: StencilSpec, t: int, *,
                   height: int, width: int, bh: int, bw: int,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """One sweep of ``t`` steps on the padded layout (see the module
    docstring); writes into ``out`` when given (it must not alias
    ``xp``).  CUDA tensors go to the kernel, CPU tensors to the plain
    version."""
    bh, bw, _ = strip_geometry(spec, t, bh, bw)
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
        raise ValueError(f"ebisu2d_padded runs on cuda or cpu tensors, got "
                         f"{xp.device}")
    _launch(xp, out, spec, t, height, width, bh, bw)
    ebisu2d_padded.launches += 1
    return out


ebisu2d_padded.launches = 0


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 9 + [
    ctypes.c_void_p] * 4


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
    dy, dx, coef = kernel_taps(spec.taps)
    lib = _build.library("stencil2d")
    fn = lib.stencil2d_f32 if xp.dtype == torch.float32 else lib.stencil2d_f64
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    hp, wp = xp.shape
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        err = fn(xp.data_ptr(), out.data_ptr(), hp, wp, height, width, t,
                 bh, bw, THREADS, len(dy), dy.ctypes.data, dx.ctypes.data,
                 coef.ctypes.data, stream)
    if err != 0:
        lib.stencil2d_error_string.restype = ctypes.c_char_p
        lib.stencil2d_error_string.argtypes = [ctypes.c_int]
        msg = lib.stencil2d_error_string(err).decode()
        raise RuntimeError(
            f"stencil2d launch failed ({msg}): {spec.name} t={t} tile "
            f"({bh}, {bw}) padded {(hp, wp)} {xp.dtype}")


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

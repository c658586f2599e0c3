"""Legacy entry points for the stencil kernels: DEPRECATED shims
(counterpart of ``repro.kernels.ops``).

Every function here delegates to ``repro_torch.api`` (the compile-once
``StencilProgram`` front door), which owns the one geometry and dispatch
path; nothing here derives a tile, grid or padding.  New code compiles a
program instead:

    from repro_torch.api import compile_stencil
    prog = compile_stencil(spec, x.shape, t=t, device=x.device)
    y = prog.apply(x)            # was: ops.ebisu_stencil(x, spec, t)

The shims keep the reference's signatures and warn with a
``DeprecationWarning`` at call time, never at import.  They run where
``x`` lies: a CUDA tensor launches the kernels, a CPU tensor takes
their plain versions; ``interpret`` is kept for the signature only.
"""
from __future__ import annotations

import torch

from repro_torch.api.program import (DEFAULT_BH_2D, DEFAULT_ZC_3D,  # noqa: F401
                                     DEFAULT_ZC_STREAM_2D, TileRequest,
                                     compile_stencil, deprecated_entry,
                                     resolve_geometry)
from repro_torch.core.planner import EbisuPlan
from repro_torch.core.roofline import H100
from repro_torch.core.stencil_spec import StencilSpec
from repro_torch.kernels import ref as ref_ops


def ebisu_stencil(x: torch.Tensor, spec: StencilSpec, t: int, *,
                  plan: EbisuPlan | None = None, mode: str = "fused",
                  interpret: bool | None = None,
                  boundary=None) -> torch.Tensor:
    """Apply ``t`` temporally-blocked stencil steps in one sweep.

    DEPRECATED: compile a ``StencilProgram`` and call ``.apply``.
    ``plan=None`` keeps the request-default tiles (programs compiled
    through the front door resolve a §6 plan)."""
    deprecated_entry("ops.ebisu_stencil", "compile_stencil(...).apply")
    prog = compile_stencil(spec, tuple(x.shape), dtype=x.dtype, t=t,
                           plan=plan, mode=mode, boundary=boundary,
                           device=x.device)
    return prog.apply(x)


def launch_geometry(spec: StencilSpec, t: int, shape: tuple[int, ...], *,
                    plan: EbisuPlan | None = None,
                    mode: str = "fused") -> dict:
    """The geometry an ``ebisu_stencil`` call with these arguments
    launches (float32 cells on the H100 model): a shim over
    ``resolve_geometry``, the one tile, grid and padding path."""
    stream = mode == "stream" and spec.ndim == 2
    return resolve_geometry(spec, t, tuple(shape), mode=mode,
                            plan=TileRequest(stream) if plan is None
                            else plan)


def ebisu_stencil_planned(x: torch.Tensor, spec: StencilSpec, *, hw=H100,
                          t: int | None = None, mode: str = "fused",
                          interpret: bool | None = None, boundary=None):
    """Plan ``(t, tiles)`` with the §6 planner on ``hw``, then run →
    ``(out, plan)``.

    DEPRECATED shim over ``compile_stencil``; ``mode`` and ``hw`` thread
    through to the compiled program."""
    deprecated_entry("ops.ebisu_stencil_planned", "compile_stencil")
    prog = compile_stencil(spec, tuple(x.shape), dtype=x.dtype, t=t, hw=hw,
                           mode=mode, boundary=boundary, device=x.device)
    return prog.apply(x), prog.plan


def naive_stencil(x: torch.Tensor, spec: StencilSpec,
                  t: int) -> torch.Tensor:
    """The un-blocked baseline (one memory round trip per step)."""
    return ref_ops.reference(x, spec, t)



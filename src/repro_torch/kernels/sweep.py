"""Multi-sweep executor entry points: DEPRECATED shims over
``repro_torch.api`` (counterpart of ``repro.kernels.sweep``).

The executor itself (the ping-pong chain of kernel launches, the
shape-bucketed plan memoization, the padded carry) lives in
``repro_torch.api.program``, owned by ``StencilProgram``: ``prog.run(x,
T)`` is the executor, ``prog.run_padded`` the padded chain.  This module
keeps the reference's call surface:

  * ``run_sweeps(x, spec, T, ...)`` → ``compile_stencil(...).run(x, T)``;
  * ``run_sweeps_padded``, ``sweep_schedule``, ``plan_bucketed`` and the
    tile helpers, re-exported from ``repro_torch.api.program``;
  * ``_PLAN_CACHE`` and ``_LAUNCH_CACHE``, aliases of the bounded LRU
    caches ``PLAN_CACHE`` and ``RUNNER_CACHE`` the front door owns.

The ``DeprecationWarning`` fires at call time only; importing this
module is silent.
"""
from __future__ import annotations

import torch

from repro_torch.api.program import (PLAN_CACHE, RUNNER_CACHE,  # noqa: F401
                                     _grouped, _sweep_tile_2d,
                                     _sweep_tile_3d, compile_stencil,
                                     deprecated_entry, plan_bucketed,
                                     run_sweeps_padded, sweep_schedule)
from repro_torch.core import roofline as rl
from repro_torch.core.planner import EbisuPlan
from repro_torch.core.stencil_spec import StencilSpec

# legacy aliases: the module dicts are the front door's bounded caches
_PLAN_CACHE = PLAN_CACHE
_LAUNCH_CACHE = RUNNER_CACHE


def run_sweeps(x: torch.Tensor, spec: StencilSpec, total_t: int, *,
               t: int | None = None, plan: EbisuPlan | None = None,
               hw: rl.HardwareModel = rl.H100, mode: str = "fused",
               interpret: bool | None = None,
               boundary=None) -> torch.Tensor:
    """Apply ``total_t`` stencil steps as chained temporally-blocked
    sweeps on ``x``'s device.

    DEPRECATED shim: compile a program and call ``.run``::

        prog = compile_stencil(spec, x.shape, t=t, hw=hw)
        y = prog.run(x, total_t)

    The per-sweep depth is ``t`` (default: the §6 plan's); ``plan=None``
    resolves the shape-bucketed plan and pins it, as the reference does.
    ``interpret`` is kept for the signature only."""
    deprecated_entry("sweep.run_sweeps", "compile_stencil(...).run")
    if spec.ndim == 2 and mode not in ("fused", "scratch"):
        raise ValueError(
            f"run_sweeps supports 2-D modes 'fused'/'scratch', got {mode!r} "
            "(use the program's apply for the lifted 'stream' path)")
    if total_t == 0:
        return x
    if plan is None:
        plan = plan_bucketed(spec, tuple(x.shape), hw)
    depth = max(1, min(t if t is not None else plan.t, total_t))
    prog = compile_stencil(spec, tuple(x.shape), dtype=x.dtype, t=depth,
                           hw=hw, plan=plan, mode=mode, boundary=boundary,
                           device=x.device)
    return prog.run(x, total_t)

"""The header of the 3-D kernel's taps: one per tap set, so that the taps
of ``csrc/stencil3d.cu`` are compile-time constants and its tap loops
unroll.

:func:`tap_groups` groups :func:`~repro_torch.kernels.stencil3d.kernel_taps`
by in-plane offset: for each distinct ``(dy, dx)``, in order of first
appearance, the ``(dz, coefficient)`` of every tap at that offset, in
``kernel_taps`` order.  The kernel reads each offset of a new plane once
and adds it, times each coefficient, into the partial sum of the output
plane that tap's ``dz`` feeds; the CPU replay of the schedule
(``tests/test_torch_stencil3d.py``) reads the same grouping.

:func:`header` writes it as C preprocessor lists (``kernels/tap_header.py``,
shared with the 2-D header), the coefficients as exact hexadecimal
literals of the float64 value (``float.hex``; the kernel casts each to
its type as the plain version does), with the kernel's compile-time
bounds from the planner.  Nothing here imports CUDA or
builds anything.
"""
from __future__ import annotations

import functools

from repro_torch.core.planner import (KERNEL_THREADS_3D, MAX_DEPTH_3D,
                                      max_cells_per_thread,
                                      planes_per_barrier)
from repro_torch.kernels.tap_header import group_macro, group_taps
from repro_torch.kernels.taps import tap_radius

TapGroups = tuple[tuple[int, int, tuple[tuple[int, float], ...]], ...]


def tap_groups(taps) -> TapGroups:
    """``((dy, dx, ((dz, coef), ...)), ...)`` of a 3-D tap set, from
    ``kernel_taps`` (see the module docstring)."""
    from repro_torch.kernels.stencil3d import kernel_taps

    dz, dy, dx, coef = kernel_taps(tuple(taps))
    return group_taps((dz, dy, dx), coef, key_axes=(1, 2), term_axis=0)


@functools.lru_cache(maxsize=None)
def header(taps) -> str:
    """The generated header of a tap set (``stencil3d_taps.cuh``), kept
    per tap set: the wrapper asks for it at every launch."""
    groups = tap_groups(taps)
    rad = tap_radius(taps)
    lines = [
        "// Generated by repro_torch.kernels.stencil3d_gen: the taps of one",
        "// 3-D stencil for csrc/stencil3d.cu.  Do not edit.",
        "#pragma once",
        f"#define ST3_RADIUS {rad}",
        f"#define ST3_REACH_Y {max(abs(y) for y, _, _ in groups)}",
        f"#define ST3_REACH_X {max(abs(x) for _, x, _ in groups)}",
        f"#define ST3_NTAPS {sum(len(terms) for *_, terms in groups)}",
        f"#define ST3_PLANES {planes_per_barrier(rad)}",
        f"#define ST3_SLOTS_F32 {max_cells_per_thread(rad, 4)}",
        f"#define ST3_SLOTS_F64 {max_cells_per_thread(rad, 8)}",
        f"#define ST3_THREADS {KERNEL_THREADS_3D}",
        f"#define ST3_MAX_DEPTH {MAX_DEPTH_3D}",
        "// OFFSET(dy, dx, terms) for each in-plane offset; terms are",
        "// TAP(dz, coefficient) in kernel_taps order.",
        *group_macro("ST3_OFFSETS", "OFFSET", "TAP", groups),
    ]
    return "\n".join(lines) + "\n"

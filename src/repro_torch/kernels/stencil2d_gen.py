"""The header of the 2-D kernel's taps: one per tap set, so that the taps
of ``csrc/stencil2d.cu`` are compile-time constants and its tap loops
unroll.

:func:`tap_columns` groups :func:`~repro_torch.kernels.stencil2d.kernel_taps`
by column offset: for each distinct ``dx``, in order of first appearance,
the ``(dy, coefficient)`` of every tap in that column, in ``kernel_taps``
order.  A thread of the kernel owns ``R`` vertically consecutive cells;
it walks the input rows of its column once, reads each column offset of
a row once, and adds it, times each coefficient, into the accumulator of
every cell whose tap ``dy`` reaches that row.  The CPU replay of the
schedule (``tests/test_torch_stencil2d.py``) reads the same grouping.

:func:`header` writes it as C preprocessor lists (``kernels/tap_header.py``,
shared with the 3-D header), the coefficients as exact hexadecimal
literals of the float64 value, with the kernel's compile-time bounds
from the planner.  Nothing here imports CUDA or builds anything.
"""
from __future__ import annotations

import functools

from repro_torch.core.planner import THREADS, rows_per_thread_2d
from repro_torch.kernels.tap_header import group_macro, group_taps
from repro_torch.kernels.taps import tap_radius

TapColumns = tuple[tuple[int, tuple[tuple[int, float], ...]], ...]


def tap_columns(taps) -> TapColumns:
    """``((dx, ((dy, coef), ...)), ...)`` of a 2-D tap set, from
    ``kernel_taps`` (see the module docstring)."""
    from repro_torch.kernels.stencil2d import kernel_taps

    dy, dx, coef = kernel_taps(tuple(taps))
    return group_taps((dy, dx), coef, key_axes=(1,), term_axis=0)


@functools.lru_cache(maxsize=None)
def header(taps) -> str:
    """The generated header of a tap set (``stencil2d_taps.cuh``), kept
    per tap set: the wrapper asks for it at every launch."""
    columns = tap_columns(taps)
    rad = tap_radius(taps)
    lines = [
        "// Generated by repro_torch.kernels.stencil2d_gen: the taps of one",
        "// 2-D stencil for csrc/stencil2d.cu.  Do not edit.",
        "#pragma once",
        f"#define ST2_RADIUS {rad}",
        f"#define ST2_REACH_Y "
        f"{max(abs(y) for _, terms in columns for y, _ in terms)}",
        f"#define ST2_REACH_X {max(abs(x) for x, _ in columns)}",
        f"#define ST2_NTAPS {sum(len(terms) for _, terms in columns)}",
        f"#define ST2_ROWS_F32 {rows_per_thread_2d(rad, 4, len(taps))}",
        f"#define ST2_ROWS_F64 {rows_per_thread_2d(rad, 8, len(taps))}",
        f"#define ST2_THREADS {THREADS}",
        "// COLUMN(dx, terms) for each column offset; terms are",
        "// TAP(dy, coefficient) in kernel_taps order.",
        *group_macro("ST2_COLUMNS", "COLUMN", "TAP", columns),
    ]
    return "\n".join(lines) + "\n"

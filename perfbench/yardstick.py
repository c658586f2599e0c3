"""The benchmark's own arithmetic: peaks, the bound of a stencil launch,
the union of device intervals, percentiles.

Kept here, and not read from the program, so that a change to the
program cannot move the yardstick it is measured with.
"""
from __future__ import annotations

import math

# One NVIDIA H100 SXM, dense rates at its 700 W limit (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 67e12, "float64": 34e12}
ITEMSIZE = {"float32": 4, "float64": 8}


def roofline_pct(launch_s: list[float], cells: int, cell_updates: int,
                 flops_per_cell: float, dtype: str) -> float | None:
    """Bound over traced time, in %, of a window's launches of one kernel.

    ``launch_s`` is the traced time of each launch, ``cells`` the cells a
    launch covers (each reads its domain once and writes it once) and
    ``cell_updates`` the useful cell-updates the launches did together.
    The bound is the larger of those bytes over the memory bandwidth and
    those operations over the peak: both are times the launches cannot
    beat.  Nothing here copies the program's schedule, so a launch more
    or fewer changes the bound with the time.  None where no launch was
    traced."""
    if not launch_s:
        return None
    t_bytes = len(launch_s) * 2 * cells * ITEMSIZE[dtype] / HBM_BYTES_PER_S
    t_ops = flops_per_cell * cell_updates / FLOPS_PER_S[dtype]
    return 100.0 * max(t_bytes, t_ops) / sum(launch_s)


def mfu_pct(cell_updates: int, flops_per_cell: float, seconds: float,
            dtype: str) -> float:
    """Useful operations a second over the peak, in %."""
    return 100.0 * cell_updates * flops_per_cell / seconds / FLOPS_PER_S[dtype]


def union(intervals, lo: float, hi: float) -> tuple[float, list]:
    """The length of the union of ``intervals`` ((start, end) pairs)
    clipped to ``[lo, hi]``, and the gaps inside ``[lo, hi]`` that no
    interval covers, as (start, end) pairs."""
    covered, gaps, cursor = 0.0, [], lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            covered += b - max(a, cursor)
            cursor = b
    if cursor < hi:
        gaps.append((cursor, hi))
    return covered, gaps


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100); an infinite
    value (a request that failed) sorts last."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]

"""§6 of the paper, EBISU's design decisions, planned for CTAs on an H100.

The §5/§6 math is the reference's (``repro.core.planner.plan``): the
depth is Eq 17's ``t`` that moves the bottleneck from device memory to
shared memory, capped by what on-chip capacity affords.  What changes is
the launch the plan describes.  The TPU planner sized an ``8·128·ilp``
vector tile floor, a Pallas ``num_buffers`` pipeline depth and a
"computing" ring for full-width VMEM strips.  On the card a plan is:

  * a CTA tile ``(bh, bw)`` of output cells.  The CTA holds the tile plus
    a ``halo = t·rad`` rim on every side in shared memory, twice (the
    ``t`` steps ping-pong between two buffers), so its footprint is
    ``2·(bh + 2·halo)·(bw + 2·halo)`` cells and must stay within the
    per-block limit ``hw.onchip_bytes``;
  * the tile that maximizes the valid fraction ``bh·bw / ((bh + 2·halo)
    ·(bw + 2·halo))`` (Eq 8 on both axes, §6.4 "wider"), preferring a
    footprint that lets two CTAs share an SM so that one CTA's loads
    overlap the other's steps (§6.1's minimal parallelism, in CTAs);
  * a fixed thread count, one warp across a tile row.

Columns are tiled too: at the paper's widths a full-width strip of
8352 f32 cells per row cannot fit 227 KB with any useful depth.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import roofline as rl
from repro_torch.core.stencil_spec import StencilSpec

THREADS = 512           # blockDim (32, 16): one warp across a tile row
COL_ALIGN = 32          # bw is a multiple of one warp's width
ROW_ALIGN = 8
# each resident CTA also holds 1 KB of shared memory the runtime reserves
_RESERVED_PER_CTA = 1024


@dataclasses.dataclass(frozen=True)
class EbisuPlan:
    spec_name: str             # display only: caches key on spec.signature
    hw_name: str
    t: int                     # temporal blocking depth
    block: tuple[int, int]     # CTA tile of output cells (bh, bw)
    halo: int                  # t · rad
    threads: int               # threads per CTA
    smem_bytes: int            # shared memory one CTA claims
    pp: rl.RooflineResult      # predicted practical attainable performance


def _pad_to(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def smem_bytes_2d(spec: StencilSpec, t: int, bh: int, bw: int,
                  itemsize: int) -> int:
    """Shared memory of one CTA: two haloed tiles (ping-pong)."""
    h = spec.halo(t)
    return 2 * (bh + 2 * h) * (bw + 2 * h) * itemsize


def fit_tile_2d(spec: StencilSpec, t: int, shape: tuple[int, int],
                hw: rl.HardwareModel, itemsize: int
                ) -> tuple[int, int, int] | None:
    """The CTA tile ``(bh, bw, resident_ctas)`` for a depth-``t`` sweep
    over ``shape``, or ``None`` if no tile fits the per-block limit.

    Tiles are capped at the (aligned) domain, so a small domain is one
    tile.  For each row count the widest fitting column count is the
    best, so the search is one loop over ``bh``."""
    h = spec.halo(t)
    max_bh = _pad_to(shape[0], ROW_ALIGN)
    max_bw = _pad_to(shape[1], COL_ALIGN)
    limit = int(hw.onchip_bytes)
    for resident in (2, 1):
        budget = limit // resident - (_RESERVED_PER_CTA if resident > 1
                                      else 0)
        best = None
        for bh in range(ROW_ALIGN, max_bh + 1, ROW_ALIGN):
            cols = budget // (2 * itemsize * (bh + 2 * h)) - 2 * h
            bw = min(max_bw, cols // COL_ALIGN * COL_ALIGN)
            if bw < COL_ALIGN:
                break
            v = bh * bw / ((bh + 2 * h) * (bw + 2 * h))
            if best is None or v > best[0]:
                best = (v, bh, bw)
        if best is not None:
            return best[1], best[2], resident
    return None


def tile_valid_fraction(spec: StencilSpec, t: int, bh: int, bw: int) -> float:
    """Output cells over loaded cells of one CTA tile (Eq 8, both axes)."""
    h = spec.halo(t)
    return bh * bw / ((bh + 2 * h) * (bw + 2 * h))


def plan(spec: StencilSpec, hw: rl.HardwareModel,
         domain: tuple[int, ...] | None = None, max_t: int = 32,
         itemsize: int | None = None) -> EbisuPlan:
    """The §6 plan for a 2-D spec on ``hw``: depth (Eq 17, lowered until
    a tile fits), CTA tile, threads and shared memory.  ``itemsize`` is
    the compute dtype's size (default ``hw.s_cell``)."""
    if spec.ndim != 2:
        raise NotImplementedError(
            f"{spec.name}: the PyTorch port plans 2-D stencils only; the "
            "3-D stream kernel and program half are ROADMAP Queue 1 item 6 "
            "(slice 2)")
    domain = tuple(domain or spec.domain)
    itemsize = itemsize or hw.s_cell
    t = min(max_t, max(1, int(math.ceil(
        rl.desired_depth(spec, hw, rst=True)))))
    while t > 1 and fit_tile_2d(spec, t, domain, hw, itemsize) is None:
        t -= 1
    fit = fit_tile_2d(spec, t, domain, hw, itemsize)
    if fit is None:
        raise ValueError(
            f"{spec.name}: no CTA tile fits the {int(hw.onchip_bytes)} B "
            f"shared-memory limit of {hw.name} at {itemsize}-byte cells, "
            "even at t=1")
    bh, bw, _ = fit
    d_all = math.prod(domain)
    t_sweep = rl.component_times(spec, t, hw, rst=True, d_all=d_all)
    v = (tile_valid_fraction(spec, t, bh, bw)
         * rl.v_dtile(max(t_sweep[:3]), hw, 1))
    res = rl.attainable(spec, t, hw, rst=True, v=v, d_all=d_all)
    return EbisuPlan(spec.name, hw.name, t, (bh, bw), spec.halo(t),
                     THREADS, smem_bytes_2d(spec, t, bh, bw, itemsize), res)

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

A 3-D plan (and the lifted 2-D ``stream`` mode) describes the z-streaming
kernel instead (``kernels/csrc/stencil3d.cu``): a CTA owns a
``(zc, ty, tx)`` tile of output cells and streams its ``zc + 2·halo``
input planes through ``t`` time levels.  A level-``s`` plane is
narrowed in-plane by ``rad`` per step on tiled axes, ``(ty + 2(t−s)·rad)
× (tx + 2(t−s)·rad)``; an untiled axis (its tile covers the domain) has
no rim, only a zero frame as wide as the taps' reach on that axis.

:func:`smem_bytes_3d` is the planner's shared-memory budget: ``t``
levels (``0..t-1``) of ``2·rad+2`` planes each, what the ring design
before the register-streaming kernel allocated.  The kernel's own
allocation is :func:`kernel_smem_bytes_3d`, ``2·B`` planes per level
(``B = planes_per_barrier(rad) <= rad+1``), so it never exceeds the
budget.  The kernel also bounds the cells a thread owns
(:func:`max_cells_per_thread`) and the threads of a CTA
(``KERNEL_THREADS_3D``); :func:`kernel_threads_3d` says whether a
``(t, tile)`` fits them, and the planner picks no tile that does not.
The plan picks the in-plane tile that loads the fewest redundant cells
(``tx`` a multiple of 32), then the z chunk ``zc`` that fills the
card's SMs in whole waves while keeping ``zc/(zc+2·halo)`` high
(:func:`fit_tile_3d`).
"""
from __future__ import annotations

import dataclasses
import math

import functools

from repro_torch.core import roofline as rl
from repro_torch.core.stencil_spec import StencilSpec

THREADS = 512           # blockDim (32, 16): one warp across a tile row
COL_ALIGN = 32          # bw is a multiple of one warp's width
ROW_ALIGN = 8
# each resident CTA also holds 1 KB of shared memory the runtime reserves
_RESERVED_PER_CTA = 1024
_MAX_THREADS_PER_SM = 2048


@dataclasses.dataclass(frozen=True)
class EbisuPlan:
    spec_name: str             # display only: caches key on spec.signature
    hw_name: str
    t: int                     # temporal blocking depth
    block: tuple[int, ...]     # CTA tile of output cells: (bh, bw) in
    #                            2-D, (zc, ty, tx) in 3-D
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


# The 2-D kernel (csrc/stencil2d.cu and the header kernels/stencil2d_gen.py
# writes) runs THREADS threads a CTA, at most two CTAs an SM.
# Float64 tap sets of more taps than this compute one row a thread.
LARGE_TAPS_2D = 169


def rows_per_thread_2d(rad: int, itemsize: int, ntaps: int) -> int:
    """``R``: the vertically consecutive cells a thread of the 2-D kernel
    computes at each step, with one accumulator each in registers, for a
    set of ``ntaps`` taps.  A step whose live region has fewer rows runs
    one row a thread.  Within 64 registers a thread: 8 rows; 4 for
    float64 beyond radius 2 (at 8, ptxas spills float64 dense sets of
    radius 3–8: ``python -m repro_torch.launch.stencil_registers --ndim
    2``); and 1 for float64 sets of more than ``LARGE_TAPS_2D`` taps (at
    4, ptxas spills dense sets of 200–289 taps and ``blur(2,
    radius=8)``, which spills at 2 and 3 too and even at 128 registers;
    at 1 no set of 169–289 taps probed spills: ``--taps 170 200 225 289
    --radii 7 8 --rows 1 2 3 4``)."""
    if itemsize == 8 and rad > 2:
        return 1 if ntaps > LARGE_TAPS_2D else 4
    return 8


def tile_valid_fraction(spec: StencilSpec, t: int, bh: int, bw: int) -> float:
    """Output cells over loaded cells of one CTA tile (Eq 8, both axes)."""
    h = spec.halo(t)
    return bh * bw / ((bh + 2 * h) * (bw + 2 * h))


# ================================================================= 3-D ==
def axis_reach(spec: StencilSpec, axis: int) -> int:
    """Largest |offset| of the taps along ``axis``."""
    return max(abs(off[axis]) for off, _ in spec.taps)


def resolve_axis(dim: int, tile: int | None) -> tuple[int, bool]:
    """An in-plane tile request as ``(extent, tiled)``: ``None``, or a
    tile that covers the domain, leaves the axis untiled (full extent,
    no rim: the array's edge is the boundary)."""
    if tile is None or tile >= dim:
        return dim, False
    if tile < 1:
        raise ValueError(f"tile extent must be >= 1, got {tile}")
    return tile, True


def ring_extents_3d(spec: StencilSpec, t: int, shape: tuple[int, int, int],
                    ty: int | None, tx: int | None) -> dict:
    """In-plane geometry of the kernel's rings: per axis the resolved
    tile, whether it is tiled, and its zero frame (the taps' reach on an
    untiled axis, 0 on a tiled one); and the plane extent ``(ey, ex)``
    of every time level ``s = 0..t`` (level ``t`` is the output tile and
    has no ring)."""
    _, ydim, xdim = shape
    rad = spec.radius
    (ty, tiled_y), (tx, tiled_x) = resolve_axis(ydim, ty), resolve_axis(
        xdim, tx)
    fy = 0 if tiled_y else axis_reach(spec, 1)
    fx = 0 if tiled_x else axis_reach(spec, 2)
    extents = [(ty + 2 * (t - s) * rad if tiled_y else ydim + 2 * fy,
                tx + 2 * (t - s) * rad if tiled_x else xdim + 2 * fx)
               for s in range(t + 1)]
    return dict(tile=(ty, tx), tiled=(tiled_y, tiled_x), frame=(fy, fx),
                extents=extents)


def budget_planes_3d(rad: int) -> int:
    """Planes a time level takes in :func:`smem_bytes_3d`: ``2·rad+2``,
    the ring of the z-streaming kernel before register streaming."""
    return 2 * rad + 2


def smem_bytes_3d(spec: StencilSpec, t: int, shape: tuple[int, int, int],
                  ty: int | None, tx: int | None, itemsize: int) -> int:
    """The planner's shared-memory budget of one 3-D CTA: ``t`` time
    levels (``0..t-1``) of ``2·rad+2`` planes each.  The kernel allocates
    :func:`kernel_smem_bytes_3d`, which never exceeds it."""
    ext = ring_extents_3d(spec, t, shape, ty, tx)["extents"]
    return (budget_planes_3d(spec.radius)
            * sum(ey * ex for ey, ex in ext[:t]) * itemsize)


# Bounds the 3-D kernel is compiled with (csrc/stencil3d.cu and the header
# kernels/stencil3d_gen.py writes): threads per CTA, levels per sweep.
KERNEL_THREADS_3D = 512
MAX_DEPTH_3D = 32


def planes_per_barrier(rad: int) -> int:
    """``B``: the planes every level advances between two barriers.  Each
    level keeps two batches of ``B`` planes (written, read), so ``B <=
    rad + 1`` keeps the kernel within :func:`smem_bytes_3d`."""
    return min(rad + 1, 3)


def max_cells_per_thread(rad: int, itemsize: int) -> int:
    """The cells a thread of the 3-D kernel owns at most: each keeps
    ``2·rad`` partial sums in registers, 64 registers of them in all up
    to radius 2 and 48 beyond, where the kernel also holds more rows of
    offsets (``python -m repro_torch.launch.stencil_registers --regs
    64``: at 64, ptxas spills dense 128-tap sets of radius 3 and 4 in
    float64 and the sets of radius 7 and 8), and 40 in float64 from
    radius 6 on, one cell a thread (at 48, two cells, ptxas spills the
    star and the dense 128-tap set of radius 6 once the kernel takes a
    batch of fields, and a dense 2197-tap set)."""
    regs = 64 if rad <= 2 else 40 if itemsize == 8 and rad >= 6 else 48
    return max(1, regs * 4 // (2 * rad * itemsize))


def level_regions_3d(spec: StencilSpec, t: int, shape, ty, tx) -> list:
    """``(ny, nx)``: the cells level ``s = 1..t`` computes in one plane
    (its plane extent on a tiled axis, the domain on an untiled one)."""
    r = ring_extents_3d(spec, t, shape, ty, tx)
    (tiled_y, tiled_x) = r["tiled"]
    return [(ey if tiled_y else shape[1], ex if tiled_x else shape[2])
            for ey, ex in r["extents"][1:]]


def kernel_threads_3d(spec: StencilSpec, t: int,
                      shape: tuple[int, int, int], ty: int | None,
                      tx: int | None, itemsize: int
                      ) -> tuple[list[int], int] | None:
    """How the 3-D kernel spreads one CTA's cells over its threads:
    ``(threads of each level 1..t, cells per thread)``, or ``None`` if
    the kernel refuses the launch.  A thread computes one level; the
    cells per thread are the fewest that need no more than
    ``KERNEL_THREADS_3D`` threads, and at most
    :func:`max_cells_per_thread`.  The wrapper passes the cells per
    thread to the C launcher, which spreads the levels the same way and
    refuses more cells than its registers hold or more threads than its
    block."""
    if not 1 <= t <= MAX_DEPTH_3D:
        return None
    cells = [ny * nx for ny, nx in level_regions_3d(spec, t, shape, ty, tx)]
    kmax = max_cells_per_thread(spec.radius, itemsize)
    k = max(1, -(-sum(cells) // KERNEL_THREADS_3D))
    while k <= kmax:
        threads = [-(-c // k) for c in cells]
        if sum(threads) <= KERNEL_THREADS_3D:
            return threads, k
        k += 1
    return None


def kernel_smem_bytes_3d(spec: StencilSpec, t: int,
                         shape: tuple[int, int, int], ty: int | None,
                         tx: int | None, itemsize: int) -> int:
    """Shared memory the 3-D kernel allocates: levels ``0..t-1``, each two
    batches of ``B`` planes (:func:`planes_per_barrier`)."""
    b = planes_per_barrier(spec.radius)
    ext = ring_extents_3d(spec, t, shape, ty, tx)["extents"]
    return 2 * b * sum(ey * ex for ey, ex in ext[:t]) * itemsize


def _tile_choices(dim: int, align: int) -> list[tuple[int, int]]:
    """``(tile, count)`` for every number of tiles along an axis: the
    smallest ``align``-multiple tile giving that count; ``(dim, 1)`` is
    the untiled axis."""
    out = {dim: 1}
    for n in range(2, dim + 1):
        tile = _pad_to(-(-dim // n), align)
        if tile < dim:
            out.setdefault(tile, -(-dim // tile))
    return sorted(out.items())


def _resident_ctas(hw: rl.HardwareModel, smem: int) -> int:
    per_sm = int(hw.onchip_bytes) + _RESERVED_PER_CTA
    return max(1, min(_MAX_THREADS_PER_SM // THREADS,
                      per_sm // (smem + _RESERVED_PER_CTA)))


def _z_chunk(zdim: int, halo: int, tiles_xy: int, slots: int) -> int:
    """The z chunk whose grid fills ``slots`` concurrent CTAs in the
    fullest waves, weighted by the chunk's valid fraction
    ``zdim / (chunks·(zc + 2·halo))``; ties go to the larger chunk."""
    best = None
    for n in range(1, zdim + 1):
        zc = -(-zdim // n)
        chunks = -(-zdim // zc)
        ctas = chunks * tiles_xy
        waves = -(-ctas // slots)
        score = zdim / (chunks * (zc + 2 * halo)) * ctas / (waves * slots)
        if best is None or score > best[0] + 1e-12:
            best = (score, zc)
    return best[1]


@functools.lru_cache(maxsize=1024)
def fit_tile_3d(spec: StencilSpec, t: int, shape: tuple[int, int, int],
                hw: rl.HardwareModel, itemsize: int
                ) -> tuple[int, int, int, int] | None:
    """The CTA tile ``(zc, ty, tx, resident_ctas)`` of a depth-``t``
    3-D sweep over ``shape``, or ``None`` if no tile with ``tx`` a
    multiple of 32 (or ``x`` untiled) fits the per-block limit and the
    kernel's thread and register bounds (:func:`kernel_threads_3d`).

    In-plane it minimizes the cells loaded per output cell,
    ``Π (tiles·(tile + 2·halo)) / dim`` over tiled axes (padding
    included); then :func:`_z_chunk` sizes ``zc`` for the SM count at
    the resident CTAs the footprint allows."""
    zdim, ydim, xdim = shape
    h = spec.halo(t)
    limit = int(hw.onchip_bytes)
    best = None
    for ty, ny in _tile_choices(ydim, 1):
        for tx, nx in _tile_choices(xdim, COL_ALIGN):
            eff = ((ydim / (ny * (ty + 2 * h)) if ny > 1 else 1.0)
                   * (xdim / (nx * (tx + 2 * h)) if nx > 1 else 1.0))
            if best is not None and eff < best[0] - 1e-12:
                continue
            if smem_bytes_3d(spec, t, shape, ty, tx, itemsize) > limit:
                continue
            if kernel_threads_3d(spec, t, shape, ty, tx, itemsize) is None:
                continue
            key = (eff, ty * tx)
            if best is None or key > best[:2]:
                best = (eff, ty * tx, ty, tx, ny * nx)
    if best is None:
        return None
    _, _, ty, tx, tiles_xy = best
    resident = _resident_ctas(
        hw, smem_bytes_3d(spec, t, shape, ty, tx, itemsize))
    zc = _z_chunk(zdim, h, tiles_xy, hw.sm_count * resident)
    return zc, ty, tx, resident


def _plan_3d(spec: StencilSpec, hw: rl.HardwareModel,
             domain: tuple[int, int, int], max_t: int,
             itemsize: int) -> EbisuPlan:
    t = min(max_t, max(1, int(math.ceil(
        rl.desired_depth(spec, hw, rst=True)))))
    while t > 1 and fit_tile_3d(spec, t, domain, hw, itemsize) is None:
        t -= 1
    fit = fit_tile_3d(spec, t, domain, hw, itemsize)
    if fit is None:
        raise ValueError(
            f"{spec.name}: no CTA tile fits the {int(hw.onchip_bytes)} B "
            f"shared-memory limit of {hw.name} at {itemsize}-byte cells, "
            "even at t=1")
    zc, ty, tx, _ = fit
    h = spec.halo(t)
    d_all = math.prod(domain)
    t_sweep = rl.component_times(spec, t, hw, rst=True, d_all=d_all)
    v = zc / (zc + 2 * h)
    if (ty, tx) != tuple(domain[1:]):        # in-plane redundancy (Eq 9)
        v = max(0.01, v * rl.v_smtile(spec, t, (ty, tx)))
    v *= rl.v_dtile(max(t_sweep[:3]), hw, 1)
    res = rl.attainable(spec, t, hw, rst=True, v=v, d_all=d_all)
    return EbisuPlan(spec.name, hw.name, t, (zc, ty, tx), h, THREADS,
                     smem_bytes_3d(spec, t, domain, ty, tx, itemsize), res)


def plan(spec: StencilSpec, hw: rl.HardwareModel,
         domain: tuple[int, ...] | None = None, max_t: int = 32,
         itemsize: int | None = None) -> EbisuPlan:
    """The §6 plan for ``spec`` on ``hw``: depth (Eq 17, lowered until a
    tile fits), CTA tile, threads and shared memory.  ``itemsize`` is
    the compute dtype's size (default ``hw.s_cell``)."""
    domain = tuple(domain or spec.domain)
    itemsize = itemsize or hw.s_cell
    if spec.ndim == 3:
        return _plan_3d(spec, hw, domain, max_t, itemsize)
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

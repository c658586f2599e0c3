"""``StencilProgram`` on the card: the compile-once front door for temporal
blocking (counterpart of ``repro.api.program``).

``compile_stencil`` resolves the §6 plan, the CTA tile of every sweep
depth and the boundary execution strategy once, and returns an immutable
:class:`StencilProgram`:

    from repro_torch.api import compile_stencil
    from repro_torch.core.stencil_spec import get
    prog = compile_stencil(get("j2d5pt"), (8352, 8352), t=12)  # on cuda
    y = prog.apply(x)        # one sweep of 12 fused steps
    y = prog.run(x, 25)      # sweeps of depth 12, 12, then 1
    prog3 = compile_stencil(get("j3d7pt"), (2560, 288, 384), t=8)
    y = prog3.apply(x3)      # the z-streaming kernel
    prog_s = compile_stencil(get("j2d5pt"), (8352, 8352), t=12,
                             mode="stream")
    y = prog_s.apply(x)      # 2-D streamed in y as an (H, 1, W) domain
    ys = prog.run_batched(xs, 25)   # (B, 8352, 8352): one launch a sweep
    xp = prog.run_padded(xp, 24)    # the caller's padded carry

2-D specs run the tile kernel (``kernels/stencil2d.py``); 3-D specs, and
2-D specs under ``mode="stream"``, run the z-streaming kernel
(``kernels/stencil3d.py``), the 2-D field lifted to ``(H, 1, W)`` with
its boundary resolved before lifting.

Where the reference wraps the sweep chain in ``jax.jit`` and donates the
carry, the port runs an eager Python loop of kernel launches over two
ping-pong buffers: pad once, launch, swap, crop once (zero Dirichlet and
the constant Dirichlet shift), or re-pin the ghost halo every sweep
(periodic, reflect, neumann, and Dirichlet with an unnormalized tap set).
Where the reference ``jax.vmap``s that chain over a leading batch axis
(``run_batched``), the port's chain carries the axis through the same
steps, and each sweep is one launch for the whole batch: both kernels
take a batch of padded layouts in their grid.  ``run_padded`` chains
sweeps on a padded buffer the caller owns (2-D, zero Dirichlet).

``compile_stencil(..., mesh=)`` makes the program multi-device:
``run_sharded`` splits the field over a mesh of devices and exchanges a
``t·radius``-deep halo once per temporal block (``api/sharded.py``);
``run_resumable`` and ``run_sharded_resumable`` run the same steps as
checkpointed legs (``repro_torch.resilient``):

    mesh = make_stencil_mesh((2, 2), devices=["cuda:0"] * 4)
    prog_m = compile_stencil(get("j2d5pt"), (8352, 8352), t=12, mesh=mesh)
    y = prog_m.run_sharded(x, 25)   # 3 exchange rounds, not 25
    rep = prog.run_resumable(x, 25, store=CampaignStore(ckpt_dir))

``mode="tuned"`` replays a measured plan from the persistent plan DB
(``repro_torch.tuning``) with no timing, and an explicit ``plan=`` pins
the tile the sweeps launch, in 2-D and 3-D alike:

    prog_t = compile_stencil(get("j2d5pt"), (8352, 8352), mode="tuned",
                             plan_db="/path/to/db")
    prog_t.tuned["source"]          # "plandb" or "analytic_fallback"

Programs run on the card unless the caller asks for the CPU
(``device="cpu"``), where every sweep takes the kernel's plain version.
Both kernels build a library for every tap set ``validate_spec``
accepts.  ``plan=None`` compiles the deprecated shims' request-default
tiles (``DEFAULT_*``, :class:`TileRequest`) in place of a plan; the
shims themselves (``kernels/ops.py``, ``kernels/sweep.py``) warn at
call time (:func:`deprecated_entry`) and delegate here.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import threading
import warnings
from collections import OrderedDict

import torch

from repro_torch.api.boundary import ZERO, Boundary
from repro_torch.core import roofline as rl
from repro_torch.core.device import resolve_device
from repro_torch.core.planner import (COL_ALIGN, KERNEL_THREADS_3D,
                                      MAX_DEPTH_3D, ROW_ALIGN, THREADS,
                                      EbisuPlan, axis_reach, fit_tile_2d,
                                      fit_tile_3d, kernel_smem_bytes_3d,
                                      kernel_threads_3d, level_regions_3d,
                                      max_cells_per_thread,
                                      plan as make_plan,
                                      planes_per_barrier, smem_bytes_2d,
                                      smem_bytes_3d)
from repro_torch.core.spans import span
from repro_torch.core.stencil_spec import (StencilSpec, lift_2d_to_3d,
                                           validate_spec)
from repro_torch.kernels.stencil2d import (ebisu2d_padded, padded_shape_2d,
                                           strip_geometry)
from repro_torch.kernels.stencil3d import ebisu3d_padded, launch_geometry_3d
from repro_torch.kernels.taps import ghost_extend, tap_sum

# plan-less request-default tiles (the leading tile dimension the legacy
# entry points asked for; the reference's names and values)
DEFAULT_BH_2D = 128
DEFAULT_ZC_3D = 16
DEFAULT_ZC_STREAM_2D = 64

_BUCKET = 64


@dataclasses.dataclass(frozen=True)
class TileRequest:
    """The tiles of a program compiled with ``plan=None``: the leading
    tile dimension is the request default (``DEFAULT_BH_2D`` rows in
    2-D, ``DEFAULT_ZC_3D`` planes in 3-D, ``DEFAULT_ZC_STREAM_2D`` for
    the lifted ``stream`` sweep), floored at the halo as the reference's
    ``_tile_request`` floors it; the other dimensions follow the CUDA
    kernels' own rules (:func:`request_tile_2d`, :func:`request_tile_3d`)."""
    stream: bool = False


def request_tile_2d(spec: StencilSpec, t: int, shape: tuple[int, int],
                    hw: rl.HardwareModel, itemsize: int) -> dict:
    """The 2-D tile of a request-default sweep: ``bh = max(DEFAULT_BH_2D,
    halo)`` rows, and the widest multiple of 32 columns (capped at the
    aligned domain) whose two haloed tiles fit the shared-memory limit.
    Where none fits, ``bh`` is clipped (halved, in steps of 8 rows) until
    one does, and ``clipped`` says so."""
    h = spec.halo(t)
    want = max(DEFAULT_BH_2D, h)
    limit = int(hw.onchip_bytes)
    bh = want
    while True:
        bw = _widest_columns(spec, t, bh, shape[1], limit, itemsize)
        if bw >= COL_ALIGN:
            break
        if bh <= ROW_ALIGN:
            raise ValueError(
                f"{spec.name}: depth t={t} (halo {h}) leaves no CTA tile "
                f"within the {limit} B shared-memory limit of {hw.name} at "
                f"{itemsize}-byte cells, even at {bh} rows; lower t")
        bh = max(ROW_ALIGN, bh // 2 // ROW_ALIGN * ROW_ALIGN)
    return dict(default=DEFAULT_BH_2D, requested=want, block=(bh, bw),
                clipped=None if bh == want else
                f"bh {want} -> {bh}: two haloed {want}-row tiles of "
                f"{COL_ALIGN} columns exceed the {limit} B shared-memory "
                "limit")


def _widest_columns(spec: StencilSpec, t: int, bh: int, width: int,
                    limit: int, itemsize: int) -> int:
    """The widest multiple of 32 columns, capped at the aligned
    ``width``, whose two haloed ``bh``-row tiles fit ``limit`` bytes
    (below 32: none fits)."""
    h = spec.halo(t)
    cols = limit // (2 * itemsize * (bh + 2 * h)) - 2 * h
    return min(_round_up(width, COL_ALIGN), cols // COL_ALIGN * COL_ALIGN)


def request_tile_3d(spec: StencilSpec, t: int, shape: tuple[int, int, int],
                    hw: rl.HardwareModel, itemsize: int,
                    stream: bool = False) -> dict:
    """The 3-D tile of a request-default sweep: ``zc = max(DEFAULT_ZC_3D,
    halo)`` planes (``DEFAULT_ZC_STREAM_2D`` for a lifted ``stream``
    sweep), the in-plane tile ``(ty, tx)`` the planner fits within the
    kernel's shared-memory, thread and register bounds.  The z chunk is
    bound by none of them, so it is never clipped."""
    default = DEFAULT_ZC_STREAM_2D if stream else DEFAULT_ZC_3D
    zc = max(default, spec.halo(t))
    fit = fit_tile_3d(spec, t, tuple(shape), hw, itemsize)
    if fit is None:
        raise ValueError(
            f"{spec.name}: depth t={t} (halo {spec.halo(t)}) leaves no CTA "
            f"tile within the {int(hw.onchip_bytes)} B shared-memory limit "
            f"of {hw.name} at {itemsize}-byte cells; lower t")
    return dict(default=default, requested=zc, block=(zc, fit[1], fit[2]),
                clipped=None)


# =========================================================== ProgramCache ==
class ProgramCache:
    """Bounded LRU cache with hit/miss/eviction counters (thread-safe;
    ``get_or_build`` builds a missing key once under the lock).

        c = ProgramCache(maxsize=2, name="demo")
        c.get_or_build("k", lambda: 42)    # -> 42 (miss, built)
        c.get("k"), c.stats()["hits"]      # -> 42, 1
    """

    def __init__(self, maxsize: int = 128, name: str = ""):
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        self.maxsize = maxsize
        self.name = name
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._lock = threading.RLock()
        self._d: OrderedDict = OrderedDict()

    def get(self, key, default=None):
        with self._lock:
            try:
                val = self._d[key]
            except KeyError:
                self.misses += 1
                return default
            self._d.move_to_end(key)
            self.hits += 1
            return val

    def put(self, key, value) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)
                self.evictions += 1

    def get_or_build(self, key, build):
        sentinel = object()
        with self._lock:
            val = self.get(key, sentinel)
            if val is sentinel:
                val = build()
                self.put(key, val)
            return val

    def clear(self) -> None:
        with self._lock:
            self.evictions += len(self._d)
            self._d.clear()

    def stats(self) -> dict:
        with self._lock:
            return {"name": self.name, "size": len(self._d),
                    "maxsize": self.maxsize, "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions}

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._d


PROGRAM_CACHE = ProgramCache(64, "programs")   # compile_stencil results
PLAN_CACHE = ProgramCache(256, "plans")        # §6 plans, shape-bucketed
RUNNER_CACHE = ProgramCache(128, "runners")    # sweep chains per launch


def cache_stats() -> dict:
    """Hit/miss/size counters of the three bounded caches."""
    return {c.name: c.stats()
            for c in (PROGRAM_CACHE, PLAN_CACHE, RUNNER_CACHE)}


def clear_caches() -> None:
    for c in (PROGRAM_CACHE, PLAN_CACHE, RUNNER_CACHE):
        c.clear()


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def plan_bucketed(spec: StencilSpec, shape: tuple[int, ...],
                  hw: rl.HardwareModel = rl.H100,
                  itemsize: int | None = None) -> EbisuPlan:
    """§6 plan memoized per (tap structure, 64-rounded domain, hardware,
    cell size) — keyed on ``spec.signature``, never the name.  An extent
    of 1 (the lifted 2-D ``stream`` domain's y) is kept as it is.

        p = plan_bucketed(get("j2d5pt"), (512, 512))
        p.t, p.block          # §6.2 depth, CTA tile
    """
    itemsize = itemsize or hw.s_cell
    bucket = tuple(_round_up(d, _BUCKET) if d > 1 else d for d in shape)
    key = (spec.signature, bucket, hw.name, itemsize)
    return PLAN_CACHE.get_or_build(
        key, lambda: make_plan(spec, hw, domain=bucket, itemsize=itemsize))


# ======================================================= geometry / sweep ==
def sweep_tile(spec: StencilSpec, t: int, shape: tuple[int, int],
               hw: rl.HardwareModel, itemsize: int,
               plan: EbisuPlan | None = None) -> tuple[int, int]:
    """The CTA tile of a depth-``t`` sweep over ``shape``: the plan's own
    tile at the plan's depth (refused if the kernel cannot take it), else
    the §6.4 fit for this depth."""
    if plan is not None and plan.t == t:
        bh, bw = plan.block
        smem = smem_bytes_2d(spec, t, *strip_geometry(spec, t, bh, bw)[:2],
                             itemsize)
        if smem > hw.onchip_bytes:
            raise ValueError(
                f"{spec.name}: tile ({bh}, {bw}) at t={t} needs {smem} B "
                f"of shared memory (two haloed tiles), over the "
                f"{int(hw.onchip_bytes)} B shared-memory limit of "
                f"{hw.name}; pin a smaller tile or a lower t")
        return bh, bw
    fit = fit_tile_2d(spec, t, shape, hw, itemsize)
    if fit is None:
        raise ValueError(
            f"{spec.name}: depth t={t} (halo {spec.halo(t)}) leaves no CTA "
            f"tile within the {int(hw.onchip_bytes)} B shared-memory limit "
            f"of {hw.name} at {itemsize}-byte cells; lower t")
    return fit[0], fit[1]


def check_tile_3d(spec: StencilSpec, t: int, shape: tuple[int, int, int],
                  block: tuple[int, int, int], hw: rl.HardwareModel,
                  itemsize: int) -> None:
    """Refuse a pinned 3-D tile ``(zc, ty, tx)`` the z-streaming kernel
    cannot launch at depth ``t``, naming the bound it breaks: the levels
    a sweep holds (``MAX_DEPTH_3D``), the threads of a CTA at the cells a
    thread may own (``kernel_threads_3d``, ``max_cells_per_thread``), or
    the shared-memory limit."""
    zc, ty, tx = block
    where = f"{spec.name}: tile ({zc}, {ty}, {tx}) at t={t}"
    if min(zc, ty, tx) < 1:
        raise ValueError(f"{where}: tile extents must be >= 1")
    if t > MAX_DEPTH_3D:
        raise ValueError(f"{where}: the kernel holds at most MAX_DEPTH_3D="
                         f"{MAX_DEPTH_3D} levels a sweep "
                         "(kernel_threads_3d); pin a lower t")
    if kernel_threads_3d(spec, t, shape, ty, tx, itemsize) is None:
        cells = sum(ny * nx for ny, nx in
                    level_regions_3d(spec, t, shape, ty, tx))
        kmax = max_cells_per_thread(spec.radius, itemsize)
        raise ValueError(
            f"{where}: its levels compute {cells} cells a plane, more than "
            f"KERNEL_THREADS_3D={KERNEL_THREADS_3D} threads hold at "
            f"max_cells_per_thread={kmax} ({itemsize}-byte cells, radius "
            f"{spec.radius}) (kernel_threads_3d); pin a smaller in-plane "
            "tile or a lower t")
    smem = kernel_smem_bytes_3d(spec, t, shape, ty, tx, itemsize)
    if smem > hw.onchip_bytes:
        raise ValueError(
            f"{where}: the kernel allocates {smem} B of shared memory, over "
            f"the {int(hw.onchip_bytes)} B shared-memory limit of "
            f"{hw.name}; pin a smaller in-plane tile or a lower t")


def sweep_tile_3d(spec: StencilSpec, t: int, shape: tuple[int, int, int],
                  hw: rl.HardwareModel, itemsize: int,
                  plan: EbisuPlan | None = None) -> tuple[int, int, int]:
    """The CTA tile ``(zc, ty, tx)`` of a depth-``t`` 3-D sweep over
    ``shape``: a pinned plan's own tile at the plan's depth (refused by
    :func:`check_tile_3d` if the kernel cannot take it), else the
    planner's fit for this very shape (the analytic plan's tile, planned
    for the 64-rounded extent, could cover, and so untile, an axis it
    should rim, so programs pass it here only when the caller pinned
    it)."""
    if plan is not None and plan.t == t:
        block = tuple(int(b) for b in plan.block)
        if len(block) != 3:
            raise ValueError(f"{spec.name}: a 3-D sweep pins a (zc, ty, tx) "
                             f"tile; the plan's block is {plan.block}")
        check_tile_3d(spec, t, shape, block, hw, itemsize)
        return block
    fit = fit_tile_3d(spec, t, tuple(shape), hw, itemsize)
    if fit is None:
        raise ValueError(
            f"{spec.name}: depth t={t} (halo {spec.halo(t)}) leaves no CTA "
            f"tile within the {int(hw.onchip_bytes)} B shared-memory limit "
            f"of {hw.name} at {itemsize}-byte cells; lower t")
    return fit[:3]


def resolve_geometry(spec: StencilSpec, t: int, shape: tuple[int, ...], *,
                     hw: rl.HardwareModel = rl.H100, itemsize: int = 4,
                     plan: EbisuPlan | TileRequest | None = None,
                     mode: str = "fused") -> dict:
    """The launch a depth-``t`` sweep over ``shape`` executes: CTA tile,
    grid, halo, padded layout, threads, shared memory, the cells each
    CTA loads (``fetched_cells``) and writes (``body_cells``), and the
    stencil applications the launch computes, trapezoid included
    (``cell_updates``).  A 3-D spec (a ``stream`` program's lifted one
    among them) resolves the z-streaming launch, with the kernel's own
    shared memory (``kernel_smem_bytes``) beside the planner's budget;
    ``mode="stream"`` lifts a 2-D spec and ``(H, W)`` itself.  ``plan``
    pins the tile at its depth, in 2-D and 3-D alike; a
    :class:`TileRequest` resolves the request-default tile, and the
    geometry's ``tile_request`` says what was asked and whether the
    kernel's bounds clipped it.

        g = resolve_geometry(get("j2d5pt"), 4, (512, 512))
        g["grid"], g["block"], g["halo"]    # what apply() will launch
    """
    if mode == "stream" and spec.ndim == 2:
        spec, shape = lift_2d_to_3d(spec), (shape[0], 1, shape[1])
    if isinstance(plan, TileRequest):
        req = (request_tile_3d(spec, t, shape, hw, itemsize, plan.stream)
               if spec.ndim == 3 else
               request_tile_2d(spec, t, shape, hw, itemsize))
        return dict(_launch_geometry(spec, t, shape, req["block"], itemsize),
                    tile_request={k: req[k] for k in ("default", "requested",
                                                      "clipped")})
    if spec.ndim == 3:
        block = sweep_tile_3d(spec, t, shape, hw, itemsize, plan)
    else:
        block = sweep_tile(spec, t, shape, hw, itemsize, plan)
    return _launch_geometry(spec, t, shape, block, itemsize)


def _launch_geometry(spec: StencilSpec, t: int, shape: tuple[int, ...],
                     block: tuple, itemsize: int) -> dict:
    """The geometry of a depth-``t`` sweep launched at tile ``block``."""
    if spec.ndim == 3:
        zc, ty, tx = block
        return launch_geometry_3d(spec, t, shape, zc=zc, ty=ty, tx=tx,
                                  itemsize=itemsize)
    bh, bw, halo = strip_geometry(spec, t, *block)
    hp, wp = padded_shape_2d(spec, t, bh, bw, *shape)
    ry, rx = axis_reach(spec, 0), axis_reach(spec, 1)
    grid = (hp // bh, wp // bw)
    return dict(grid=grid, block=(bh, bw), halo=halo,
                padded=(hp, wp), threads=THREADS,
                smem_bytes=smem_bytes_2d(spec, t, bh, bw, itemsize),
                fetched_cells=(bh + 2 * halo) * (bw + 2 * halo),
                body_cells=bh * bw,
                cell_updates=math.prod(grid) * sum(
                    (bh + 2 * (t - s) * ry) * (bw + 2 * (t - s) * rx)
                    for s in range(1, t + 1)))


def kernel_view(spec: StencilSpec, kernel_spec: StencilSpec,
                shape: tuple[int, ...]):
    """The kernel's domain for a domain ``shape`` of ``spec``, and where
    ``spec``'s field lies in the kernel's padded buffer.  A ``stream``
    program's kernel spec is the lifted one: its ``(H, W)`` field is the
    one y row of an ``(H, 1, W)`` kernel domain."""
    if kernel_spec.ndim == spec.ndim:
        return shape, tuple(slice(0, n) for n in shape)
    height, width = shape
    return (height, 1, width), (slice(0, height), 0, slice(0, width))


# ===================================================== multi-sweep runner ==
def sweep_schedule(total_t: int, t: int) -> tuple[int, ...]:
    """Per-sweep depths covering ``total_t`` steps: full-depth sweeps plus
    one shallower remainder sweep when ``t`` does not divide ``total_t``.

        sweep_schedule(10, 4)    # -> (4, 4, 2)
    """
    if total_t < 0 or t < 1:
        raise ValueError(f"need total_t >= 0 and t >= 1, got {total_t}, {t}")
    q, r = divmod(total_t, t)
    return (t,) * q + ((r,) if r else ())


def _grouped(schedule: tuple[int, ...]) -> list[tuple[int, int]]:
    """Runs of equal depth: [(depth, count), ...] — one layout per run."""
    out: list[list[int]] = []
    for d in schedule:
        if out and out[-1][0] == d:
            out[-1][1] += 1
        else:
            out.append([d, 1])
    return [(d, c) for d, c in out]


def _sweep_launch(spec: StencilSpec, t: int, shape: tuple[int, ...],
                  hw: rl.HardwareModel, itemsize: int,
                  plan: EbisuPlan | None):
    """One depth-``t`` sweep of the kernel ``spec`` over its domain
    ``shape`` as ``(padded shape, sweep(xp, out=buf))``."""
    g = resolve_geometry(spec, t, shape, hw=hw, itemsize=itemsize,
                         plan=plan)
    if spec.ndim == 2:
        (bh, bw), (height, width) = g["block"], shape
        return g["padded"], functools.partial(
            ebisu2d_padded, spec=spec, t=t, height=height, width=width,
            bh=bh, bw=bw)
    zc, ty, tx = g["block"]
    return g["padded"], functools.partial(
        ebisu3d_padded, spec=spec, t=t, zdim=shape[0], ydim=shape[1],
        xdim=shape[2], zc=zc, ty=ty, tx=tx)


def _build_chain(spec: StencilSpec, shape: tuple[int, ...],
                 dtype: torch.dtype, total_t: int, depth: int,
                 plan: EbisuPlan | None, hw: rl.HardwareModel,
                 boundary: Boundary,
                 compute_dtype: torch.dtype, kernel_spec: StencilSpec):
    """The multi-sweep schedule as ``f(x) -> x``, for 2-D and 3-D specs
    and the lifted 2-D ``stream`` sweep alike: the boundary is resolved
    on ``spec``'s field and every sweep launches ``kernel_spec`` (under
    ``stream`` the lifted spec, see :func:`kernel_view`).

    Zero Dirichlet, and Dirichlet(v) with taps summing to 1 (the exact
    constant shift): pad once per depth group, launch the sweeps over two
    ping-pong buffers, crop once.  Dirichlet(v) with tap sum ``s ≠ 1``
    (depth-1 sweeps only): ``u' = Z_1(u − v) + v·s`` around every sweep.
    Periodic / reflect / neumann: the padded layout is not closed under
    the boundary, so every sweep re-pins the ghost halo from the evolved
    field (on the spec's own axes: a ``stream`` sweep's size-1 lifted
    axis is never ghost-extended) and runs on the extended domain.
    Buffers are ``compute_dtype``; only the result is cast to ``dtype``.
    One sweep (``total_t == depth``) is what :meth:`StencilProgram.apply`
    runs.  A field with a leading batch axis keeps it through every step
    (each buffer gains it, so each sweep is one launch for the batch).
    """
    repin = boundary.kind in ("periodic", "reflect", "neumann")
    s = tap_sum(spec.taps)
    affine = (boundary.kind == "dirichlet" and boundary.value != 0.0
              and abs(s - 1.0) > 1e-6)
    shift = boundary.value if boundary.kind == "dirichlet" else 0.0

    def halo_of(d: int) -> int:
        return spec.halo(d) if repin else 0

    def ext(d: int) -> tuple[int, ...]:
        return tuple(n + 2 * halo_of(d) for n in shape)

    with span("repro_torch.chain.build"):
        boundary.validate_for(spec, t=depth)
        groups = _grouped(sweep_schedule(total_t, depth))
        itemsize = torch.empty((), dtype=compute_dtype).element_size()
        launches = {}
        for d, _ in groups:
            kshape, index = kernel_view(spec, kernel_spec, ext(d))
            launches[d] = (*_sweep_launch(kernel_spec, d, kshape, hw,
                                          itemsize, plan), index)

    def chain(v: torch.Tensor) -> torch.Tensor:
        lead = tuple(v.shape[:v.dim() - spec.ndim])      # the batch axis
        for d, count in groups:
            padded, sweep, index = launches[d]
            index = (Ellipsis, *index)
            halo = halo_of(d)
            crop = (Ellipsis, *(slice(halo, halo + n) for n in shape))
            with span("repro_torch.chain.pad"):
                xp = torch.zeros(lead + padded, dtype=compute_dtype,
                                 device=v.device)
                buf = torch.empty_like(xp)
                if not (repin or affine):
                    xp[index] = v
            if repin or affine:
                for _ in range(count):
                    w = v - shift if affine else v
                    xp[index] = (ghost_extend(w, spec.ndim, halo, boundary)
                                 if repin else w)
                    sweep(xp, out=buf)
                    # a view of buf: read (ghost_extend / the shift
                    # makes a new tensor) before the next sweep writes buf
                    v = buf[index][crop]
                    if affine:
                        v = v + shift * s ** d
            else:
                for _ in range(count):
                    sweep(xp, out=buf)
                    xp, buf = buf, xp
                v = xp[index]
        return v

    if boundary.kind == "dirichlet" and boundary.value != 0.0 and not affine:
        def run(x):
            with span("repro_torch.chain.run"):
                v = chain(x.to(compute_dtype) - shift)
                with span("repro_torch.chain.crop"):
                    return (v + shift).to(dtype)
    else:
        def run(x):
            with span("repro_torch.chain.run"):
                v = chain(x.to(compute_dtype))
                with span("repro_torch.chain.crop"):
                    return v.to(dtype).contiguous()
    return run


# ============================================================== programs ==
def _plan_key(plan: EbisuPlan | None):
    if plan is None:
        return None
    return (plan.hw_name, plan.t, plan.block, plan.threads)


class StencilProgram:
    """An immutable compiled 2-D or 3-D stencil: spec + domain shape + §6
    plan + boundary + mode + device, with memoized sweep chains.
    Construct via :func:`compile_stencil`:

        prog = compile_stencil(get("j2d5pt"), (512, 512), t=4)
        y = prog.apply(x)            # one temporally-blocked sweep
        y = prog.run(x, 64)          # 64 steps as 16 chained sweeps
    """

    def __init__(self, key, spec: StencilSpec, shape: tuple[int, ...],
                 dtype: torch.dtype, t: int, plan: EbisuPlan,
                 hw: rl.HardwareModel, boundary: Boundary, mode: str,
                 device: torch.device, compute_dtype: torch.dtype,
                 kernel_spec: StencilSpec, mesh=None, pinned: bool = False,
                 tuned: dict | None = None):
        self._key = key
        self.spec = spec
        self.shape = shape
        self.dtype = dtype
        self.t = t
        self.plan = plan
        self.hw = hw
        self.boundary = boundary
        self.mode = mode
        self.device = device
        self.compute_dtype = compute_dtype
        self.kernel_spec = kernel_spec   # the lifted spec under "stream"
        self.mesh = mesh                 # a launch.mesh.Mesh, or None
        self.pinned = pinned             # the caller's (or the DB's) plan
        self.tuned = tuned               # mode="tuned" provenance, or None

    @property
    def tile_plan(self) -> EbisuPlan | TileRequest | None:
        """The plan whose tile the sweeps launch at its depth: a pinned
        plan always; the analytic plan in 2-D only (a 3-D sweep re-fits
        its tile for the exact shape, see :func:`sweep_tile_3d`); the
        request-default tiles without a plan (``plan=None``)."""
        if self.plan is None:
            return TileRequest(stream=self.mode == "stream")
        return (self.plan if self.pinned or self.kernel_spec.ndim == 2
                else None)

    # ------------------------------------------------------- execution ----
    def _check(self, x, batched: bool = False) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x, device=self.device)
        if tuple(x.shape[1:] if batched else x.shape) != self.shape:
            raise ValueError(
                f"program compiled for shape {self.shape} "
                f"({'batched ' if batched else ''}got {tuple(x.shape)}); "
                "compile_stencil a new program for a new domain shape")
        if x.device != self.device:
            raise ValueError(f"program compiled for {self.device}; the "
                             f"field is on {x.device}")
        return x

    def apply(self, x, t: int | None = None) -> torch.Tensor:
        """One temporally-blocked sweep of depth ``t`` (default: the
        program's depth).

            y = prog.apply(x)        # == t plain steps, one memory pass
        """
        x = self._check(x)
        depth = self.t if t is None else t
        if depth < 1:
            raise ValueError(f"temporal depth must be >= 1, got {depth} "
                             "(run(x, 0) is the identity)")
        fn = RUNNER_CACHE.get_or_build(
            (self._key, "apply", depth),
            lambda: _build_chain(self.spec, self.shape, self.dtype, depth,
                                 depth, self.tile_plan, self.hw,
                                 self.boundary, self.compute_dtype,
                                 self.kernel_spec))
        return fn(x)

    def run(self, x, total_t: int) -> torch.Tensor:
        """``total_t`` steps as chained sweeps (a shallower remainder
        sweep when the depth does not divide ``total_t``).

            y = prog.run(x, 10)     # t=4: sweeps of depth 4, 4, then 2

        A ``mode="stream"`` program runs one sweep (``apply``) only, as the
        reference's does.
        """
        x = self._check(x)
        return self._run_fn(total_t)(x) if total_t else x

    def _run_fn(self, total_t: int):
        if self.mode == "stream":
            raise ValueError(
                "run supports mode 'fused' (use apply for the lifted "
                "'stream' path)")
        depth = max(1, min(self.t, total_t))
        return RUNNER_CACHE.get_or_build(
            (self._key, "run", total_t),
            lambda: _build_chain(self.spec, self.shape, self.dtype, total_t,
                                 depth, self.tile_plan, self.hw,
                                 self.boundary, self.compute_dtype,
                                 self.kernel_spec))

    def run_batched(self, xs, total_t: int | None = None) -> torch.Tensor:
        """A leading batch axis of independent fields through the chain of
        :meth:`run`, one kernel launch per sweep for the whole batch
        (``total_t`` defaults to the program's depth).

            xs = torch.stack([x0, x1, x2])      # (3, *prog.shape)
            ys = prog.run_batched(xs, 64)       # one launch a sweep
        """
        xs = self._check(xs, batched=True)
        total_t = self.t if total_t is None else total_t
        return self._run_fn(total_t)(xs) if total_t else xs

    @property
    def padded_shape(self) -> tuple[int, ...]:
        """The padded layout of a sweep at the program's depth: the
        buffer :meth:`run_padded` carries."""
        return tuple(self.geometry()["padded"])

    def run_padded(self, xp: torch.Tensor, total_t: int) -> torch.Tensor:
        """``total_t`` steps on a padded buffer the caller owns (2-D,
        zero Dirichlet, ``mode="fused"`` or ``"scratch"``, the program's depth dividing
        ``total_t``): ``xp`` has :attr:`padded_shape` and the compute
        dtype, the domain at its origin.  The sweeps ping-pong ``xp``
        with one partner buffer and return the one holding the result;
        as with the reference's donated carry, do not rely on ``xp``
        after the call.

            xp = torch.zeros(prog.padded_shape, device="cuda")
            xp[:h, :w] = x
            xp = prog.run_padded(xp, 24)        # xp[:h, :w] == run(x, 24)
        """
        if (self.spec.ndim != 2 or not self.boundary.is_zero_dirichlet
                or self.mode not in ("fused", "scratch")):
            raise ValueError("run_padded is the 2-D zero-Dirichlet "
                             "padded-carry path (fused); use run()")
        if xp.dtype != self.compute_dtype:
            raise ValueError(
                f"run_padded carry is the compute buffer: expected dtype "
                f"{str(self.compute_dtype).removeprefix('torch.')}, got "
                f"{str(xp.dtype).removeprefix('torch.')} (the caller owns "
                "the padded buffer at the program's compute_dtype)")
        if tuple(xp.shape) != self.padded_shape:
            raise ValueError(
                f"run_padded carry has the program's padded_shape "
                f"{self.padded_shape}; got {tuple(xp.shape)}")
        if xp.device != self.device:
            raise ValueError(f"program compiled for {self.device}; the "
                             f"carry is on {xp.device}")
        if total_t % self.t:
            raise ValueError(
                f"padded chaining needs a uniform sweep depth: the "
                f"program's t={self.t} must divide total_t={total_t}")
        itemsize = xp.element_size()
        _, sweep = _sweep_launch(self.spec, self.t, self.shape, self.hw,
                                 itemsize, self.tile_plan)
        buf = torch.empty_like(xp) if total_t else xp
        for _ in range(total_t // self.t):
            sweep(xp, out=buf)
            xp, buf = buf, xp
        return xp

    def run_sharded(self, x, total_t: int) -> torch.Tensor:
        """``total_t`` steps over the program's device mesh, exchanging
        deep ghost zones **once per temporal block** instead of once per
        step (``api/sharded.py``).

        Each mesh position holds one uniform shard (mesh axis ``k`` over
        tensor dim ``k``) as its own tensor on its device; per block of
        depth ``d``, neighbour shards swap ``d·radius``-deep halo slabs
        (one exchange per direction per sharded dim, corners via two
        hops) and run the trapezoid-narrowed chain locally, in plain
        torch.  A mesh of total size 1 falls back to :meth:`run`, and so
        launches the stencil kernel on the card.

            prog = compile_stencil(spec, (256, 512), t=4, mesh=(2, 4))
            y = prog.run_sharded(x, 64)       # 16 exchange rounds, not 64

        Requires a program compiled with ``mesh=``.  The reference
        donates its operand and returns a sharded global ``jax.Array``;
        the port has no global sharded tensor, so ``x`` is split at the
        call and the shards are assembled into one tensor on ``x``'s
        device at the end.
        """
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x, device=self.device)
        if tuple(x.shape) != self.shape:
            raise ValueError(
                f"program compiled for shape {self.shape} (got "
                f"{tuple(x.shape)}); compile_stencil a new program for a "
                "new domain shape")
        if self.mesh is None:
            raise ValueError(
                "run_sharded needs a mesh-compiled program: "
                "compile_stencil(spec, shape, mesh=(2, 4)) or mesh=8")
        if total_t == 0:
            return x
        if self.mesh.size == 1:                 # 1-device mesh: no seams
            return self.run(x, total_t)
        from repro_torch.api import sharded
        fn = RUNNER_CACHE.get_or_build(
            (self._key, "sharded", total_t),
            lambda: sharded.build_sharded_runner(self, total_t))
        return fn(x)

    # ----------------------------------------------- resumable campaigns ----
    def run_resumable(self, x, total_t: int, *, store, every: int = 1,
                      **kwargs):
        """``total_t`` steps as checkpointed legs of ``every`` temporal
        blocks, resumable after a crash and **bit-exact** equal to
        :meth:`run` (legs are aligned to temporal blocks, so a campaign
        launches the same sweeps on the same inputs).

            store = CampaignStore("/ckpt/heat2d")
            rep = prog.run_resumable(x, 512, store=store, every=2)
            # ... SIGKILL mid-campaign ...
            rep = prog.run_resumable(x, 512, store=store)   # picks up

        Keyword knobs (``policy=``, ``health=``, ``faults=``, ``clock=``,
        ``resume=``, ``on_leg=``) pass through to
        :func:`repro_torch.resilient.runner.run_campaign`; returns its
        :class:`~repro_torch.resilient.runner.CampaignReport` (the final
        field is ``report.result``).
        """
        from repro_torch.resilient import runner
        return runner.run_campaign(self, x, total_t, store=store,
                                   every=every, sharded=False, **kwargs)

    def run_sharded_resumable(self, x, total_t: int, *, store,
                              every: int = 1, **kwargs):
        """The sharded twin of :meth:`run_resumable`: checkpointed legs
        of :meth:`run_sharded` over the program's mesh, plus elastic
        restore onto a smaller mesh when a device drops (the default
        ``RetryPolicy(elastic=True)``)."""
        if self.mesh is None:
            raise ValueError(
                "run_sharded_resumable needs a mesh-compiled program: "
                "compile_stencil(spec, shape, mesh=(2, 4))")
        from repro_torch.resilient import runner
        return runner.run_campaign(self, x, total_t, store=store,
                                   every=every, sharded=True, **kwargs)

    # ---------------------------------------------------- introspection ----
    def fingerprint(self) -> dict:
        """A JSON-safe identity card for checkpoint manifests: what a
        resumed campaign must match (spec signature, shape, dtypes,
        boundary, depth, mode, hw) plus what may drift only elastically
        (mesh, plan) — see ``repro_torch.resilient.store``."""
        return {
            "spec_name": self.spec.name,
            "spec_signature": repr(self.spec.signature),
            "shape": list(self.shape),
            "dtype": str(self.dtype).removeprefix("torch."),
            "compute_dtype": str(self.compute_dtype).removeprefix("torch."),
            "boundary": repr(self.boundary),
            "t": int(self.t),
            "mode": self.mode,
            "hw": self.hw.name,
            "device": str(self.device),
            "plan": repr(_plan_key(self.plan)),
            "mesh": (None if self.mesh is None
                     else {k: int(v) for k, v in self.mesh.shape.items()}),
        }

    def compute_shape(self, t: int | None = None) -> tuple[int, ...]:
        """The domain the kernel computes: the program shape, extended by
        ``t·rad`` per side for ghost-pinned boundaries."""
        depth = self.t if t is None else t
        if self.boundary.kind in ("periodic", "reflect", "neumann"):
            h = self.spec.halo(depth)
            return tuple(n + 2 * h for n in self.shape)
        return self.shape

    def geometry(self, t: int | None = None) -> dict:
        """The launch a depth-``t`` sweep resolves (see
        :func:`resolve_geometry`)."""
        depth = self.t if t is None else t
        itemsize = torch.empty((), dtype=self.compute_dtype).element_size()
        kshape, _ = kernel_view(self.spec, self.kernel_spec,
                                self.compute_shape(depth))
        return resolve_geometry(self.kernel_spec, depth, kshape, hw=self.hw,
                                itemsize=itemsize, plan=self.tile_plan)

    def cost(self, t: int | None = None) -> rl.RooflineResult:
        """§5 practical-attainable estimate at depth ``t``: the plan's own
        prediction at its depth, the ideal-V roofline elsewhere."""
        depth = self.t if t is None else t
        if self.plan is not None and depth == self.plan.t:
            return self.plan.pp
        return rl.attainable(self.spec, depth, self.hw, rst=True,
                             d_all=math.prod(self.shape))

    def cache_stats(self) -> dict:
        return cache_stats()

    def __repr__(self) -> str:
        return (f"StencilProgram({self.spec.name}, shape={self.shape}, "
                f"t={self.t}, boundary={self.boundary!r}, "
                f"hw={self.hw.name}, device={self.device}, "
                f"dtype={self.dtype}/{self.compute_dtype})")


def resolve_compute_dtype(dtype: torch.dtype,
                          compute_dtype: torch.dtype | None = None
                          ) -> torch.dtype:
    """The dtype policy: compute in ``compute_dtype`` when given, else in
    the storage dtype promoted to at least float32 (bf16 fields are
    stored narrow and stepped in f32; f64 computes in f64).  The kernel
    computes in float32 or float64 only.

        resolve_compute_dtype(torch.bfloat16)               # float32
        resolve_compute_dtype(torch.float32, torch.float64) # float64
    """
    if not dtype.is_floating_point:
        raise ValueError(f"stencil cell dtype must be floating, got {dtype}")
    cd = (compute_dtype if compute_dtype is not None
          else torch.promote_types(dtype, torch.float32))
    if cd not in (torch.float32, torch.float64):
        raise ValueError(f"compute_dtype must be torch.float32 or "
                         f"torch.float64, got {cd}")
    return cd


def compile_stencil(spec: StencilSpec, shape: tuple[int, ...], *,
                    dtype: torch.dtype = torch.float32,
                    t: int | None = None,
                    hw: rl.HardwareModel | None = None,
                    boundary: Boundary | None = None, mode: str = "fused",
                    compute_dtype: torch.dtype | None = None, mesh=None,
                    device=None, plan: EbisuPlan | None | str = "auto",
                    plan_db=None) -> StencilProgram:
    """Compile a 2-D or 3-D stencil to an immutable
    :class:`StencilProgram`.

        from repro_torch.api import Boundary, compile_stencil
        prog = compile_stencil(spec, (4096, 4096), t=8,
                               boundary=Boundary.periodic())
        y = prog.run(x, 64)

    ``mode`` is ``"fused"`` (2-D: the tile kernel; 3-D: the z-streaming
    kernel), ``"scratch"``, or, for a 2-D spec, ``"stream"``: the 2-D
    field streamed through the z-streaming kernel as an ``(H, 1, W)``
    domain, planned on the lifted spec (``apply`` only, as in the
    reference).  ``"scratch"`` is the reference's TPU kernel that keeps
    its steps in scratch buffers; on the card it runs the same tile
    kernel as ``"fused"``, whose steps already ping-pong between two
    shared-memory buffers, and a 3-D spec ignores it, as the
    reference's does.

    ``device`` defaults to the current CUDA device and raises if there is
    none; ``device="cpu"`` runs the plain version.  ``hw`` defaults to the
    H100 model of that device (``roofline.hardware_for``).  ``t`` is the
    per-sweep depth (default: the plan's §6.2 choice, see
    :func:`plan_bucketed`).  ``dtype`` is cell storage and ``compute_dtype`` what the kernel runs
    in (see :func:`resolve_compute_dtype`).  Programs are memoized:
    recompiling with identical arguments returns the same handle.

    ``plan`` is normally derived (``"auto"``); an explicit ``EbisuPlan``
    is honored verbatim: its tile drives every sweep of its depth, in 2-D
    and 3-D, and a tile the kernel cannot take raises ``ValueError`` here,
    naming the bound it breaks.  ``plan=None`` runs the legacy
    request-default tiles (:class:`TileRequest`; depth ``t``, default 1);
    ``geometry()["tile_request"]`` says whether the kernel's bounds
    clipped one.

    ``mode="tuned"`` resolves (t, tile, kernel family) from the
    persistent plan DB (``repro_torch.tuning``): a hit replays the
    measured winner with no search and no timing; a miss falls back to
    the analytic plan (``mode="fused"``).  Either way ``prog.tuned``
    records the provenance.  ``plan_db`` is a ``PlanDB``, a directory, or
    ``None`` for the default one; only ``mode="tuned"`` reads it.

    ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`, an int, or a
    tuple — mesh axis ``k`` shards tensor dim ``k``) makes the program
    multi-device: the §6 plan is resolved **per shard**, shard uniformity
    and halo fit are validated here with the fix spelled out, and
    :meth:`StencilProgram.run_sharded` becomes available.  An int or
    tuple takes ``n`` CPU shards on a ``device="cpu"`` program and the
    visible GPUs otherwise; a Mesh without ``device`` puts the program on
    the mesh's first device::

        mesh = make_stencil_mesh((2, 2), devices=["cuda:0"] * 4)
        prog = compile_stencil(spec, (256, 512), t=4, mesh=mesh)
        y = prog.run_sharded(x, 64)     # one halo exchange per 4 steps
    """
    validate_spec(spec)
    if mode == "tuned":
        # the DB record supplies depth, tile and kernel family: explicit
        # overrides would make the record a lie, so they are refused
        if t is not None:
            raise ValueError(
                "mode='tuned' resolves t from the plan DB; drop t= "
                "(or compile mode='fused' with an explicit t to pin "
                "depth yourself)")
        if not (isinstance(plan, str) and plan == "auto"):
            raise ValueError(
                "mode='tuned' resolves the plan from the plan DB; drop "
                "plan= (pass an explicit EbisuPlan with mode='fused'/"
                "'scratch' to pin tiles yourself)")
        if mesh is not None:
            raise ValueError(
                "mode='tuned' records are single-device measurements; "
                "compile mesh= programs with an explicit mode (the "
                "per-shard plan is derived analytically)")
    elif mode not in ("fused", "scratch", "stream"):
        raise ValueError(f"unknown mode {mode!r}; expected 'fused', "
                         "'scratch', 'tuned' or, for a 2-D spec, 'stream'")
    if mode == "stream" and spec.ndim != 2:
        raise ValueError(f"mode='stream' lifts a 2-D stencil; {spec.name} "
                         "is 3-D and always streams z (mode='fused')")
    if plan is not None and not isinstance(plan, (str, EbisuPlan)):
        raise ValueError(f"plan must be an EbisuPlan, None or 'auto'; got "
                         f"{type(plan).__name__}")
    if isinstance(plan, str) and plan != "auto":
        raise ValueError(f"plan must be an EbisuPlan, None or 'auto'; got "
                         f"{plan!r}")
    shape = tuple(int(n) for n in shape)
    if len(shape) != spec.ndim:
        raise ValueError(f"{spec.name} is {spec.ndim}-D; got shape {shape}")
    from repro_torch.api import sharded as _sharded
    from repro_torch.launch.mesh import Mesh
    if device is None and isinstance(mesh, Mesh):
        device = mesh.devices.flat[0]
    device = resolve_device(device)
    mesh = _sharded.resolve_mesh(mesh, spec.ndim, device)
    hw = hw or rl.hardware_for(device)
    boundary = ZERO if boundary is None else boundary
    cdtype = resolve_compute_dtype(dtype, compute_dtype)
    itemsize = torch.empty((), dtype=cdtype).element_size()
    tuned_info = None
    if mode == "tuned":
        from repro_torch.tuning import plandb as _plandb
        rec = _plandb.resolve_db(plan_db).lookup(
            spec, shape, _plandb.tier_for(device), device)
        if rec is not None:
            plan = _plandb.plan_from_record(spec, shape, hw, rec, itemsize)
            t = plan.t
            mode = rec["plan"]["exec_mode"]
            tuned_info = {"source": "plandb", "record": rec}
        else:
            mode = "fused"
            tuned_info = {"source": "analytic_fallback"}
    kernel_spec = lift_2d_to_3d(spec) if mode == "stream" else spec
    plan_shape = shape
    if mesh is not None:
        # shard uniformity first (the depth-1 halo fit is a subset of the
        # full-depth check below), then the per-shard planning pass: each
        # device is one big tile — plan for the shard it owns
        _sharded.validate_mesh_for(spec, shape, mesh, 1, boundary)
        plan_shape = _sharded.shard_extents(shape, mesh)
    pinned = isinstance(plan, EbisuPlan)
    if isinstance(plan, str):
        plan = plan_bucketed(kernel_spec, kernel_view(spec, kernel_spec,
                                                      plan_shape)[0], hw,
                             itemsize)
    depth = t if t is not None else (plan.t if plan is not None else 1)
    if depth < 1:
        raise ValueError(f"temporal depth must be >= 1, got {depth}")
    boundary.validate_for(spec, t=depth)
    if mesh is not None:
        _sharded.validate_mesh_for(spec, shape, mesh, depth, boundary)
    key = (spec, shape, dtype, depth, hw.name, boundary, mode,
           _plan_key(plan), pinned, cdtype, str(device),
           _sharded.mesh_key(mesh),
           None if tuned_info is None else ("tuned", tuned_info["source"]))
    cached = PROGRAM_CACHE.get(key)
    if cached is not None:
        return cached
    prog = StencilProgram(key, spec, shape, dtype, depth, plan, hw,
                          boundary, mode, device, cdtype, kernel_spec, mesh,
                          pinned=pinned, tuned=tuned_info)
    prog.geometry()     # refuse a depth or a pinned tile that cannot fit
    PROGRAM_CACHE.put(key, prog)
    return prog


# ================================================ legacy entry points ==
def deprecated_entry(name: str, replacement: str) -> None:
    """One-per-call-site deprecation notice for the legacy entry points
    (``kernels/ops.py``, ``kernels/sweep.py``), emitted strictly at call
    time, never at import, so modules that merely import the legacy
    names stay silent."""
    warnings.warn(f"{name} is deprecated; use {replacement} "
                  "(repro_torch.api) instead", DeprecationWarning,
                  stacklevel=3)


def sweep_once(x: torch.Tensor, spec: StencilSpec, t: int, *,
               plan: EbisuPlan | None = None, mode: str = "fused",
               interpret: bool = True, boundary: Boundary | None = None,
               compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """One temporally-blocked sweep of depth ``t`` on ``x``'s device: the
    plan's tile (at its depth), or the request-default tile without one.
    ``interpret`` is kept for the reference's signature: the port has no
    interpret mode, and the tensor's device decides (a CPU tensor takes
    the kernel's plain version, a CUDA tensor launches the kernel)."""
    del interpret
    prog = compile_stencil(spec, tuple(x.shape), dtype=x.dtype, t=t,
                           plan=plan, mode=mode, boundary=boundary,
                           compute_dtype=compute_dtype, device=x.device)
    return prog.apply(x)


def run_sweeps_padded(xp: torch.Tensor, spec: StencilSpec, total_t: int, *,
                      t: int, height: int, width: int, bh: int,
                      bw: int | None = None, mode: str = "fused",
                      num_buffers: int | None = None,
                      interpret: bool = True) -> torch.Tensor:
    """The padded-layout sweep chain (2-D, zero Dirichlet), ``t |
    total_t``: ``xp`` is the padded layout of a ``(bh, bw)`` tile,
    ``padded_shape_2d(spec, t, bh, bw, height, width)``, in the compute
    dtype, the domain at its origin.  ``bw`` defaults to the widest
    column tile the kernel takes at ``bh`` rows (the reference's strips
    are whole rows).  The sweeps ping-pong ``xp`` with one partner
    buffer and return the one holding the result; do not rely on ``xp``
    after the call.  ``mode`` (``fused`` or ``scratch``, one kernel),
    ``num_buffers`` and ``interpret`` are kept for the reference's
    signature."""
    del num_buffers, interpret
    if total_t % t:
        raise ValueError(f"padded chaining needs a uniform sweep depth: "
                         f"t={t} must divide total_t={total_t}")
    if mode not in ("fused", "scratch"):
        raise ValueError(f"run_sweeps_padded is the 2-D fused chain; got "
                         f"mode={mode!r}")
    if bw is None:
        bw = _widest_columns(spec, t, bh, width, int(rl.hardware_for(
            xp.device).onchip_bytes), xp.element_size())
        if bw < COL_ALIGN:
            raise ValueError(f"{spec.name}: no column tile fits {bh} rows "
                             f"at t={t}; pass a smaller bh")
    want = padded_shape_2d(spec, t, bh, bw, height, width)
    if tuple(xp.shape) != want:
        raise ValueError(f"run_sweeps_padded carry must have the padded "
                         f"layout {want} of tile ({bh}, {bw}); got "
                         f"{tuple(xp.shape)}")
    buf = torch.empty_like(xp) if total_t else xp
    for _ in range(total_t // t):
        ebisu2d_padded(xp, spec=spec, t=t, height=height, width=width,
                       bh=bh, bw=bw, out=buf)
        xp, buf = buf, xp
    return xp


def _sweep_tile_2d(spec: StencilSpec, t: int, shape: tuple[int, int],
                   hw: rl.HardwareModel, plan: EbisuPlan,
                   interpret: bool = False) -> int:
    """The rows of the CTA tile a depth-``t`` 2-D sweep launches (the
    plan's at its depth, else the §6.4 fit; :func:`sweep_tile`).  The
    reference widens a strip to fill VMEM; the port's tile is bound by
    shared memory, and ``interpret`` changes nothing."""
    del interpret
    return sweep_tile(spec, t, shape, hw, hw.s_cell, plan)[0]


def _sweep_tile_3d(spec: StencilSpec, t: int, shape: tuple[int, int, int],
                   hw: rl.HardwareModel, plan: EbisuPlan,
                   interpret: bool = False
                   ) -> tuple[int, int | None, int | None, int]:
    """``(zc, ty, tx, B)`` of a depth-``t`` 3-D sweep: the port's CUDA
    tile (the plan's at its depth, else the planner's fit), ``ty``/``tx``
    ``None`` where an axis is untiled, and ``B``, the planes each time
    level streams between two barriers (the reference's streaming batch).
    A depth whose tile does not fit the ``smem_bytes_3d`` budget
    raises."""
    del interpret
    try:
        zc, ty, tx = sweep_tile_3d(spec, t, shape, hw, hw.s_cell,
                                   plan if plan is not None and plan.t == t
                                   else None)
    except ValueError as e:
        raise ValueError(f"{spec.name}: depth t={t} does not fit the "
                         f"{hw.name} on-chip budget ({e})") from None
    if smem_bytes_3d(spec, t, shape, ty, tx, hw.s_cell) > hw.onchip_bytes:
        raise ValueError(f"{spec.name}: depth t={t} at tile ({ty}, {tx}) "
                         f"does not fit the {hw.name} on-chip budget")
    return (zc, ty if ty < shape[1] else None,
            tx if tx < shape[2] else None, planes_per_barrier(spec.radius))

"""``StencilProgram`` on the card: the compile-once front door for temporal
blocking (counterpart of ``repro.api.program``, its 2-D half).

``compile_stencil`` resolves the §6 plan, the CTA tile of every sweep
depth and the boundary execution strategy once, and returns an immutable
:class:`StencilProgram`:

    from repro_torch.api import compile_stencil
    from repro_torch.core.stencil_spec import get
    prog = compile_stencil(get("j2d5pt"), (8352, 8352), t=12)  # on cuda
    y = prog.apply(x)        # one sweep of 12 fused steps
    y = prog.run(x, 25)      # sweeps of depth 12, 12, then 1

Where the reference wraps the sweep chain in ``jax.jit`` and donates the
carry, the port runs an eager Python loop of kernel launches over two
ping-pong buffers: pad once, launch, swap, crop once (zero Dirichlet and
the constant Dirichlet shift), or re-pin the ghost halo every sweep
(periodic, reflect, neumann, and Dirichlet with an unnormalized tap set).

Programs run on the card unless the caller asks for the CPU
(``device="cpu"``), where every sweep takes the kernel's plain version.
Not in this slice, and refused with the ROADMAP item that brings them:
3-D specs, ``mode="stream"``/``"tuned"``, ``mesh=``, ``run_sharded``,
``run_resumable``, ``run_batched`` and ``run_padded``.
"""
from __future__ import annotations

import functools
import math
import threading
from collections import OrderedDict

import torch

from repro_torch.api.boundary import ZERO, Boundary
from repro_torch.core import roofline as rl
from repro_torch.core.planner import (EbisuPlan, THREADS, fit_tile_2d,
                                      plan as make_plan, smem_bytes_2d)
from repro_torch.core.stencil_spec import StencilSpec, validate_spec
from repro_torch.kernels.stencil2d import (ebisu2d_padded, padded_shape_2d,
                                           strip_geometry)
from repro_torch.kernels.taps import ghost_extend, tap_sum

_BUCKET = 64

_SLICE_2 = "ROADMAP Queue 1 item 6 (slice 2: the 3-D stream kernel)"
_LATER = {
    "tuned": "ROADMAP Queue 1 item 12 (tuning)",
    "stream": _SLICE_2,
    "mesh": "ROADMAP Queue 1 item 8 (sharded deep-halo execution)",
    "run_sharded": "ROADMAP Queue 1 item 8 (sharded deep-halo execution)",
    "run_resumable": "ROADMAP Queue 1 item 10 (resilient campaigns)",
    "run_batched": "ROADMAP Queue 1 item 6b (slice-1 leftovers)",
    "run_padded": "ROADMAP Queue 1 item 6b (slice-1 leftovers)",
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: {_LATER[what]}")


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
    cell size) — keyed on ``spec.signature``, never the name.

        p = plan_bucketed(get("j2d5pt"), (512, 512))
        p.t, p.block          # §6.2 depth, CTA tile
    """
    itemsize = itemsize or hw.s_cell
    bucket = tuple(_round_up(d, _BUCKET) for d in shape)
    key = (spec.signature, bucket, hw.name, itemsize)
    return PLAN_CACHE.get_or_build(
        key, lambda: make_plan(spec, hw, domain=bucket, itemsize=itemsize))


# ======================================================= geometry / sweep ==
def sweep_tile(spec: StencilSpec, t: int, shape: tuple[int, int],
               hw: rl.HardwareModel, itemsize: int,
               plan: EbisuPlan | None = None) -> tuple[int, int]:
    """The CTA tile of a depth-``t`` sweep over ``shape``: the plan's own
    tile at the plan's depth, else the §6.4 fit for this depth."""
    if plan is not None and plan.t == t:
        return plan.block
    fit = fit_tile_2d(spec, t, shape, hw, itemsize)
    if fit is None:
        raise ValueError(
            f"{spec.name}: depth t={t} (halo {spec.halo(t)}) leaves no CTA "
            f"tile within the {int(hw.onchip_bytes)} B shared-memory limit "
            f"of {hw.name} at {itemsize}-byte cells; lower t")
    return fit[0], fit[1]


def resolve_geometry(spec: StencilSpec, t: int, shape: tuple[int, int], *,
                     hw: rl.HardwareModel = rl.H100, itemsize: int = 4,
                     plan: EbisuPlan | None = None) -> dict:
    """The launch a depth-``t`` sweep over ``shape`` executes: CTA tile,
    grid, halo, padded layout, threads, shared memory, and the cells each
    CTA loads (``fetched_cells``) and writes (``body_cells``).

        g = resolve_geometry(get("j2d5pt"), 4, (512, 512))
        g["grid"], g["block"], g["halo"]    # what apply() will launch
    """
    bh, bw = sweep_tile(spec, t, shape, hw, itemsize, plan)
    bh, bw, halo = strip_geometry(spec, t, bh, bw)
    hp, wp = padded_shape_2d(spec, t, bh, bw, *shape)
    return dict(grid=(hp // bh, wp // bw), block=(bh, bw), halo=halo,
                padded=(hp, wp), threads=THREADS,
                smem_bytes=smem_bytes_2d(spec, t, bh, bw, itemsize),
                fetched_cells=(bh + 2 * halo) * (bw + 2 * halo),
                body_cells=bh * bw)


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


def _build_chain(spec: StencilSpec, shape: tuple[int, int],
                 dtype: torch.dtype, total_t: int, depth: int,
                 plan: EbisuPlan, hw: rl.HardwareModel, boundary: Boundary,
                 compute_dtype: torch.dtype):
    """The multi-sweep schedule as ``f(x) -> x``.

    Zero Dirichlet, and Dirichlet(v) with taps summing to 1 (the exact
    constant shift): pad once per depth group, launch the sweeps over two
    ping-pong buffers, crop once.  Dirichlet(v) with tap sum ``s ≠ 1``
    (depth-1 sweeps only): ``u' = Z_1(u − v) + v·s`` around every sweep.
    Periodic / reflect / neumann: the padded layout is not closed under
    the boundary, so every sweep re-pins the ghost halo from the evolved
    field and runs on the extended domain.  Buffers are
    ``compute_dtype``; only the result is cast to ``dtype``.  One sweep
    (``total_t == depth``) is what :meth:`StencilProgram.apply` runs.
    """
    boundary.validate_for(spec, t=depth)
    height, width = shape
    groups = _grouped(sweep_schedule(total_t, depth))
    repin = boundary.kind in ("periodic", "reflect", "neumann")
    s = tap_sum(spec.taps)
    affine = (boundary.kind == "dirichlet" and boundary.value != 0.0
              and abs(s - 1.0) > 1e-6)
    shift = boundary.value if boundary.kind == "dirichlet" else 0.0
    itemsize = torch.empty((), dtype=compute_dtype).element_size()

    def halo_of(d: int) -> int:
        return spec.halo(d) if repin else 0

    def ext(d: int) -> tuple[int, int]:
        return height + 2 * halo_of(d), width + 2 * halo_of(d)

    tiles = {d: sweep_tile(spec, d, ext(d), hw, itemsize, plan)
             for d, _ in groups}

    def chain(v: torch.Tensor) -> torch.Tensor:
        for d, count in groups:
            bh, bw = tiles[d]
            he, we = ext(d)
            halo = halo_of(d)
            hp, wp = padded_shape_2d(spec, d, bh, bw, he, we)
            sweep = functools.partial(ebisu2d_padded, spec=spec, t=d,
                                      height=he, width=we, bh=bh, bw=bw)
            xp = torch.zeros((hp, wp), dtype=compute_dtype, device=v.device)
            buf = torch.empty_like(xp)
            if repin or affine:
                for _ in range(count):
                    w = v - shift if affine else v
                    xp[:he, :we] = (ghost_extend(w, 2, halo, boundary)
                                    if repin else w)
                    sweep(xp, out=buf)
                    # a view of buf: read (ghost_extend / the shift
                    # makes a new tensor) before the next sweep writes buf
                    v = buf[halo:halo + height, halo:halo + width]
                    if affine:
                        v = v + shift * s ** d
            else:
                xp[:height, :width] = v
                for _ in range(count):
                    sweep(xp, out=buf)
                    xp, buf = buf, xp
                v = xp[:height, :width]
        return v

    if boundary.kind == "dirichlet" and boundary.value != 0.0 and not affine:
        def run(x):
            return (chain(x.to(compute_dtype) - shift) + shift).to(dtype)
    else:
        def run(x):
            return chain(x.to(compute_dtype)).to(dtype).contiguous()
    return run


# ============================================================== programs ==
def _plan_key(plan: EbisuPlan):
    return (plan.hw_name, plan.t, plan.block, plan.threads)


class StencilProgram:
    """An immutable compiled 2-D stencil: spec + domain shape + §6 plan +
    boundary + device, with memoized sweep chains.  Construct via
    :func:`compile_stencil`:

        prog = compile_stencil(get("j2d5pt"), (512, 512), t=4)
        y = prog.apply(x)            # one temporally-blocked sweep
        y = prog.run(x, 64)          # 64 steps as 16 chained sweeps
    """

    def __init__(self, key, spec: StencilSpec, shape: tuple[int, int],
                 dtype: torch.dtype, t: int, plan: EbisuPlan,
                 hw: rl.HardwareModel, boundary: Boundary, mode: str,
                 device: torch.device, compute_dtype: torch.dtype):
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

    # ------------------------------------------------------- execution ----
    def _check(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x, device=self.device)
        if tuple(x.shape) != self.shape:
            raise ValueError(
                f"program compiled for shape {self.shape} (got "
                f"{tuple(x.shape)}); compile_stencil a new program for a "
                "new domain shape")
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
                                 depth, self.plan, self.hw, self.boundary,
                                 self.compute_dtype))
        return fn(x)

    def run(self, x, total_t: int) -> torch.Tensor:
        """``total_t`` steps as chained sweeps (a shallower remainder
        sweep when the depth does not divide ``total_t``).

            y = prog.run(x, 10)     # t=4: sweeps of depth 4, 4, then 2
        """
        x = self._check(x)
        if total_t == 0:
            return x
        depth = max(1, min(self.t, total_t))
        fn = RUNNER_CACHE.get_or_build(
            (self._key, "run", total_t),
            lambda: _build_chain(self.spec, self.shape, self.dtype, total_t,
                                 depth, self.plan, self.hw, self.boundary,
                                 self.compute_dtype))
        return fn(x)

    def run_batched(self, xs, total_t: int | None = None):
        raise _not_ported("run_batched")

    def run_padded(self, xp, total_t: int):
        raise _not_ported("run_padded")

    def run_sharded(self, x, total_t: int):
        raise _not_ported("run_sharded")

    def run_resumable(self, x, total_t: int, **kwargs):
        raise _not_ported("run_resumable")

    # ---------------------------------------------------- introspection ----
    def fingerprint(self) -> dict:
        """A JSON-safe identity card of the program."""
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
        }

    def compute_shape(self, t: int | None = None) -> tuple[int, int]:
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
        return resolve_geometry(self.spec, depth, self.compute_shape(depth),
                                hw=self.hw, itemsize=itemsize,
                                plan=self.plan)

    def cost(self, t: int | None = None) -> rl.RooflineResult:
        """§5 practical-attainable estimate at depth ``t``: the plan's own
        prediction at its depth, the ideal-V roofline elsewhere."""
        depth = self.t if t is None else t
        if depth == self.plan.t:
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


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card, and
    raises when there is none (pass ``device="cpu"`` to run the plain
    version on the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device=\"cpu\" to run the plain PyTorch version")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def compile_stencil(spec: StencilSpec, shape: tuple[int, ...], *,
                    dtype: torch.dtype = torch.float32,
                    t: int | None = None,
                    hw: rl.HardwareModel | None = None,
                    boundary: Boundary | None = None, mode: str = "fused",
                    compute_dtype: torch.dtype | None = None, mesh=None,
                    device=None) -> StencilProgram:
    """Compile a 2-D stencil to an immutable :class:`StencilProgram`.

        from repro_torch.api import Boundary, compile_stencil
        prog = compile_stencil(spec, (4096, 4096), t=8,
                               boundary=Boundary.periodic())
        y = prog.run(x, 64)

    ``device`` defaults to the current CUDA device and raises if there is
    none; ``device="cpu"`` runs the plain version.  ``hw`` defaults to the
    H100 model of that device (``roofline.hardware_for``).  ``t`` is the
    per-sweep depth (default: the plan's §6.2 choice, see
    :func:`plan_bucketed`).  ``dtype`` is cell storage and ``compute_dtype`` what the kernel runs
    in (see :func:`resolve_compute_dtype`).  Programs are memoized:
    recompiling with identical arguments returns the same handle.
    """
    validate_spec(spec)
    if spec.ndim != 2:
        raise NotImplementedError(
            f"{spec.name} is {spec.ndim}-D; repro_torch runs 2-D stencils "
            f"only so far: the 3-D half is {_SLICE_2}")
    if mode in ("stream", "tuned"):
        raise _not_ported(mode)
    if mode != "fused":
        raise ValueError(f"unknown mode {mode!r}; expected 'fused' (the "
                         "CUDA kernel always ping-pongs in shared memory)")
    if mesh is not None:
        raise _not_ported("mesh")
    shape = tuple(int(n) for n in shape)
    if len(shape) != 2:
        raise ValueError(f"{spec.name} is 2-D; got shape {shape}")
    device = resolve_device(device)
    hw = hw or rl.hardware_for(device)
    boundary = ZERO if boundary is None else boundary
    cdtype = resolve_compute_dtype(dtype, compute_dtype)
    itemsize = torch.empty((), dtype=cdtype).element_size()
    plan = plan_bucketed(spec, shape, hw, itemsize)
    depth = t if t is not None else plan.t
    if depth < 1:
        raise ValueError(f"temporal depth must be >= 1, got {depth}")
    boundary.validate_for(spec, t=depth)
    key = (spec, shape, dtype, depth, hw.name, boundary, mode,
           _plan_key(plan), cdtype, str(device))
    cached = PROGRAM_CACHE.get(key)
    if cached is not None:
        return cached
    prog = StencilProgram(key, spec, shape, dtype, depth, plan, hw,
                          boundary, mode, device, cdtype)
    prog.geometry()     # refuse a depth whose tile cannot fit, here
    PROGRAM_CACHE.put(key, prog)
    return prog

"""``SystemProgram`` on torch: one fused trapezoid chain across the coupling
(counterpart of ``repro.systems.program``).

The single-field executor's pitch — plan once, then drive deep temporal
blocking — generalizes to coupled systems by making the *system step* the
unit the trapezoid narrows: each temporal step applies every coupling
(valid-mode, cropping by the **system** radius) and then the pointwise
reaction, so all fields advance inside one fused chain and temporal
blocking spans the coupling instead of syncing per field per step:

    from repro_torch.systems import compile_system, gray_scott
    prog = compile_system(gray_scott(), (256, 256), t=4,
                          boundary=Boundary.periodic())
    out = prog.run({"u": u0, "v": v0}, 64)       # 16 fused sweeps

The steps are the port's tap engine (``kernels/taps.py``: ``engine_for``
and ``ghost_extend``) in plain torch, as the reference's are plain jnp
through its own tap engine: the reference runs no Pallas kernel here, so
the port launches none.  A program computes on the device its fields are
on: the card unless the caller passes CPU tensors (fields that are not
tensors go to the card).

Boundary execution: **periodic** hoists the ghost fill — every field is
wrap-extended once by ``t·radius`` per sweep and the chain narrows all
fields by one radius per step (true deep blocking: halo traffic
amortized over ``t`` steps).  Every other kind (dirichlet of any value,
neumann of any flux, reflect) re-pins a one-radius ghost ring **every
step** — exact for arbitrary taps, values and fluxes, which is why
``compile_system`` needs none of the single-field path's closure
refusals.

``run_lockstep`` is the deliberately unfused reference: one separate
update per field per step (``T·n_fields`` of them) — the baseline the
fused chain is measured against, and the equivalence target of the
tests.  ``run_batched`` carries a leading batch axis on every field
through the chain of ``run`` (the reference ``jax.vmap``s it).

All state lives in bounded :class:`~repro_torch.api.program.ProgramCache`
instances; importing this module initializes no CUDA context.
"""
from __future__ import annotations

import math

import torch

from repro_torch.api.boundary import ZERO, Boundary
from repro_torch.api.program import (ProgramCache, _grouped,
                                     resolve_compute_dtype, sweep_schedule)
from repro_torch.core.device import resolve_device
from repro_torch.kernels.taps import engine_for, ghost_extend
from repro_torch.systems.reactions import resolve_reaction
from repro_torch.systems.spec import SystemSpec

SYSTEM_PROGRAM_CACHE = ProgramCache(32, "system_programs")
SYSTEM_RUNNER_CACHE = ProgramCache(64, "system_runners")


def system_cache_stats() -> dict:
    """Hit/miss/size counters of the systems caches.

        from repro_torch.systems import system_cache_stats
        system_cache_stats()["system_programs"]["hits"]
    """
    return {c.name: c.stats()
            for c in (SYSTEM_PROGRAM_CACHE, SYSTEM_RUNNER_CACHE)}


def clear_system_caches() -> None:
    for c in (SYSTEM_PROGRAM_CACHE, SYSTEM_RUNNER_CACHE):
        c.clear()


def _name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


# ========================================================== the system step ==
def system_step(spec: SystemSpec, ext: dict, reaction_fn) -> dict:
    """One temporal step on ghost-extended fields, valid-mode.

    ``ext[f]`` carries at least one system-radius ring of context beyond
    the cells being produced; every coupling is applied with
    ``crops = radius`` (smaller-radius pairs still crop by the *system*
    radius — the tap engine's valid mode allows crop > tap reach), the
    per-destination terms are summed, and the reaction reads the
    pre-step values center-cropped to the output extent.  Every field
    shrinks by one system radius per side.
    """
    ndim, rad = spec.ndim, spec.radius
    crops = (rad,) * ndim
    lin: dict = {}
    for (dst, src), taps in spec.couplings:
        term = engine_for(taps, ndim).step(ext[src], crops=crops)
        lin[dst] = term if dst not in lin else lin[dst] + term
    if reaction_fn is None:
        return lin
    c = (Ellipsis,) + (slice(rad, -rad),) * ndim
    new = reaction_fn(lin, {f: ext[f][c] for f in spec.fields})
    missing = [f for f in spec.fields if f not in new]
    if missing:
        raise ValueError(
            f"reaction {spec.reaction!r} returned no value for field(s) "
            f"{missing}; a reaction must map (lin, prev) to every field")
    return {f: new[f] for f in spec.fields}


def _build_system_chain(spec: SystemSpec, shape, dtype, cdtype,
                        total_t: int, depth: int, boundary: Boundary):
    """The multi-sweep system schedule as ``f(fields) -> fields``; fields
    with a leading batch axis keep it through every step."""
    groups = _grouped(sweep_schedule(total_t, depth))
    ndim, rad = spec.ndim, spec.radius
    reaction_fn = resolve_reaction(spec.reaction)
    hoist = boundary.kind == "periodic"

    def sweep(cur: dict, d: int) -> dict:
        if hoist:
            # wrap-extend once per sweep by d·rad, narrow d times: the
            # ghost ring evolves exactly like the wrapped interior, so
            # the fill is hoisted out of the step loop (deep blocking)
            ext = {f: ghost_extend(cur[f], ndim, d * rad, boundary)
                   for f in spec.fields}
            for _ in range(d):
                ext = system_step(spec, ext, reaction_fn)
            return ext
        # dirichlet/neumann/reflect: the true boundary values depend on
        # the *evolved* field, so re-pin one ghost ring every step
        for _ in range(d):
            ext = {f: ghost_extend(cur[f], ndim, rad, boundary)
                   for f in spec.fields}
            cur = system_step(spec, ext, reaction_fn)
        return cur

    def run(fields: dict) -> dict:
        cur = {f: fields[f].to(cdtype) for f in spec.fields}
        for d, count in groups:
            for _ in range(count):
                cur = sweep(cur, d)
        return {f: cur[f].to(dtype) for f in spec.fields}

    return run


# ============================================================== programs ==
class SystemProgram:
    """An immutable compiled system: spec + domain shape + depth +
    boundary, with memoized sweep chains.  Construct via
    :func:`compile_system`:

        prog = compile_system(gray_scott(), (256, 256), t=4)
        out  = prog.apply(fields)          # one fused t-deep sweep
        out  = prog.run(fields, 64)        # 64 steps, chained sweeps
        outs = prog.run_batched(stacked, 64)
        ref  = prog.run_lockstep(fields, 64)   # unfused reference
    """

    def __init__(self, key, spec: SystemSpec, shape, dtype, t: int,
                 boundary: Boundary, compute_dtype):
        self._key = key
        self.spec = spec
        self.shape = shape
        self.dtype = dtype
        self.t = t
        self.boundary = boundary
        self.compute_dtype = compute_dtype

    # ------------------------------------------------------- execution ----
    def _check(self, fields: dict, batched: bool = False) -> dict:
        """The fields as tensors on one device (the card for any that
        are not tensors), after the reference's checks."""
        if set(fields) != set(self.spec.fields):
            raise ValueError(
                f"system {self.spec.name} has fields "
                f"{list(self.spec.fields)}; got {sorted(fields)}")
        out = {f: (fields[f] if isinstance(fields[f], torch.Tensor)
                   else torch.as_tensor(fields[f], device=resolve_device()))
               for f in self.spec.fields}
        want = self.shape
        for f in self.spec.fields:
            got = tuple(out[f].shape)
            body = got[1:] if batched else got
            if body != want:
                raise ValueError(
                    f"field {f!r} has shape {got}, but the program is "
                    f"compiled for {'batched ' if batched else ''}domain "
                    f"{want}; every field shares one domain — "
                    "compile_system a new program for a new shape")
        devices = {out[f].device for f in self.spec.fields}
        if len(devices) > 1:
            raise ValueError(f"the fields of system {self.spec.name} lie "
                             f"on several devices {sorted(map(str, devices))}"
                             "; put them on one")
        return out

    def _run_fn(self, total_t: int, depth: int | None = None):
        depth = depth or max(1, min(self.t, total_t))
        return SYSTEM_RUNNER_CACHE.get_or_build(
            (self._key, "run", total_t, depth),
            lambda: _build_system_chain(
                self.spec, self.shape, self.dtype, self.compute_dtype,
                total_t, depth, self.boundary))

    def apply(self, fields: dict, t: int | None = None) -> dict:
        """One fused sweep of depth ``t`` (default: the compiled depth)."""
        fields = self._check(fields)
        depth = self.t if t is None else t
        if depth < 1:
            raise ValueError(f"temporal depth must be >= 1, got {depth} "
                             "(run(fields, 0) is the identity)")
        return self._run_fn(depth, depth)(fields)

    def run(self, fields: dict, total_t: int) -> dict:
        """``total_t`` steps as chained fused sweeps (remainder sweep
        included when ``t`` does not divide it)."""
        fields = self._check(fields)
        if total_t == 0:
            return dict(fields)
        return self._run_fn(total_t)(fields)

    def run_batched(self, fields: dict, total_t: int | None = None) -> dict:
        """A leading batch axis on every field through the chain of
        :meth:`run`: each step covers the whole batch at once."""
        fields = self._check(fields, batched=True)
        total_t = self.t if total_t is None else total_t
        if total_t == 0:
            return dict(fields)
        return self._run_fn(total_t)(fields)

    def run_lockstep(self, fields: dict, total_t: int) -> dict:
        """The unfused per-field-per-step reference: every step, each
        field's update is one separate call (``T·n_fields`` calls, ghost
        ring re-pinned per step for every boundary) — the classic
        sync-per-field-per-step scheme the fused chain is measured
        against, and numerically the same trajectory."""
        fields = self._check(fields)
        cur = {f: fields[f].to(self.compute_dtype) for f in self.spec.fields}
        for _ in range(total_t):
            cur = {f: self._lockstep_fn(f)(cur) for f in self.spec.fields}
        return {f: cur[f].to(self.dtype) for f in self.spec.fields}

    def _lockstep_fn(self, dst: str):
        spec, boundary = self.spec, self.boundary
        reaction_fn = resolve_reaction(spec.reaction)

        def one(cur: dict):
            ext = {f: ghost_extend(cur[f], spec.ndim, spec.radius, boundary)
                   for f in spec.fields}
            return system_step(spec, ext, reaction_fn)[dst]

        return SYSTEM_RUNNER_CACHE.get_or_build(
            (self._key, "lockstep", dst), lambda: one)

    # ---------------------------------------------------- introspection ----
    def cost(self) -> dict:
        """The generalized §5 counting model for one step of the whole
        system over this domain: per-field and total flops, and the
        perfect-caching device-memory bytes (``a_gm = 2·n_fields`` cells
        of the compute dtype per cell position)."""
        cells = math.prod(self.shape)
        itemsize = torch.empty((), dtype=self.compute_dtype).element_size()
        return {
            "per_field_flops_per_cell": self.spec.per_field_flops(),
            "flops_per_cell": self.spec.flops_per_cell,
            "flops_per_step": self.spec.flops_per_cell * cells,
            "hbm_bytes_per_step": self.spec.a_gm * cells * itemsize,
            "halo": self.spec.halo(self.t),
        }

    def cache_stats(self) -> dict:
        return system_cache_stats()

    def __repr__(self) -> str:
        return (f"SystemProgram({self.spec.name}, "
                f"fields={list(self.spec.fields)}, shape={self.shape}, "
                f"t={self.t}, boundary={self.boundary!r}, "
                f"dtype={_name(self.dtype)}/{_name(self.compute_dtype)})")


def compile_system(spec: SystemSpec, shape, *, t: int = 1,
                   dtype: torch.dtype = torch.float32,
                   boundary: Boundary | None = None,
                   compute_dtype: torch.dtype | None = None
                   ) -> SystemProgram:
    """Compile a :class:`~repro_torch.systems.spec.SystemSpec` to an
    immutable :class:`SystemProgram` (memoized on the system *signature*
    — two structurally identical systems share one program regardless of
    name).

        from repro_torch.systems import compile_system, get_system
        prog = compile_system(get_system("gray-scott"), (256, 256), t=4,
                              boundary=Boundary.neumann())
        out = prog.run({"u": u0, "v": v0}, 64)

    ``t`` is the fused sweep depth (there is no §6 planner for systems,
    as in the reference: the default is 1).  All four boundary kinds run
    exactly at any depth: periodic through the hoisted deep-halo
    trapezoid, the rest through per-step ghost re-pinning inside the
    fused chain — no closure refusals apply.
    """
    shape = tuple(int(n) for n in shape)
    if len(shape) != spec.ndim:
        raise ValueError(
            f"system {spec.name} is {spec.ndim}-D; got shape {shape}")
    if any(n < 2 * spec.radius + 2 for n in shape):
        raise ValueError(
            f"{spec.name}: domain {shape} has an extent smaller than "
            f"2·radius+2 = {2 * spec.radius + 2}; the halo would cover it")
    if t < 1:
        raise ValueError(f"temporal depth must be >= 1, got {t}")
    boundary = ZERO if boundary is None else boundary
    cdtype = resolve_compute_dtype(dtype, compute_dtype)
    resolve_reaction(spec.reaction)     # fail at compile, not at run
    key = (spec.signature, shape, _name(dtype), int(t), boundary,
           _name(cdtype))
    cached = SYSTEM_PROGRAM_CACHE.get(key)
    if cached is not None:
        return cached
    prog = SystemProgram(key, spec, shape, dtype, int(t), boundary, cdtype)
    SYSTEM_PROGRAM_CACHE.put(key, prog)
    return prog

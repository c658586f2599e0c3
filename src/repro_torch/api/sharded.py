"""Sharded deep-halo execution: ``StencilProgram.run_sharded`` over a mesh
(counterpart of ``repro.api.sharded``).

EBISU's thesis — low occupancy, large tiles, executed tile-by-tile —
scales out by treating **each device as one large tile**: the domain is
decomposed over a 1-D/2-D/3-D device mesh, and neighbour shards exchange
ghost zones **once per temporal block** of ``t`` fused steps, at halo
depth ``t·radius``, instead of once per time step at depth ``radius``.
Total halo *bytes* are unchanged (depth × 1/frequency), but the number of
exchange rounds drops by ``t``.

Execution of one temporal block of depth ``d``:

  1. **deep-halo gather** — for every sharded tensor dim, exchange
     ``h = d·radius``-deep slabs with both mesh neighbours
     (``core/distributed.ppermute``, one call per direction).  Axes are
     extended sequentially on the progressively extended shards, so
     box-stencil corners arrive via two hops.  At the domain edge:
     *periodic* closes the ring, *dirichlet* leaves the open chain's zero
     fill (exact for the shifted field), *reflect* self-mirrors the edge
     shard's own rim.
  2. **per-shard trapezoid** — ``d`` valid-mode steps of the tap engine
     (``kernels/taps.chain_trapezoid``) narrow the haloed block by one
     radius per step along every extended dim; after ``d`` steps the
     extent is exactly the shard again.
  3. **carry** — the result is the next block's input.

The mesh is single-process, as the reference's is: a
:class:`~repro_torch.launch.mesh.Mesh` of ``torch.device`` objects, one
of which may repeat (``devices=["cuda:0"] * 4`` runs a real (2, 2) mesh
on one card, its shards time-sharing the device).  Each shard is its own
tensor from the split on; slabs move between shards by device-to-device
copies.  The per-shard compute is plain torch through the port's tap
engine, as the reference's is plain ``jnp`` through its own (driving the
stencil kernels inside the shards is a stretch item of the reference,
DESIGN.md §17, and so of the port).  ``count_ppermutes`` counts the
exchange calls a run makes, where the reference counted the ``ppermute``
equations of a trace.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distributed import (ShardLayout, _exchange_one_axis,
                                          _shard_map, ppermute)
from repro_torch.core.stencil_spec import StencilSpec
from repro_torch.kernels.taps import _ghost_index, engine_for, tap_sum
from repro_torch.launch.mesh import Mesh

__all__ = [
    "count_ppermutes",
    "mesh_key",
    "planned_exchange_rounds",
    "resolve_mesh",
    "shard_extents",
    "sharded_partition_spec",
    "validate_mesh_for",
]


# ============================================================ mesh plumbing ==
def resolve_mesh(mesh, ndim: int, device=None) -> Mesh | None:
    """Normalize the ``compile_stencil(..., mesh=)`` argument to a Mesh.

    Accepted forms (mesh axis ``k`` shards tensor dim ``k``):

      * ``None``            — single-device program (no sharding),
      * a :class:`Mesh`     — used as-is (at most ``ndim`` axes),
      * ``int n``           — 1-D mesh ``(n,)`` sharding dim 0,
      * ``tuple`` of ints   — e.g. ``(2, 4)`` shards dims 0 and 1.

    Int/tuple forms build the mesh with ``make_stencil_mesh``: over ``n``
    CPU shards for a ``device="cpu"`` program, else over the visible CUDA
    devices (too few refuses; pass a :class:`Mesh` built with
    ``devices=`` to repeat a card).
    """
    if mesh is None:
        return None
    if isinstance(mesh, int):
        mesh = (mesh,)
    if isinstance(mesh, (tuple, list)):
        from repro_torch.launch.mesh import (ensure_fake_devices,
                                             make_stencil_mesh)
        shape = tuple(mesh)
        devices = None
        if device is not None and torch.device(device).type == "cpu":
            devices = ensure_fake_devices(int(np.prod(shape)), "cpu")
        mesh = make_stencil_mesh(shape, devices=devices)
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a repro_torch.launch.mesh.Mesh, an int, a tuple "
            f"of ints, or None; got {type(mesh).__name__}")
    if not (1 <= len(mesh.axis_names) <= ndim):
        raise ValueError(
            f"mesh has {len(mesh.axis_names)} axes but the stencil domain "
            f"is {ndim}-D; use a 1-D or up-to-{ndim}-D mesh (axis k shards "
            f"tensor dim k)")
    return mesh


def mesh_key(mesh: Mesh | None):
    """Hashable identity of a mesh for program/runner cache keys."""
    if mesh is None:
        return None
    return (tuple(mesh.axis_names), tuple(mesh.devices.shape),
            tuple(str(d) for d in mesh.devices.flat))


def _mesh_dims(mesh: Mesh) -> tuple[int, ...]:
    """Shard count per mesh-covered tensor dim (dim k <- mesh axis k)."""
    return tuple(mesh.shape[ax] for ax in mesh.axis_names)


def shard_extents(shape: tuple[int, ...], mesh: Mesh) -> tuple[int, ...]:
    """Per-shard domain extents: ``shape[k] / mesh_axis_k`` on covered
    dims, the full extent on uncovered trailing dims.  Requires
    divisibility (checked by :func:`validate_mesh_for`)."""
    dims = _mesh_dims(mesh)
    return tuple(s // n for s, n in zip(shape, dims)) + shape[len(dims):]


def sharded_partition_spec(shape_len: int, mesh: Mesh) -> tuple:
    """The partition ``run_sharded`` splits its operand by, as the
    entries of a ``PartitionSpec``: mesh axis ``k`` over tensor dim
    ``k``, trailing dims whole (``None``)."""
    return tuple(mesh.axis_names) + (None,) * (shape_len
                                               - len(mesh.axis_names))


def validate_mesh_for(spec: StencilSpec, shape: tuple[int, ...],
                      mesh: Mesh, t: int, boundary) -> None:
    """Refuse mesh/domain/depth combinations the one-hop deep-halo
    exchange cannot execute, with the fix spelled out:

      * every sharded dim must be divisible by its mesh axis (shards are
        uniform);
      * the block halo ``t·radius`` must fit inside one neighbour shard
        (halo slabs travel exactly one hop per block);
      * reflect additionally mirrors ``t·radius`` interior cells about
        the edge *excluding* the edge cell, needing one extra row;
      * neumann is not wired into the shard-local edge fills yet —
        refused up front rather than failing mid-compile.
    """
    if getattr(boundary, "kind", None) == "neumann":
        raise ValueError(
            f"{spec.name}: run_sharded does not support neumann boundaries "
            "yet (the shard-local edge ghost fill only implements "
            "dirichlet/periodic/reflect); use one of those, or run the "
            "program single-device where neumann is fully supported")
    dims = _mesh_dims(mesh)
    h = spec.halo(t)
    for d, n in enumerate(dims):
        if n == 1:
            continue
        if shape[d] % n:
            raise ValueError(
                f"{spec.name}: domain dim {d} ({shape[d]}) is not divisible "
                f"by mesh axis {mesh.axis_names[d]!r} ({n} shards); pad the "
                f"domain to a multiple of {n} or pick a mesh shape that "
                f"divides {shape[d]} (shards must be uniform)")
        shard = shape[d] // n
        need = h + 1 if getattr(boundary, "kind", None) == "reflect" else h
        if need > shard:
            raise ValueError(
                f"{spec.name}: block halo t*radius = {t}*{spec.radius} = {h} "
                f"{'(+1 for the reflect mirror) ' if need > h else ''}"
                f"exceeds the shard extent {shard} on dim {d} "
                f"({shape[d]} cells / {n} shards) — the deep-halo gather is "
                f"one neighbor hop per block.  Reduce t, use fewer shards "
                f"on mesh axis {mesh.axis_names[d]!r}, or grow the domain")


def planned_exchange_rounds(total_t: int, t: int) -> int:
    """Halo-exchange rounds a ``T``-step sharded run performs: one per
    temporal block (``ceil(T/t)`` via the remainder-sweep schedule) —
    versus ``T`` rounds for the classic exchange-every-step scheme.

        planned_exchange_rounds(64, 4)   # -> 16, a 4x round reduction
    """
    from repro_torch.api.program import sweep_schedule
    return len(sweep_schedule(total_t, t))


# ====================================================== deep-halo execution ==
def _extend_local(x: torch.Tensor, dim: int, h: int,
                  boundary) -> torch.Tensor:
    """Ghost-extend one *unsharded* dim by ``h`` with the boundary rule —
    the global edge lives entirely on this shard, so no exchange needed."""
    idx = _ghost_index(x.shape[dim], h, boundary.kind, x.device)
    return x.index_select(dim, idx)


def _mirror_rim(ext: torch.Tensor, dim: int, h: int,
                lo: bool) -> torch.Tensor:
    """The reflect ghost slab an edge shard fills from its own rim:
    ``ghost(-k) = u(k)`` about the edge cell (edge cell excluded)."""
    n = ext.shape[dim]
    rim = ext.narrow(dim, 1, h) if lo else ext.narrow(dim, n - 1 - h, h)
    return rim.flip(dim)


def _exchange_sharded_axis(shards: np.ndarray, dim: int, h: int,
                           axis_name: str, mesh: Mesh,
                           boundary) -> np.ndarray:
    """One deep-halo exchange round on a sharded dim (both directions).

    periodic: closed ring — the torus seam is just another neighbour hop.
    dirichlet: open chain; edge shards keep the zero fill, which is
    exactly the ghost value of the *shifted* field.  reflect: open chain,
    then edge shards overwrite their sourceless halo with the mirror of
    their own rim (a local flip, no traffic).
    """
    periodic = boundary.kind == "periodic"
    out = _exchange_one_axis(shards, dim, h, axis_name, mesh,
                             periodic=periodic)
    n = mesh.shape[axis_name]
    if boundary.kind != "reflect" or n == 1:
        return out
    k = mesh.axis_names.index(axis_name)
    for c in np.ndindex(*out.shape):
        ext, o = shards[c], out[c]
        if c[k] == 0:
            o.narrow(dim, 0, h).copy_(_mirror_rim(ext, dim, h, lo=True))
        if c[k] == n - 1:
            o.narrow(dim, o.shape[dim] - h, h).copy_(
                _mirror_rim(ext, dim, h, lo=False))
    return out


def _dirichlet_post(sharded_dims, idx, ns, shard_shape, rad, h):
    """The trapezoid ``post`` hook of the shard at mesh index ``idx``
    (per dim) re-pinning the *global* Dirichlet boundary: after step
    ``s``, the surviving ghost band (``h − s·rad`` deep, only on shards
    at the true domain edge) is re-zeroed so the next step reads
    boundary-true zeros, not evolved ghost garbage.  Interior seams need
    nothing — their halo is true neighbour data evolving exactly."""

    def post(v: torch.Tensor, s: int) -> torch.Tensor:
        cur = h - s * rad
        if cur <= 0:
            return v
        for dim in sharded_dims:
            if idx[dim] == 0:
                v.narrow(dim, 0, cur).zero_()
            if idx[dim] == ns[dim] - 1:
                v.narrow(dim, shard_shape[dim] + cur, cur).zero_()
        return v

    return post


def build_sharded_runner(prog, total_t: int):
    """The global ``f(x) -> y`` for ``prog.run_sharded(x, T)``.

    Splits ``x`` into the mesh's shards, runs the full multi-block
    schedule (``sweep_schedule`` — full-depth blocks plus one shallower
    remainder block) with one deep-halo gather per block and the
    per-shard trapezoid chain per block, and assembles the result on
    ``x``'s device.  Compute happens at the program's ``compute_dtype``;
    only the final result is cast back to storage.  Dirichlet(v≠0) runs
    through the same affine closure as the single-device chain: the carry
    is shifted by ``v`` into zero-Dirichlet space around every block and
    re-shifted by ``v·s^d`` after it — exact when ``s = 1`` (any depth)
    or ``d = 1`` (validated at compile).
    """
    from repro_torch.api.program import _grouped, sweep_schedule

    spec, mesh, boundary = prog.spec, prog.mesh, prog.boundary
    depth = max(1, min(prog.t, total_t))
    groups = _grouped(sweep_schedule(total_t, depth))
    rad = spec.radius
    ndim = spec.ndim
    axis_names = list(mesh.axis_names) + [None] * (ndim - len(mesh.axis_names))
    ns = list(_mesh_dims(mesh)) + [1] * (ndim - len(mesh.axis_names))
    sharded_dims = [d for d in range(ndim) if ns[d] > 1]
    shard_shape = shard_extents(prog.shape, mesh)
    cdtype = prog.compute_dtype
    s = tap_sum(spec.taps)
    engine = engine_for(spec.taps, ndim)
    layout = operand_sharding(prog)
    dirichlet = boundary.kind == "dirichlet"
    shift = boundary.value if dirichlet else 0.0

    def block(shards: np.ndarray, d: int) -> np.ndarray:
        """One temporal block: gather a d*rad halo once, run d narrowed
        steps; output extent == shard extent again."""
        h = rad * d
        ext = shards
        if dirichlet and shift != 0.0:
            ext = _shard_map(lambda c, v: v - shift, ext)
        for dim in sharded_dims:
            ext = _exchange_sharded_axis(ext, dim, h, axis_names[dim], mesh,
                                         boundary)

        def compute(c, e):
            idx = list(c) + [0] * (ndim - len(c))
            if dirichlet:
                # unsharded dims stay unextended: the tap engine's
                # zero-fill IS the (shifted) Dirichlet condition there
                out = engine.chain_trapezoid(
                    e, d, axes=sharded_dims,
                    post=_dirichlet_post(sharded_dims, idx, ns,
                                         shard_shape, rad, h))
            else:
                for dim in range(ndim):
                    if dim not in sharded_dims:
                        e = _extend_local(e, dim, h, boundary)
                out = engine.chain_trapezoid(e, d, axes=tuple(range(ndim)))
            if dirichlet and shift != 0.0:
                out = out + shift * s ** d
            return out

        return _shard_map(compute, ext)

    def run(x: torch.Tensor) -> torch.Tensor:
        v = _shard_map(lambda c, u: u.to(cdtype), layout.split(x))
        for d, count in groups:
            for _ in range(count):
                v = block(v, d)
        v = _shard_map(lambda c, u: u.to(prog.dtype), v)
        return layout.assemble(v, x.device)

    return run


def operand_sharding(prog) -> ShardLayout:
    """The split ``run_sharded`` places its operand with: mesh axis ``k``
    over tensor dim ``k``, one tensor per shard on its device."""
    return ShardLayout(prog.mesh,
                       {k: ax for k, ax in enumerate(prog.mesh.axis_names)},
                       prog.shape)


# ========================================================== introspection ==
def count_ppermutes(fn, *args) -> int:
    """Number of exchange calls (``core/distributed.ppermute``, one per
    direction) that ``fn(*args)`` makes — what the exchange-count tests
    assert against ``planned_exchange_rounds(T, t) × 2 × (#sharded
    axes)``.  The running count is ``ppermute.calls``.

        fn = build_sharded_runner(prog, total_t=16)
        count_ppermutes(fn, x)    # e.g. 4 blocks × 2 dirs × 1 axis = 8
    """
    before = ppermute.calls
    fn(*args)
    return ppermute.calls - before

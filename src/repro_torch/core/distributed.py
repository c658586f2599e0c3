"""Distributed EBISU: deep-halo exchange + temporal blocking across devices
(counterpart of ``repro.core.distributed``).

The paper amortizes *device-wide synchronization* over ``t`` fused time
steps (§4.1/§5.2.2).  Across devices the analogous synchronization is the
halo exchange: this module exchanges a ``t_block·rad``-deep halo **once
per t_block steps**, which

  * divides the number of exchange rounds by ``t_block``;
  * keeps total halo *bytes* constant (depth × 1/frequency);
  * pays redundant compute on the halo (Eq 8/9), the trade the paper
    makes inside a device, lifted to the mesh.

The reference is single-controller (one process, ``shard_map`` and
``ppermute`` over a ``jax.sharding.Mesh``), and so is the port: one
process drives every device of a :class:`~repro_torch.launch.mesh.Mesh`.
What ``shard_map`` did, the port does by hand: a field is split into one
tensor per mesh position (:class:`ShardLayout`, the role of a
``PartitionSpec`` and ``device_put``), and from then on each shard is a
separate tensor on its own device.  A shard reads another shard's cells
only through a received slab, never by indexing the global field, even
when every shard lives on one device.  :func:`ppermute` stands for one
``lax.ppermute``: it sends one slab per (source, destination) pair with a
device-to-device copy (an on-device copy where a device repeats), and
counts one call.  ``shard_map_compat`` has no counterpart: the loops over
shards here are the mapped function.

Domain decomposition is N-dimensional: each sharded tensor dim maps to a
mesh axis (or a tuple of axes, flattened major-to-minor).  Halo exchange
is sequential per axis on the progressively extended shards, so
box-stencil corners arrive via two hops.

Per-shard compute is plain torch (``kernels/ref.stencil_step``) with
*global-coordinate* masking, which keeps zero-Dirichlet semantics exact
at the true domain edges while interior seams are healed by the halo.

The LM half's parallelism (``models/parallel.py``) uses the reductions
beside ``ppermute``: :func:`psum`, :func:`pmean`, :func:`pmax` and
:func:`all_gather` over a mesh axis or a tuple of axes.  Each takes a
mesh-shaped object array of shards and returns a new one: the members
of each group (the positions that differ only along the axis) are
copied to the device of the group's first member, combined there in
mesh-index order (so the result does not depend on timing), and the
result is copied back to every member, out of place, so autograd
differentiates through it.  Each counts its calls, in ``.calls`` and by
axis in ``.by_axis``, and by axis the bytes of one member's results in
``.bytes_by_axis`` (:func:`ppermute`: in ``.result_bytes``, of the
slab one position receives); :func:`in_collective` is true while one
runs.  Over a mesh made by ``launch.mesh.representative`` (one position
standing for all of a mesh's positions) each collective takes that
position as every member of its group, so results have the whole
mesh's shapes.
"""
from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.stencil_spec import StencilSpec
from repro_torch.kernels.ref import stencil_step


# ============================================================ mesh indices ==
def _axes(ax) -> tuple:
    return (ax,) if isinstance(ax, str) else tuple(ax)


def _axis_size(mesh, ax) -> int:
    return math.prod(mesh.shape[a] for a in _axes(ax))


def _axis_index(mesh, ax, coord: tuple) -> int:
    """Flattened index of mesh position ``coord`` over a (possibly tuple)
    mesh axis, major-to-minor — ``lax.axis_index`` for one shard."""
    idx = 0
    for a in _axes(ax):
        k = mesh.axis_names.index(a)
        idx = idx * mesh.devices.shape[k] + coord[k]
    return idx


def _with_index(mesh, ax, coord: tuple, i: int) -> tuple:
    """The mesh position whose index over ``ax`` is ``i``, the other
    axes' coordinates those of ``coord``."""
    c = list(coord)
    for a in reversed(_axes(ax)):
        k = mesh.axis_names.index(a)
        n = mesh.devices.shape[k]
        c[k] = i % n
        i //= n
    return tuple(c)


def _shard_map(fn, shards: np.ndarray) -> np.ndarray:
    out = np.empty(shards.shape, dtype=object)
    for c in np.ndindex(*shards.shape):
        out[c] = fn(c, shards[c])
    return out


def smap(fn, *arrays: np.ndarray) -> np.ndarray:
    """``fn`` applied position by position to mesh-shaped object arrays:
    ``out[c] = fn(a[c], b[c], ...)``."""
    out = np.empty(arrays[0].shape, dtype=object)
    for c in np.ndindex(*out.shape):
        out[c] = fn(*(a[c] for a in arrays))
    return out


def unzip(arr: np.ndarray, n: int) -> tuple:
    """A mesh-shaped array of ``n``-tuples as ``n`` mesh-shaped arrays."""
    return tuple(smap(lambda t, i=i: t[i], arr) for i in range(n))


# ============================================================ collectives ==
def _groups(mesh, ax) -> list[list[tuple]]:
    """The mesh positions grouped by their coordinates off ``ax``, each
    group in index order over ``ax`` (over a representative mesh: its
    one position, once for each member)."""
    if getattr(mesh, "stands_for", None) is not None:
        return [[(0,) * mesh.devices.ndim] * _axis_size(mesh, ax)]
    names = set(_axes(ax))
    groups: dict[tuple, list] = {}
    for c in np.ndindex(*mesh.devices.shape):
        key = tuple(v for k, v in enumerate(c)
                    if mesh.axis_names[k] not in names)
        groups.setdefault(key, []).append(c)
    return [sorted(g, key=lambda c: _axis_index(mesh, ax, c))
            for g in groups.values()]


_ACTIVE = [0]


def in_collective() -> bool:
    """Whether a collective's copies and reductions are running now."""
    return _ACTIVE[0] > 0


def _count(fn, ax, out: np.ndarray) -> np.ndarray:
    fn.calls += 1
    key = _axes(ax)
    fn.by_axis[key] = fn.by_axis.get(key, 0) + 1
    first = out.flat[0]
    fn.bytes_by_axis[key] = (fn.bytes_by_axis.get(key, 0)
                             + first.numel() * first.element_size())
    return out


def _collective(body):
    """Run ``body`` with :func:`in_collective` true."""
    _ACTIVE[0] += 1
    try:
        return body()
    finally:
        _ACTIVE[0] -= 1


def _reduce(shards: np.ndarray, ax, mesh, op) -> np.ndarray:
    def body():
        out = np.empty(shards.shape, dtype=object)
        for group in _groups(mesh, ax):
            root = mesh.devices[group[0]]
            acc = shards[group[0]]
            for c in group[1:]:
                acc = op(acc, shards[c].to(root))
            for c in group:
                out[c] = (acc if c == group[0]
                          else acc.to(mesh.devices[c], copy=True))
        return out
    return _collective(body)


def psum(shards: np.ndarray, ax, mesh) -> np.ndarray:
    """``lax.psum`` over mesh axis ``ax`` (a name or a tuple of names):
    every member of a group gets the sum of the group's shards, added in
    index order on the first member's device."""
    return _count(psum, ax, _reduce(shards, ax, mesh, torch.add))


def pmean(shards: np.ndarray, ax, mesh) -> np.ndarray:
    """``lax.pmean``: :func:`psum` divided by the axis size."""
    n = _axis_size(mesh, ax)
    out = _reduce(shards, ax, mesh, torch.add)
    return _count(pmean, ax, _collective(lambda: smap(lambda t: t / n,
                                                      out)))


def pmax(shards: np.ndarray, ax, mesh) -> np.ndarray:
    """``lax.pmax``: the elementwise maximum over the group."""
    return _count(pmax, ax, _reduce(shards, ax, mesh, torch.maximum))


def all_gather(shards: np.ndarray, ax, mesh, dim: int) -> np.ndarray:
    """``lax.all_gather(..., tiled=True)``: every member gets the group's
    shards concatenated along ``dim`` in index order."""
    def body():
        out = np.empty(shards.shape, dtype=object)
        for group in _groups(mesh, ax):
            for c in group:
                dev = mesh.devices[c]
                out[c] = torch.cat([shards[m].to(dev) for m in group],
                                   dim=dim)
        return out
    return _count(all_gather, ax, _collective(body))


COLLECTIVES = (psum, pmean, pmax, all_gather)
for _fn in COLLECTIVES:
    _fn.calls, _fn.by_axis, _fn.bytes_by_axis = 0, {}, {}


def reset_collectives() -> None:
    """Every collective's counts to 0."""
    for fn in COLLECTIVES:
        fn.calls, fn.by_axis, fn.bytes_by_axis = 0, {}, {}


def collective_counts() -> dict:
    """``{name: {axes: calls}}`` of the collectives called since the last
    :func:`reset_collectives`, axes as a ``+``-joined string."""
    return {fn.__name__: {"+".join(k): n for k, n in fn.by_axis.items()}
            for fn in COLLECTIVES if fn.calls}


def collective_bytes() -> dict:
    """``{name: {axes: bytes}}``: the bytes of one member's results of
    the collectives counted by :func:`collective_counts`."""
    return {fn.__name__: {"+".join(k): n
                          for k, n in fn.bytes_by_axis.items()}
            for fn in COLLECTIVES if fn.calls}


# ================================================================ exchange ==
def ppermute(slabs: dict, pairs: Sequence[tuple], mesh) -> dict:
    """One collective permute: ``slabs[src]`` lands on the device of
    ``dst`` for each ``(src, dst)`` pair, as a new tensor there (a
    device-to-device copy; an on-device copy where both positions share
    a device).  Destinations with no source get nothing, as
    ``lax.ppermute`` leaves them zero.  Adds one to ``ppermute.calls``.
    """
    ppermute.calls += 1

    def body():
        out = {}
        for src, dst in pairs:
            s = slabs[src]
            out[dst] = torch.empty(s.shape, dtype=s.dtype,
                                   device=mesh.devices[dst]).copy_(s)
        return out
    out = _collective(body)
    if out:
        first = next(iter(out.values()))
        ppermute.result_bytes += first.numel() * first.element_size()
    return out


ppermute.calls = ppermute.result_bytes = 0


def _pad_axis(v: torch.Tensor, dim: int, h: int,
              periodic: bool) -> torch.Tensor:
    """Extend ``v`` by ``h`` cells on both sides of ``dim``: wrapped
    (periodic) or zero."""
    if periodic:
        n = v.shape[dim]
        idx = torch.arange(-h, n + h, device=v.device) % n
        return v.index_select(dim, idx)
    shape = list(v.shape)
    shape[dim] = h
    z = v.new_zeros(shape)
    return torch.cat([z, v, z], dim=dim)


def _exchange_one_axis(shards: np.ndarray, dim: int, h: int, axis_name,
                       mesh, *, periodic: bool = False) -> np.ndarray:
    """Extend every shard by h-deep halos along ``dim`` from its mesh
    neighbours over ``axis_name``: two :func:`ppermute` calls, one per
    direction.

    Open chain (default): shards at the ends receive zeros, which is
    exactly the zero-extension the global Dirichlet boundary needs.
    ``periodic=True`` closes the chain into a ring — shard 0's low halo
    is shard n−1's last rows.  ``n == 1`` pads locally (wrap or zero),
    with no exchange.
    """
    n = _axis_size(mesh, axis_name)
    if n == 1:
        return _shard_map(lambda c, v: _pad_axis(v, dim, h, periodic),
                          shards)
    last = n if periodic else n - 1    # ring closes the (n-1, 0) hop
    hi, lo, down, up = {}, {}, [], []
    for c in np.ndindex(*shards.shape):
        v = shards[c]
        hi[c] = v.narrow(dim, v.shape[dim] - h, h)
        lo[c] = v.narrow(dim, 0, h)
        i = _axis_index(mesh, axis_name, c)
        if i < last:
            nxt = _with_index(mesh, axis_name, c, (i + 1) % n)
            down.append((c, nxt))      # i's last rows -> i+1's top halo
            up.append((nxt, c))        # i+1's first rows -> i's bottom
    from_prev = ppermute(hi, down, mesh)
    from_next = ppermute(lo, up, mesh)

    def extend(c, v):
        zero = None
        if c not in from_prev or c not in from_next:
            zero = torch.zeros_like(lo[c])
        return torch.cat([from_prev.get(c, zero), v,
                          from_next.get(c, zero)], dim=dim)

    return _shard_map(extend, shards)


# ================================================================= layout ==
class ShardLayout:
    """Mesh axis ``dim_to_axis[d]`` splits tensor dim ``d``: the split of
    a global tensor into one tensor per mesh position, each on its
    position's device (what a ``PartitionSpec`` plus ``device_put`` did),
    and the assembly of the shards back into one tensor.  Mesh axes that
    split no dim replicate: their shards compute the same cells, and
    assembly reads the first replica.

        layout = ShardLayout(mesh, {0: "shard0", 1: "shard1"}, 2)
        shards = layout.split(x)             # numpy object array
        y = layout.assemble(shards, x.device)
    """

    def __init__(self, mesh, dim_to_axis: Mapping[int, object],
                 global_shape: Sequence[int]):
        self.mesh = mesh
        self.dim_to_axis = dict(dim_to_axis)
        self.global_shape = tuple(int(n) for n in global_shape)
        used = {a for ax in self.dim_to_axis.values() for a in _axes(ax)}
        self._replica_axes = [k for k, a in enumerate(mesh.axis_names)
                              if a not in used]

    def index(self, coord: tuple) -> tuple:
        """The global slice mesh position ``coord`` owns."""
        idx = [slice(None)] * len(self.global_shape)
        for d, ax in self.dim_to_axis.items():
            n = _axis_size(self.mesh, ax)
            ln = self.global_shape[d] // n
            i = _axis_index(self.mesh, ax, coord)
            idx[d] = slice(i * ln, (i + 1) * ln)
        return tuple(idx)

    def split(self, x: torch.Tensor) -> np.ndarray:
        if tuple(x.shape) != self.global_shape:
            raise ValueError(f"layout of shape {self.global_shape}; got "
                             f"{tuple(x.shape)}")

        def take(c, _):
            src = x[self.index(c)]
            return torch.empty(src.shape, dtype=src.dtype,
                               device=self.mesh.devices[c]).copy_(src)

        return _shard_map(take, np.empty(self.mesh.devices.shape,
                                         dtype=object))

    def assemble(self, shards: np.ndarray, device) -> torch.Tensor:
        first = shards.flat[0]
        y = torch.empty(self.global_shape, dtype=first.dtype, device=device)
        for c in np.ndindex(*shards.shape):
            if any(c[k] for k in self._replica_axes):
                continue
            y[self.index(c)].copy_(shards[c])
        return y


# =============================================================== stencils ==
def _blocked_steps(ext: torch.Tensor, spec: StencilSpec, t_block: int,
                   origins: Mapping[int, int],
                   global_shape: Sequence[int]) -> torch.Tensor:
    """t_block fused steps on the extended shard, re-masking every step so
    cells outside the *global* domain stay zero (exact Dirichlet
    semantics).  Unsharded dims are zero-extended by stencil_step's
    padding, which is already exact for them."""
    mask = None
    for dim, origin in origins.items():
        ids = torch.arange(ext.shape[dim], device=ext.device) + origin
        ok = (ids >= 0) & (ids < global_shape[dim])
        shape = [1] * ext.dim()
        shape[dim] = ext.shape[dim]
        ok = ok.reshape(shape)
        mask = ok if mask is None else mask & ok
    for _ in range(t_block):
        ext = stencil_step(ext, spec)
        if mask is not None:
            ext = torch.where(mask, ext, torch.zeros((), dtype=ext.dtype,
                                                     device=ext.device))
    return ext


def make_distributed_stencil(spec: StencilSpec, mesh,
                             dim_to_axis: Mapping[int, object],
                             global_shape: Sequence[int],
                             t_total: int, t_block: int,
                             inner: str = "jnp"):
    """``(fn, layout)``: ``fn(shards) -> shards`` applies ``t_total``
    steps in blocks of ``t_block`` with one deep-halo exchange per block
    and sharded axis; ``layout`` (a :class:`ShardLayout`) splits a global
    field into the shards ``fn`` takes and assembles its result.

    ``dim_to_axis`` maps tensor dims to mesh axis names (or tuples of
    them), e.g. {0: 'data', 1: 'model'} for a 2-D decomposition.
    ``inner="stub"`` replaces the per-shard steps with one scaling (the
    exchange alone, for accounting).

        fn, layout = make_distributed_stencil(spec, mesh, {0: "x"},
                                              (64, 48), 6, 3)
        y = layout.assemble(fn(layout.split(x)), x.device)
    """
    if t_total % t_block:
        raise ValueError("t_total must be a multiple of t_block")
    n_blocks = t_total // t_block
    h = spec.halo(t_block)
    global_shape = tuple(int(n) for n in global_shape)
    for d, ax in dim_to_axis.items():
        n_ax = _axis_size(mesh, ax)
        shard_len = global_shape[d] // n_ax
        if global_shape[d] % n_ax:
            raise ValueError(f"dim {d} ({global_shape[d]}) is not divisible "
                             f"by mesh axis {ax!r} ({n_ax} shards)")
        if h > shard_len:
            raise ValueError(
                f"halo {h} exceeds shard extent {shard_len} on dim {d}; "
                f"reduce t_block or the mesh axis")
    layout = ShardLayout(mesh, dim_to_axis, global_shape)

    def fn(shards: np.ndarray) -> np.ndarray:
        for _ in range(n_blocks):
            ext = shards
            for d, ax in dim_to_axis.items():
                ext = _exchange_one_axis(ext, d, h, ax, mesh)

            def inner_fn(c, e):
                if inner == "stub":
                    # the exchange alone: one scaling stands for the
                    # per-shard kernel (1 read + 1 write per cell)
                    e = e * 0.999
                else:
                    origins = {d: _axis_index(mesh, ax, c)
                               * (e.shape[d] - 2 * h) - h
                               for d, ax in dim_to_axis.items()}
                    e = _blocked_steps(e, spec, t_block, origins,
                                       global_shape)
                sl = [slice(None)] * e.dim()
                for d in dim_to_axis:
                    sl[d] = slice(h, e.shape[d] - h)
                return e[tuple(sl)]

            shards = _shard_map(inner_fn, ext)
        return shards

    return fn, layout

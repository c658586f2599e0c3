"""LM-side parallelism over the single-process device mesh.

The reference writes one global program whose weights carry
``PartitionSpec``s; GSPMD splits the arithmetic and inserts the
collectives, and the answer is the unsharded answer.  The port does the
same by hand over a :class:`~repro_torch.launch.mesh.Mesh` driven by one
process (the design of the stencil shards, ``core/distributed.py``):

  * **placement** — :class:`MeshModel` splits every parameter by its
    spec into one tensor per mesh position, on that position's device
    (a ``ParamModule`` per position, of the local shapes).  A shard sees
    another's data only through a collective, even when every shard
    lives on one device;
  * **execution** — the model runs every shard layer by layer in
    lockstep.  Column-parallel products (``wq``, ``wk``, ``wv``,
    ``w_up``, ``w_gate``, ``wz``, ``wx``) give each shard its own heads
    or features; row-parallel products (``wo``, ``w_down``,
    ``out_proj``) give partial sums that one ``psum`` over ``model``
    completes, where Megatron puts it.  Activations between blocks are
    replicated over ``model`` and split over the DP axes (the
    reference's ``L.shard(x, dp, None, None)``); the embedding table is
    split over ``d_model``, so a lookup gives each shard its slice and
    an ``all_gather`` rebuilds the row, and a head that contracts the
    split ``d_model`` takes one ``psum`` per loss chunk.  The MoE runs
    expert-parallel (``moe.apply_moe_ep``), the SSM head-parallel
    (``ssm.apply_ssm_mesh``), and the flash kernel runs per shard on the
    shard's heads and batch rows;
  * **gradients** — autograd differentiates through the collectives'
    copies, from one replica of the (replicated) loss.  A parameter
    replicated over an axis is one logical leaf held in several copies,
    so its gradient is the sum of the copies' gradients: a ``psum`` over
    the axes the leaf is replicated on (``replica_grads``).

Where a dim does not divide over its axis the port does not pad, as
GSPMD would: that part is replicated, which gives the same answer.
Attention splits heads only when ``kv_heads`` divides over ``model``
(otherwise every model shard computes every head), the SSM when
``ssm_heads`` does, the MoE its experts when ``n_experts_padded`` does,
and the batch over the DP axes when it divides.  A mesh of size 1 runs
the unsharded path.

``sharding="fsdp"`` (the reference's ``params.fsdp_transform`` specs:
each leaf's largest dim that the whole mesh divides is split over every
axis, the rest replicated; the batch over every axis) runs the same
control flow with nothing split over ``model``: where the executor
reads a layer's parameters (``_sub``), it ``all_gather``s each split
leaf over its axes first (:meth:`MeshModel.gathered`), inside the
layer's remat unit, so a backward gathers again.  Autograd sums every
position's gradient of a gathered copy into the shard it came from
(each shard's gradient reduced to its slice); ``replica_grads`` sums
the replicated leaves' copies, as under ``tp``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.distributed import (_axis_index, all_gather, psum,
                                          smap, unzip)
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as T
from repro_torch.models.params import (NamedSharding, OnMesh, ParamModule,
                                       flat_defs, spec_axes, tree_map)


# ================================================================ placement ==
def _size(mesh, axes) -> int:
    return math.prod(mesh.shape.get(a, 1) for a in axes)


def mesh_defs(cfg, mesh):
    """``transformer.param_defs(cfg)`` with each spec as the mesh executor
    places it: the reference's, with ``model`` dropped from the
    attention leaves unless ``kv_heads`` divides over it, from the SSM's
    split leaves unless ``ssm_heads`` does, and from the experts unless
    ``n_experts_padded`` does; then every axis that is absent from the
    mesh or does not divide its dim dropped (replicated).  Under
    ``sharding="fsdp"`` no group drops ``model``: the specs are
    ``fsdp_transform``'s."""
    nm = mesh.shape.get("model", 1)
    keep_model = {} if cfg.sharding == "fsdp" else {
        "attn": nm > 1 and cfg.kv_heads % nm == 0,
        "ssm": nm > 1 and cfg.ssm_heads and cfg.ssm_heads % nm == 0,
        "moe": nm > 1 and cfg.n_experts_padded % nm == 0,
    }

    def fix(group, d):
        spec = []
        for k, entry in enumerate(d.pspec):
            axes = tuple(a for a in spec_axes(entry) if a in mesh.shape
                         and (a != "model" or keep_model.get(group, True)))
            if not axes or d.shape[k] % _size(mesh, axes):
                spec.append(None)
            else:
                spec.append(axes[0] if len(axes) == 1 else axes)
        return dataclasses.replace(d, pspec=tuple(spec))

    def walk(tree, group=None):
        if isinstance(tree, dict):
            return {k: walk(v, k if k in keep_model else group)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, group) for v in tree]
        return fix(group, tree)

    return walk(T.param_defs(cfg))


class MeshModel(OnMesh):
    """A model placed on a mesh: one :class:`ParamModule` of local shapes
    per mesh position (``shards``, mesh-shaped), each on its position's
    device, split from a full state by :func:`mesh_defs`' specs.

        mm = MeshModel(cfg, mesh, model)         # split model's weights
        logits, cache = transformer.prefill(cfg, mm, batch, cache_len)
        state = mm.state_dict("cpu")            # gathered, mesh-free
    """

    def __init__(self, cfg, mesh, state=None):
        self.cfg, self.mesh = cfg, mesh
        self.defs = mesh_defs(cfg, mesh)
        self.flat = flat_defs(self.defs)
        self.shardings = {n: NamedSharding(mesh, d.pspec)
                          for n, d in self.flat.items()}
        local = tree_map(lambda d: dataclasses.replace(
            d, shape=NamedSharding(mesh, d.pspec).local_shape(d.shape)),
            self.defs)
        self.shards = np.empty(mesh.devices.shape, dtype=object)
        for c in np.ndindex(*self.shards.shape):
            self.shards[c] = ParamModule(local, dtype=cfg.param_dtype,
                                         device=mesh.devices[c])
        self._leaves = None
        if state is not None:
            self.load_state_dict(state)

    def leaves(self) -> dict[str, np.ndarray]:
        """Each parameter's shards (mesh-shaped), by name (the same
        tensors on every call: updates are in place)."""
        if self._leaves is None:
            per = smap(lambda m: dict(m.named_parameters()), self.shards)
            self._leaves = {n: smap(lambda d, n=n: d[n], per)
                            for n in self.flat}
        return self._leaves

    def params(self) -> np.ndarray:
        """What the executor reads parameters from: the shards, or under
        ``sharding="fsdp"`` this model at every position, which
        :func:`_sub` turns into the named part gathered whole."""
        if self.cfg.sharding != "fsdp":
            return self.shards
        return smap(lambda _: self, self.shards)

    def gathered(self, path: tuple) -> np.ndarray:
        """FSDP: every position's parameters under ``path`` gathered
        whole, one ``all_gather`` over its axes per split leaf: a leaf's
        tensors, or a submodule's as nested dicts (``p["wq"]``)."""
        prefix = ".".join(str(k) for k in path)
        if prefix in self.flat:
            return self._gather(prefix)
        out = smap(lambda _: _Gathered(), self.shards)
        for n in self.flat:
            if not n.startswith(prefix + "."):
                continue
            full = self._gather(n)
            *inner, leaf = n[len(prefix) + 1:].split(".")
            for c in np.ndindex(*out.shape):
                node = out[c]
                for k in inner:
                    node = node.setdefault(k, _Gathered())
                node[leaf] = full[c]
        return out

    def _gather(self, name: str) -> np.ndarray:
        t = self.leaves()[name]
        for k, axes in self.shardings[name].dims(
                self.flat[name].shape).items():
            t = all_gather(t, axes if len(axes) > 1 else axes[0], self.mesh,
                           dim=k)
        return t

    @torch.no_grad()
    def load_state_dict(self, state) -> None:
        """Split a full state (a module or a name → tensor dict) into the
        shards, in place."""
        if isinstance(state, torch.nn.Module):
            state = dict(state.named_parameters())
        for n, shards in self.leaves().items():
            full = state[n]
            if tuple(full.shape) != tuple(self.flat[n].shape):
                raise ValueError(f"{n}: shape {tuple(full.shape)}, expected "
                                 f"{tuple(self.flat[n].shape)}")
            for c, part in np.ndenumerate(self.shardings[n].split(full)):
                shards[c].copy_(part)

    @torch.no_grad()
    def state_dict(self, device="cpu") -> dict[str, torch.Tensor]:
        """Every parameter gathered whole on ``device``."""
        return {n: self.shardings[n].gather(s, self.flat[n].shape, device)
                for n, s in self.leaves().items()}

    # ``transformer``'s entry points on this mesh, as they answer on one
    # device: rows gathered onto the first position's device, and the
    # first position's copy of a replicated loss
    def forward_hidden(self, cfg, batch):
        hs, aux, dp = forward_hidden(cfg, self, batch)
        return (gather_rows(hs, self.mesh, dp),
                0.0 if aux is None else aux.flat[0])

    def train_loss(self, cfg, batch):
        return train_loss(cfg, self, batch).flat[0]

    def prefill(self, cfg, batch, cache_len):
        return prefill(cfg, self, batch, cache_len)

    def decode_step(self, cfg, cache, tokens, pos):
        return decode_step(cfg, self, cache, tokens, pos)


class _Gathered(dict):
    """One position's parameters of a submodule gathered whole under FSDP;
    reads like the ``ParamModule`` it stands for (``p["wq"]``,
    ``p.defs`` naming its leaves)."""

    @property
    def defs(self) -> dict:
        return {k: v for k, v in self.items() if isinstance(v, torch.Tensor)}


def replica_grads(mm: MeshModel, grads: dict) -> dict:
    """The logical gradient of each leaf, in its shards: the copies'
    gradients summed (``psum``) over the axes the leaf is replicated on
    (of size > 1); leaves split on every axis keep theirs.  ``grads``
    (name → mesh-shaped shards) is updated leaf by leaf, so one leaf's
    copies at a time are held twice, and returned."""
    for n, g in grads.items():
        axes = tuple(a for a in mm.shardings[n].replica_axes(
            mm.flat[n].shape) if mm.mesh.shape[a] > 1)
        if axes:
            grads[n] = psum(g, axes if len(axes) > 1 else axes[0], mm.mesh)
    return grads


# ================================================================= helpers ==
def dp_axes(cfg, mesh, batch: int):
    """The axes the batch rows are split over (``None``: replicated): the
    DP axes, every axis under ``sharding="fsdp"``."""
    names = ("pod", "data", "model") if cfg.sharding == "fsdp" \
        else ("pod", "data")
    dp = tuple(a for a in names if mesh.shape.get(a, 1) > 1)
    n = _size(mesh, dp)
    if not dp or batch % n:
        return None
    return dp if len(dp) > 1 else dp[0]


def shard_batch(batch: dict, mesh, dp) -> np.ndarray:
    """Each input split over ``dp`` along its batch dim (whole where
    ``dp`` is ``None``) → a mesh-shaped array of per-position dicts."""
    parts = {k: L.shard(v, mesh, dp) for k, v in batch.items()}
    return smap(lambda *vs: dict(zip(parts, vs)), *parts.values())


def gather_rows(arr: np.ndarray, mesh, dp) -> torch.Tensor:
    """The global tensor of per-position row blocks split over ``dp``
    (the first replica's), on the first position's device."""
    dev = mesh.devices.flat[0]
    if dp is None:
        return arr.flat[0].to(dev)
    blocks = {}
    for c in np.ndindex(*arr.shape):
        i = _axis_index(mesh, dp, c)
        blocks.setdefault(i, arr[c])
    return torch.cat([blocks[i].to(dev) for i in sorted(blocks)], dim=0)


def _sub(ps, *path):
    """Each position's submodule at ``path`` (gathered whole under
    FSDP)."""
    if isinstance(ps.flat[0], MeshModel):
        return ps.flat[0].gathered(path)

    def get(p):
        for k in path:
            p = p[k]
        return p
    return smap(get, ps)


def _outer(ps, cfg):
    """Each position's parameters that ``transformer._inputs`` reads
    (under FSDP only those, gathered whole)."""
    if not isinstance(ps.flat[0], MeshModel):
        return ps
    names = (("mask_embed",) if cfg.family == "encoder"
             else ("embed", "patch_proj") if cfg.family == "vlm"
             else ("embed",))
    parts = [_sub(ps, n) for n in names]
    return smap(lambda *vs: _Gathered(zip(names, vs)), *parts)


def _model_index(mesh) -> np.ndarray:
    k = mesh.axis_names.index("model") if "model" in mesh.axis_names \
        else None
    out = np.empty(mesh.devices.shape, dtype=object)
    for c in np.ndindex(*out.shape):
        out[c] = 0 if k is None else c[k]
    return out


def _norm(xs, ps, cfg):
    return smap(lambda x, p: L.apply_norm(x, p, cfg.norm), xs, ps)


def _add(a, b):
    return smap(lambda x, y: x + y, a, b)


def _attn_cfg(cfg, ps):
    """The config a shard's attention runs with (its local heads) and
    whether its heads are split."""
    hl = ps.flat[0]["wo"].shape[0] // cfg.head_dim
    if hl == cfg.n_heads:
        return cfg, False
    return dataclasses.replace(cfg, n_heads=hl,
                               kv_heads=cfg.kv_heads * hl // cfg.n_heads), \
        True


def _row_parallel(ys, split, mesh):
    return psum(ys, "model", mesh) if split else ys


def _attn(xs, ps, cfg, mesh, positions, causal=True):
    c, split = _attn_cfg(cfg, ps)
    out = smap(lambda x, p, pos: T.apply_attn(x, p, c, positions=pos,
                                              causal=causal),
               xs, ps, positions)
    hs, kvs = unzip(out, 2)
    return _row_parallel(hs, split, mesh), kvs


def _mlp(xs, ps, cfg, mesh):
    split = ps.flat[0]["w_down"].shape[0] < cfg.d_ff
    return _row_parallel(smap(lambda x, p: L.apply_mlp(x, p, cfg.act),
                              xs, ps), split, mesh)


def _ffn(xs, bps, cfg, mesh, dp):
    """The block's second half on the residual → (ys, auxs)."""
    h = _norm(xs, _sub(bps, "ln2"), cfg)
    if cfg.family == "moe":
        return moe_mod.apply_moe_ep(
            h, _sub(bps, "moe"), mesh, n_experts=cfg.n_experts,
            n_padded=cfg.n_experts_padded, top_k=cfg.top_k, act=cfg.act,
            capacity_factor=cfg.moe_capacity, dp_axes=dp)
    return _mlp(h, _sub(bps, "mlp"), cfg, mesh), None


def _block(xs, bps, cfg, mesh, positions, dp):
    """One block on every shard → (xs, auxs or None, kvs or None)."""
    if cfg.family in T.ATTN_FAMILIES:
        hs, kvs = _attn(_norm(xs, _sub(bps, "ln1"), cfg), _sub(bps, "attn"),
                        cfg, mesh, positions,
                        causal=cfg.family != "encoder")
        xs = _add(xs, hs)
        ys, aux = _ffn(xs, bps, cfg, mesh, dp)
        return _add(xs, ys), aux, kvs
    ys, _, _ = ssm_mod.apply_ssm_mesh(_norm(xs, _sub(bps, "ln1"), cfg),
                                      _sub(bps, "ssm"), cfg, mesh,
                                      chunk=cfg.ssm_chunk)
    return _add(xs, ys), None, None


def _shared(xs, sps, cfg, mesh, positions):
    """The hybrid's shared attention+MLP block → (xs, kvs)."""
    hs, kvs = _attn(_norm(xs, _sub(sps, "ln1"), cfg), _sub(sps, "attn"),
                    cfg, mesh, positions)
    xs = _add(xs, hs)
    return _add(xs, _mlp(_norm(xs, _sub(sps, "ln2"), cfg), _sub(sps, "mlp"),
                         cfg, mesh)), kvs


def _full_d(xs, cfg, mesh):
    """Rows whose ``d_model`` is split over ``model`` gathered whole."""
    if xs.flat[0].shape[-1] < cfg.d_model:
        return all_gather(xs, "model", mesh, dim=-1)
    return xs


def _inputs(cfg, ps, bs, mesh):
    return _full_d(smap(lambda p, b: T._inputs(cfg, p, b), _outer(ps, cfg),
                        bs),
                   cfg, mesh)


def _positions(xs):
    return smap(T._positions, xs)


def _table(cfg, ps):
    if cfg.family == "encoder" or not cfg.tie_embeddings:
        return _sub(ps, "head")
    return _sub(ps, "embed", "table")


def _d_slice(h, table, m):
    """The slice of the whole ``h`` whose ``d_model`` columns ``table``
    holds, for model shard ``m``."""
    dl = table.shape[-1]
    return h if dl == h.shape[-1] else h.narrow(-1, m * dl, dl)


def _logits(cfg, ps, hs, mesh):
    """``transformer.logits_fn`` on every shard: a split head contracts
    its ``d_model`` slice, and one ``psum`` over ``model`` completes it."""
    tables = _table(cfg, ps)
    out = smap(lambda h, t, m: torch.einsum(
        "bsd,vd->bsv", _d_slice(h, t, m).float(), t.float()),
        hs, tables, _model_index(mesh))
    return _row_parallel(out, tables.flat[0].shape[-1] < cfg.d_model, mesh)


# ================================================================= forward ==
def _layer(xs, ps, cfg, mesh, positions, idx, dp):
    """Layer ``idx`` on every shard, its parameters read (under FSDP:
    gathered) here, inside the remat unit."""
    if T.runs_shared(cfg, idx):
        xs, _ = _shared(xs, _sub(ps, "shared_attn"), cfg, mesh, positions)
    xs, aux, _ = _block(xs, _sub(ps, "blocks", idx), cfg, mesh, positions,
                        dp)
    return xs, aux


def forward_hidden(cfg, mm: MeshModel, batch: dict):
    """``transformer.forward_hidden`` on the mesh → (hidden, aux, dp):
    mesh-shaped per-position hidden rows and aux losses (``None`` unless
    MoE), and the axes the rows are split over."""
    T._check_family(cfg)
    mesh, ps = mm.mesh, mm.params()
    dp = dp_axes(cfg, mesh, next(iter(batch.values())).shape[0])
    bs = shard_batch(batch, mesh, dp)
    xs = _inputs(cfg, ps, bs, mesh)
    positions = _positions(xs)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = None
    for idx in range(cfg.n_layers):
        if remat:
            xs, a = checkpoint(_layer, xs, ps, cfg, mesh, positions, idx,
                               dp, use_reentrant=False)
        else:
            xs, a = _layer(xs, ps, cfg, mesh, positions, idx, dp)
        if a is not None:
            aux = a if aux is None else _add(aux, a)
    xs = _norm(xs, _sub(ps, "ln_f"), cfg)
    if cfg.family == "vlm":
        n = batch["patches"].shape[1]
        xs = smap(lambda x: x[:, n:], xs)
    return xs, aux, dp


def _ce_chunk(hs, ts, ls, ms, mids, mesh, split):
    logits = _row_parallel(smap(lambda h, t, m: torch.einsum(
        "bsd,vd->bsv", _d_slice(h, t, m).float(), t), hs, ts, mids),
        split, mesh)
    return smap(L._ce_from_logits, logits, ls, ms)


def train_loss(cfg, mm: MeshModel, batch: dict) -> np.ndarray:
    """``transformer.train_loss`` on the mesh: each position's copy of
    the global mean cross-entropy (the data shards' sums and counts
    ``psum``med once) plus ``moe_aux_weight`` × the aux loss."""
    mesh, ps = mm.mesh, mm.params()
    hs, aux, dp = forward_hidden(cfg, mm, batch)
    bs = shard_batch(batch, mesh, dp)
    tables = smap(lambda t: t.float(), _table(cfg, ps))
    split = tables.flat[0].shape[-1] < cfg.d_model
    if cfg.family == "encoder":
        masks = smap(lambda b: b["mask"].float(), bs)
    else:
        masks = smap(lambda b, h: b.get("loss_mask", torch.ones(
            h.shape[:2], dtype=torch.float32, device=h.device)), bs, hs)
    labels = smap(lambda b: b["labels"], bs)
    s = hs.flat[0].shape[1]
    chunk = min(cfg.loss_chunk, s)
    mids = _model_index(mesh)
    sums = None
    for c0 in range(0, s, chunk):
        def cut(a, c0=c0):
            return smap(lambda t: t[:, c0:c0 + chunk], a)
        part = checkpoint(_ce_chunk, cut(hs), tables, cut(labels),
                          cut(masks), mids, mesh, split,
                          use_reentrant=False)
        sums = part if sums is None else _add(sums, part)
    if dp is not None:
        sums = psum(sums, dp, mesh)
    losses = smap(lambda t: t[0] / torch.clamp(t[1], min=1.0), sums)
    if aux is not None:
        losses = smap(lambda l, a: l + cfg.moe_aux_weight * a, losses, aux)
    return losses


# ================================================================= serving ==
@torch.no_grad()
def prefill(cfg, mm: MeshModel, batch: dict, cache_len: int):
    """``transformer.prefill`` on the mesh → (last-position logits, the
    global tensor on the first position's device; per-position decode
    caches, mesh-shaped, each shard's heads and rows)."""
    T._check_family(cfg)
    mesh, ps, fam = mm.mesh, mm.params(), cfg.family
    if fam == "encoder":
        hs, _, dp = forward_hidden(cfg, mm, batch)
        logits = _logits(cfg, ps, smap(lambda h: h[:, -1:], hs), mesh)
        return gather_rows(logits, mesh, dp), smap(lambda _: {}, hs)
    dp = dp_axes(cfg, mesh, batch["tokens"].shape[0])
    xs = _inputs(cfg, ps, shard_batch(batch, mesh, dp), mesh)
    s = xs.flat[0].shape[1]
    positions = _positions(xs)

    def to_cache(kv):
        return T._to_cache(cfg, kv[0], kv[1], s, cache_len)

    caches = [None] * cfg.n_layers
    shared = [None] * T.n_shared_invocations(cfg)
    for idx in range(cfg.n_layers):
        bps = _sub(ps, "blocks", idx)
        if fam in ("dense", "moe", "vlm"):
            xs, _, kvs = _block(xs, bps, cfg, mesh, positions, dp)
            caches[idx] = smap(to_cache, kvs)
            continue
        if T.runs_shared(cfg, idx):
            xs, kvs = _shared(xs, _sub(ps, "shared_attn"), cfg, mesh,
                              positions)
            shared[idx // cfg.attn_every] = smap(lambda kv: {
                k: (t.to(cfg.activ_dtype) if k != "slot_pos" else t)
                for k, t in to_cache(kv).items()}, kvs)
        ys, tails, finals = ssm_mod.apply_ssm_mesh(
            _norm(xs, _sub(bps, "ln1"), cfg), _sub(bps, "ssm"), cfg, mesh,
            chunk=cfg.ssm_chunk)
        xs = _add(xs, ys)
        caches[idx] = smap(lambda t, f: {"conv": t.to(cfg.activ_dtype),
                                         "state": f.float()}, tails, finals)
    xs = _norm(xs, _sub(ps, "ln_f"), cfg)
    logits = _logits(cfg, ps, smap(lambda x: x[:, -1:], xs), mesh)
    key = "attn" if fam in ("dense", "moe", "vlm") else "ssm"
    cache = smap(lambda *ls: {key: list(ls)}, *caches)
    if fam == "hybrid":
        cache = smap(lambda c, *sh: dict(c, shared_attn=list(sh)), cache,
                     *shared)
    return gather_rows(logits, mesh, dp), cache


def _attn_decode(xs, ps, cfg, mesh, caches, pos):
    c, split = _attn_cfg(cfg, ps)
    out = smap(lambda x, p, sl: T.apply_attn_decode(x, p, c, cache=sl,
                                                    layer_pos=pos),
               xs, ps, caches)
    hs, new = unzip(out, 2)
    new = smap(T._cast_like, new, caches)
    return _row_parallel(hs, split, mesh), new


@torch.no_grad()
def decode_step(cfg, mm: MeshModel, cache: np.ndarray, tokens, pos: int):
    """``transformer.decode_step`` on the mesh: ``tokens`` (B, 1) global,
    ``cache`` as :func:`prefill` gives it → (logits (B, 1, V) on the
    first position's device, the new mesh-shaped cache; the k/v tensors
    are updated in place)."""
    mesh, ps, fam = mm.mesh, mm.params(), cfg.family
    dp = dp_axes(cfg, mesh, tokens.shape[0])
    toks = shard_batch({"tokens": tokens}, mesh, dp)
    xs = _full_d(smap(lambda p, b: T._embed(cfg, p, b["tokens"]),
                      _outer(ps, cfg), toks), cfg, mesh)
    xs = smap(lambda x: x.to(cfg.activ_dtype), xs)
    if fam not in ("dense", "moe", "vlm", "ssm", "hybrid"):
        raise ValueError(fam)
    key = "attn" if fam in ("dense", "moe", "vlm") else "ssm"
    new = [None] * cfg.n_layers
    shared = (smap(lambda c: list(c["shared_attn"]), cache)
              if fam == "hybrid" else None)
    for idx in range(cfg.n_layers):
        bps = _sub(ps, "blocks", idx)
        sls = smap(lambda c, i=idx: c[key][i], cache)
        if key == "attn":
            hs, new[idx] = _attn_decode(_norm(xs, _sub(bps, "ln1"), cfg),
                                        _sub(bps, "attn"), cfg, mesh, sls,
                                        pos)
            xs = _add(xs, hs)
            ys, _ = _ffn(xs, bps, cfg, mesh, dp)
            xs = _add(xs, ys)
            continue
        if T.runs_shared(cfg, idx):
            j = idx // cfg.attn_every
            sps = _sub(ps, "shared_attn")
            hs, sl = _attn_decode(
                _norm(xs, _sub(sps, "ln1"), cfg), _sub(sps, "attn"), cfg,
                mesh, smap(lambda s: s[j], shared), pos)
            for c in np.ndindex(*shared.shape):
                shared[c][j] = sl[c]
            xs = _add(xs, hs)
            xs = _add(xs, _mlp(_norm(xs, _sub(sps, "ln2"), cfg),
                               _sub(sps, "mlp"), cfg, mesh))
        ys, convs, states = ssm_mod.ssm_decode_mesh(
            _norm(xs, _sub(bps, "ln1"), cfg), _sub(bps, "ssm"), cfg, mesh,
            smap(lambda s: s["conv"], sls), smap(lambda s: s["state"], sls))
        new[idx] = smap(lambda cv, st, s: T._cast_like(
            {"conv": cv, "state": st}, s), convs, states, sls)
        xs = _add(xs, ys)
    xs = _norm(xs, _sub(ps, "ln_f"), cfg)
    logits = _logits(cfg, ps, xs, mesh)
    out = smap(lambda *ls: {key: list(ls)}, *new)
    if fam == "hybrid":
        out = smap(lambda c, sh: dict(c, shared_attn=sh), out, shared)
    return gather_rows(logits, mesh, dp), out

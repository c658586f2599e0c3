"""Multi-pod dry run: every (arch × shape × mesh) cell traced on meta
shards and counted, with no card (counterpart of
``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b \\
        --shape train_4k --out results/dryrun
    REPRO_DRYRUN_DEVICES=8 python -m repro_torch.launch.dryrun \\
        --mesh smoke --arch stencil-suite --shape j2d5pt,j3d7pt

The reference lowers and compiles each cell's program for 256 (one pod,
``(data, model)`` 16 × 16) or 512 (two pods, ``(pod, data, model)``)
placeholder devices and reads XLA's cost and memory analyses.  The port
has no compiler to ask: it runs the same program (the train step, the
serving prefill, or one cached decode step, at ``SHAPES[shape]``)
through the mesh executor (``models/parallel.py``) on shards of
``torch.device("meta")``, which carry shapes and no data, under
:class:`CostMode`, a ``TorchDispatchMode`` that counts, per device:

  * ``dot_flops`` with ``FlopCounterMode``'s own formulas
    (``torch.utils.flop_counter.flop_registry``: every matmul, batched
    matmul and convolution), ``ew_flops`` one per output element of each
    floating-point arithmetic op (the reference's ``hlo_cost`` set);
  * ``bytes_accessed``: each op's tensor inputs read once and outputs
    written once (views, and the copies that move a shard between
    devices, excluded);
  * the collectives of ``core/distributed.py`` (``collective_counts``,
    ``collective_bytes``) under XLA's names: ``psum``/``pmean``/``pmax``
    → ``all-reduce``, ``all_gather`` → ``all-gather``, ``ppermute`` →
    ``collective-permute``, with the reference's ring wire formulas;
  * the peak of live bytes the step allocates (``temp_bytes``).

Nothing that repeats is replayed.  Every shard of a cell holds one
local shape (the executor splits a dim evenly or not at all), so one
position standing for all of them (``launch.mesh.representative``)
runs what each device runs.  A chunked attention's blocks, which all
have one shape, run once and count for their trip count, forward and
backward (:func:`flash_attention_trips`), as ``hlo_cost`` multiplies a
scan body by its trip count.  The shortcuts count what a full replay
counts (``tests/test_torch_dryrun.py``).

Records keep the reference's schema.  ``memory`` keeps its six keys;
what the meta device cannot measure is said in ``memory_derivation``:
``code_bytes`` is 0 (the port builds no per-program code: its kernels
are libraries built once per source or tap set), and
``peak_per_device`` is ``argument + output + temp − alias`` as in the
reference, ``temp`` being the dispatch mode's peak of live bytes less
the outputs it holds.  ``cost_analysis_raw`` is what one pass
dispatched, each repeated block once (XLA's ``cost_analysis`` counts a
loop body once too).  The terms use the H100 model (``core/roofline``:
the dense bf16 tensor-core peak, 3.35 TB/s, NVLink's 50 GB/s links,
datasheet figures); the stencil cells' compute term uses the fp32
non-tensor peak, as the reference uses the VPU's.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

import repro_torch.configs as C
from repro_torch.core import distributed as D
from repro_torch.core import roofline as rl
from repro_torch.launch.mesh import (make_mesh, make_production_mesh,
                                     representative)
from repro_torch.models import attention as attn_mod
from repro_torch.models import parallel, transformer
from repro_torch.models.parallel import MeshModel
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step

HW = rl.H100
META = torch.device("meta")

_aten = torch.ops.aten
# floating-point arithmetic, one flop per output element (the reference's
# ``hlo_cost._EW_ARITH``; masks, selects, compares and copies are not flops)
_EW = {_aten.add, _aten.sub, _aten.mul, _aten.div, _aten.neg, _aten.abs,
       _aten.maximum, _aten.minimum, _aten.pow, _aten.sqrt, _aten.rsqrt,
       _aten.exp, _aten.expm1, _aten.log, _aten.log1p, _aten.tanh,
       _aten.sin, _aten.cos, _aten.atan2, _aten.add_, _aten.sub_,
       _aten.mul_, _aten.div_}
# outputs these ops leave unwritten
_UNWRITTEN = {_aten.empty, _aten.empty_like, _aten.empty_strided,
              _aten.new_empty, _aten.new_empty_strided}
# collectives under XLA's names, and the reference's ring wire factor
XLA_NAMES = {"psum": "all-reduce", "pmean": "all-reduce",
             "pmax": "all-reduce", "all_gather": "all-gather",
             "ppermute": "collective-permute"}


def _wire(kind: str, g: int) -> float:
    return {"all-reduce": 2 * (g - 1) / g, "all-gather": (g - 1) / g,
            "collective-permute": 1.0}[kind]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ============================================================== counting ==
class CostMode(TorchDispatchMode):
    """Counts the ops dispatched under it (see the module docstring):
    ``dot_flops``, ``ew_flops``, ``bytes``, their one-pass twins
    (``dispatched_*``, every multiplier 1) and ``peak`` live bytes of
    the tensors allocated under it.  ``trips(n)`` multiplies what runs
    inside it by ``n``.

        with CostMode() as cm:
            step(...)
        cm.dot_flops, cm.bytes, cm.peak
    """

    def __init__(self):
        super().__init__()
        self.dot_flops = self.ew_flops = self.bytes = 0
        self.dispatched_flops = self.dispatched_bytes = 0
        self.mult = 1
        self.live_bytes = self.peak = 0
        self._live: dict = {}      # storage -> [bytes, holders]
        self._hooks = None

    @contextlib.contextmanager
    def trips(self, n: int):
        """Count what runs inside as ``n`` runs of it."""
        self.mult *= n
        try:
            yield
        finally:
            self.mult //= n

    # ---------------------------------------------------- live bytes ----
    def _hold(self, t: torch.Tensor, holder) -> None:
        key = t.untyped_storage()._cdata
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [t.untyped_storage().nbytes(), 0]
            self.live_bytes += entry[0]
            self.peak = max(self.peak, self.live_bytes)
        entry[1] += 1
        weakref.finalize(holder, self._release, key)

    def _release(self, key) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._live[key]

    def drop_live(self, before, keep) -> None:
        """Stop counting the storages allocated since ``before`` (a set
        of storages) that are still held, but those of ``keep``: what a
        counted block's graph saves stands for a remat unit's, which the
        replay frees at the layer's end."""
        kept = {t.untyped_storage()._cdata for t in keep}
        for key, entry in self._live.items():
            if key not in before and key not in kept:
                self.live_bytes -= entry[0]
                entry[0] = 0

    def _pack(self, t):
        holder = _Saved(t)
        if t.untyped_storage()._cdata in self._live:
            self._hold(t, holder)
        return holder

    def __enter__(self):
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, _Saved.unpack)
        self._hooks.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._hooks.__exit__(*exc)
        return out

    # ------------------------------------------------------ dispatch ----
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        for t in outs:
            self._hold(t, t)
        if D.in_collective() or func.is_view:
            return out
        ins = list(_tensors((args, kwargs)))
        packet = func._overloadpacket
        if (packet is _aten._to_copy and len(ins) == 1 and outs
                and outs[0].dtype == ins[0].dtype):
            return out      # a shard moved between devices: a transfer
        nbytes = sum(_nbytes(t) for t in ins)
        if packet not in _UNWRITTEN:
            nbytes += sum(_nbytes(t) for t in outs)
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.dot_flops += self.mult * flops
        elif packet in _EW and outs and outs[0].is_floating_point():
            flops = outs[0].numel()
            self.ew_flops += self.mult * flops
        self.bytes += self.mult * nbytes
        self.dispatched_bytes += nbytes
        self.dispatched_flops += flops
        return out


class _Saved:
    """A tensor autograd saved for the backward, held while it is."""

    def __init__(self, t):
        self.t = t

    def unpack(self):
        return self.t


_ACTIVE: list[CostMode] = []


class _Trips(torch.autograd.Function):
    """``fn(*inputs)`` run once and counted as ``n`` runs, its backward
    too: the forward runs under ``trips(n)``; the backward computes one
    run's input gradients, also under ``trips(n)``, and counts the
    ``n - 1`` additions the autograd engine makes to sum ``n`` runs'
    gradients of each input every run reads (``shared[i]``; the others
    are a loop's carry, one run's each).  ``stack_dim`` set: the result
    is ``n`` copies of the one run's output stacked there (what the
    replay's ``torch.stack`` of ``n`` blocks gives), and each copy's
    gradient is its own run's."""

    @staticmethod
    def forward(ctx, n, stack_dim, shared, fn, *inputs):
        mode = _ACTIVE[-1]
        grad = any(t.requires_grad for t in inputs)
        leaves = [t.detach().requires_grad_(t.requires_grad) for t in inputs]
        # the run's graph keeps its own saved tensors: a remat unit around
        # it (torch.utils.checkpoint) recomputes the layer, and with it
        # this forward, once, as the replay does, and never this graph
        before = set(mode._live)
        with torch.enable_grad() if grad else torch.no_grad(), \
                torch.autograd.graph.saved_tensors_hooks(
                    mode._pack, _Saved.unpack), mode.trips(n):
            outs = fn(*leaves)
        mode.drop_live(before, outs)
        ctx.n, ctx.stack_dim, ctx.shared = n, stack_dim, shared
        ctx.leaves, ctx.outs = leaves, outs
        if stack_dim is not None:
            return torch.stack([outs[0].detach()] * n, dim=stack_dim)
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        mode = _ACTIVE[-1]
        if ctx.stack_dim is not None:
            grads = (grads[0].select(ctx.stack_dim, 0),)
        want = [t for t in ctx.leaves if t.requires_grad]
        with mode.trips(ctx.n):
            got = iter(torch.autograd.grad(ctx.outs, want, grads,
                                           allow_unused=True))
        out = []
        for t, shared in zip(ctx.leaves, ctx.shared):
            g = next(got) if t.requires_grad else None
            if g is not None and shared:   # the engine's n - 1 additions
                mode.ew_flops += mode.mult * (ctx.n - 1) * g.numel()
                mode.bytes += mode.mult * (ctx.n - 1) * 3 * _nbytes(g)
            out.append(g)
        return (None, None, None, None, *out)


def flash_attention_trips(q, k, v, *, causal=True, window=None,
                          q_chunk=512, kv_chunk=1024, q_offset=0):
    """``models.attention.flash_attention`` with its query blocks run once
    and counted for their trip count (:class:`_Trips`): every block has
    one shape, and on meta tensors no value is computed."""
    b, s, h, hd = q.shape
    _, sk, kv, _ = k.shape
    if s % q_chunk or sk % kv_chunk or s <= q_chunk or not _ACTIVE:
        return _flash_attention(q, k, v, causal=causal, window=window,
                                q_chunk=q_chunk, kv_chunk=kv_chunk,
                                q_offset=q_offset)
    g = h // kv
    q5 = q.reshape(b, s // q_chunk, q_chunk, kv, g, hd).float()
    kf, vf = k.float(), v.float()

    def block(q5, kf, vf):
        return (attn_mod.q_block(q5, 0, kf, vf, kv_chunk=kv_chunk,
                                 causal=causal, window=window,
                                 q_offset=q_offset),)

    out = _Trips.apply(s // q_chunk, 1, (True,) * 3, block, q5, kf, vf)
    return out.reshape(b, s, h, hd).to(q.dtype)


def _online_softmax_trips(q_blk, qpos, k, v, *, kv_chunk, causal, window,
                          scale):
    """``core.online_softmax.online_softmax`` with its key chunks after the
    first run once and counted for their trip count (see
    :func:`flash_attention_trips`): the first chunk's carry comes from
    ``softmax_init`` and needs no gradient, the others' does."""
    from repro_torch.core import online_softmax as osm

    n = k.shape[1] // kv_chunk
    if not _ACTIVE or k.shape[1] % kv_chunk or n < 2:
        return osm.online_softmax(q_blk, qpos, k, v, kv_chunk=kv_chunk,
                                  causal=causal, window=window, scale=scale)
    kw = dict(kv_chunk=kv_chunk, causal=causal, window=window, scale=scale)
    state = osm.softmax_step(osm.softmax_init(q_blk), q_blk, qpos, k, v, 0,
                             **kw)
    neg = state[3]

    def step(acc, m, l, q_blk, k, v):
        return osm.softmax_step((acc, m, l, neg), q_blk, qpos, k, v,
                                kv_chunk, **kw)[:3]

    return _Trips.apply(n - 1, None, (False,) * 3 + (True,) * 3, step,
                        *state[:3], q_blk, k, v)


_flash_attention = attn_mod.flash_attention


@contextlib.contextmanager
def counting(shortcut: bool = True):
    """A :class:`CostMode` over the block, with the collectives' counts
    reset at entry.  ``shortcut`` swaps in the trip-counted attention;
    the logits' assembly on the first device (``gather_rows``, a host
    step, no device's work) is left out either way."""
    mode = CostMode()
    saved = (attn_mod.flash_attention, attn_mod.online_softmax,
             parallel.gather_rows)
    if shortcut:
        attn_mod.flash_attention = flash_attention_trips
        attn_mod.online_softmax = _online_softmax_trips
    parallel.gather_rows = lambda arr, mesh, dp: arr.flat[0]
    D.reset_collectives()
    D.ppermute.calls = D.ppermute.result_bytes = 0
    _ACTIVE.append(mode)
    try:
        with mode:
            yield mode
    finally:
        _ACTIVE.pop()
        (attn_mod.flash_attention, attn_mod.online_softmax,
         parallel.gather_rows) = saved


def collective_cost(mesh) -> dict:
    """The collectives counted since :func:`counting` began, as
    ``hlo_cost.HloCost``'s collective fields (per device)."""
    count, result, wire = {}, {}, {}

    def add(kind, n, nbytes, g):
        count[kind] = count.get(kind, 0) + n
        result[kind] = result.get(kind, 0.0) + nbytes
        wire[kind] = wire.get(kind, 0.0) + _wire(kind, g) * nbytes

    calls, moved = D.collective_counts(), D.collective_bytes()
    for name, by_axis in calls.items():
        for axes, n in by_axis.items():
            g = math.prod(mesh.shape[a] for a in axes.split("+"))
            add(XLA_NAMES[name], n, float(moved[name][axes]), g)
    if D.ppermute.calls:
        add("collective-permute", D.ppermute.calls,
            float(D.ppermute.result_bytes), 2)
    return {"coll_count": count, "coll_result_bytes": result,
            "coll_wire_bytes": wire,
            "total_wire_bytes": float(sum(wire.values())),
            "total_coll_count": int(sum(count.values()))}


def cost_dict(mode: CostMode, mesh) -> dict:
    """``hlo_cost.HloCost.as_dict()``'s fields from a finished count."""
    out = {"dot_flops": float(mode.dot_flops),
           "ew_flops": float(mode.ew_flops),
           "total_flops": float(mode.dot_flops + mode.ew_flops),
           "bytes_accessed": float(mode.bytes)}
    out.update(collective_cost(mesh))
    return out


# =============================================================== programs ==
def _meta_input(spec) -> torch.Tensor:
    shape, dtype = spec
    return torch.empty(shape, dtype=dtype, device=META)


def mesh_cache(cfg, mm: MeshModel, batch: int, cache_len: int):
    """Each position's decode cache (mesh-shaped) as the mesh executor's
    prefill leaves it, of ``cache_len`` slots: ``transformer.cache_defs``
    at the local shapes, the batch split over the DP axes when it
    divides, the kv and SSM heads as the shards hold them."""
    mesh = mm.mesh
    dp = parallel.dp_axes(cfg, mesh, batch)
    b = batch // parallel._size(mesh, parallel.spec_axes(dp)) if dp \
        else batch
    nm = mesh.shape.get("model", 1)
    whole = cfg.sharding == "fsdp" or nm == 1
    kv = cfg.kv_heads if whole or cfg.kv_heads % nm else cfg.kv_heads // nm
    sh = cfg.ssm_heads if whole or not cfg.ssm_heads or cfg.ssm_heads % nm \
        else cfg.ssm_heads // nm
    local = dataclasses.replace(cfg, kv_heads=kv,
                                ssm_inner=sh * cfg.ssm_head_dim)
    defs = transformer.cache_defs(local, b, cache_len)

    def make(tree):
        if isinstance(tree, dict):
            return {k: make(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [make(v) for v in tree]
        return torch.zeros(tree.shape, dtype=tree.dtype or cfg.activ_dtype,
                           device=META)

    return D.smap(lambda _: make(defs), mm.shards)


def _bytes_of(tree) -> int:
    return sum(_nbytes(t) for t in _tensors(tree))


@dataclasses.dataclass
class Program:
    """One cell's program on a mesh: ``step()`` runs it once; the byte
    counts are one device's."""
    step: object
    argument_bytes: int
    output_bytes: object       # step's result -> one device's output bytes
    alias_bytes: int
    tokens: int


def lm_program(cfg, kind: str, batch: int, seq: int, mesh) -> Program:
    """The train step, the serving prefill or one cached decode step of
    ``cfg`` (already ``with_mesh``ed) at ``batch × seq`` on ``mesh`` (a
    mesh of meta shards, or its representative), built on meta.  The
    serving steps end at the logits: the next token's ``argmax`` reads
    the logits the port's mesh serving assembles on the first device, a
    host step, no device's work."""
    mm = MeshModel(cfg, mesh)
    params = sum(_bytes_of(list(m.parameters()))
                 for m in mm.shards.flat[:1])
    specs = cfg.inputs_for(kind, batch, seq)
    inputs = {k: _meta_input(v) for k, v in specs.items()}
    dp = parallel.dp_axes(cfg, mesh, batch)
    parts = {k: parallel.L.shard(v, mesh, dp).flat[0]
             for k, v in inputs.items()}
    batch_bytes = _bytes_of(parts)
    if kind == "train":
        ocfg = opt.OptConfig(schedule=cfg.schedule)
        step_fn = make_train_step(cfg, ocfg)
        state = opt.init_state(mm)
        moments = sum(_nbytes(s.shards.flat[0]) for k in ("m", "v")
                      for s in state[k].values())
        args = params + moments + batch_bytes
        return Program(lambda: step_fn(mm, state, inputs), args,
                       lambda out: params + moments, params + moments,
                       batch * seq)
    if kind == "prefill":
        return Program(lambda: transformer.prefill(cfg, mm, inputs, seq),
                       params + batch_bytes, _serve_out_bytes, 0,
                       batch * seq)
    cache = mesh_cache(cfg, mm, batch, seq)
    cache_bytes = _bytes_of(cache.flat[0])
    return Program(lambda: transformer.decode_step(cfg, mm, cache,
                                                   inputs["tokens"],
                                                   seq - 1),
                   params + batch_bytes + cache_bytes, _serve_out_bytes,
                   cache_bytes, batch)


def _serve_out_bytes(out) -> int:
    logits, cache = out
    return _nbytes(logits) + _bytes_of(cache.flat[0])


def measure(program: Program, mesh, *, shortcut: bool = True) -> dict:
    """Run ``program`` once under :func:`counting` → the record's
    analysis fields (``compile_s`` is the trace's seconds)."""
    t0 = time.time()
    with counting(shortcut) as mode:
        out = program.step()
    seconds = time.time() - t0
    hlo = cost_dict(mode, mesh)
    output = program.output_bytes(out)
    new_out = output - program.alias_bytes
    temp = max(0, mode.peak - new_out)
    memory = dict(argument_bytes=int(program.argument_bytes),
                  output_bytes=int(output), temp_bytes=int(temp),
                  alias_bytes=int(program.alias_bytes), code_bytes=0,
                  peak_per_device=int(program.argument_bytes + output
                                      + temp - program.alias_bytes))
    return {"compile_s": round(seconds, 2), "memory": memory,
            "memory_derivation": MEMORY_DERIVATION,
            "cost_analysis_raw": {"flops": float(mode.dispatched_flops),
                                  "bytes_accessed":
                                      float(mode.dispatched_bytes)},
            "hlo": hlo}


MEMORY_DERIVATION = {
    "argument_bytes": "one device's parameter shards, optimizer moments "
                      "(train), batch rows and decode cache, from their "
                      "local shapes",
    "output_bytes": "one device's results: its logits rows and the new "
                    "cache (serving), the updated parameters and moments "
                    "(train)",
    "temp_bytes": "the dispatch mode's peak of live bytes allocated by "
                  "the step (tensors and autograd's saved tensors; a "
                  "counted attention block's saved tensors only while it "
                  "runs, as under remat), less the new outputs it holds",
    "alias_bytes": "results updated in place: parameters and moments "
                   "(train), the decode cache",
    "code_bytes": "0: not measurable on the meta device, and the port "
                  "builds no per-program code (its kernels are "
                  "libraries built once per source or tap set)",
    "peak_per_device": "argument + output + temp - alias, the "
                       "reference's formula",
}


def model_flops(cfg, shape_name: str) -> float:
    """Analytic 6·N·D (train) / 2·N·D (inference) FLOPs, N = active
    params."""
    info = C.SHAPES[shape_name]
    return _model_flops(cfg, info["kind"], info["batch"], info["seq"])


def _model_flops(cfg, kind, batch, seq) -> float:
    tokens = batch * seq if kind != "decode" else batch
    return (6.0 if kind == "train" else 2.0) * cfg.n_active_params() * tokens


def roofline_terms(hlo: dict, n_chips: int, mesh_axes):
    """Per-chip three-term roofline (the counts are per device)."""
    t_comp = hlo["dot_flops"] / HW.mxu_flops
    t_mem = hlo["bytes_accessed"] / HW.b_gm
    links = HW.b_ici * max(1, HW.ici_links // 2)
    t_coll = hlo["total_wire_bytes"] / links
    terms = {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll}
    return terms, max(terms, key=terms.get)


def _analysis(rec: dict, fields: dict, mf: float, n_chips: int,
              peak: float, stencil: bool) -> dict:
    """The record's derived keys from the counted ``fields``."""
    hlo, mem = fields["hlo"], fields["memory"]
    terms, _ = roofline_terms(hlo, n_chips, None)
    mf_chip = mf / n_chips
    if stencil:
        terms["compute_s"] = mf_chip / peak
    dom = max(terms, key=terms.get)
    step_time = max(terms.values())
    rec.update(fields)
    rec.update(
        status="ok", model_flops=mf, terms=terms, dominant=dom,
        roofline_fraction=(mf_chip / peak) / step_time
        if step_time > 0 else None,
        useful_flops_ratio=(mf_chip / hlo["dot_flops"]
                            if hlo["dot_flops"] else None),
        hbm_ok=bool(mem["argument_bytes"] + mem["temp_bytes"]
                    - mem["alias_bytes"] < HW.hbm_bytes))
    return rec


def lm_record(cfg, kind: str, batch: int, seq: int, mesh, *,
              shortcut: bool = True) -> dict:
    """One LM cell's analysis: ``cfg`` (not yet ``with_mesh``ed) running
    ``kind`` at ``batch × seq`` on ``mesh`` (of meta shards; traced over
    its representative when ``shortcut``), as the record's keys."""
    cfgm = cfg.with_mesh(mesh)
    run_on = representative(mesh) if shortcut else mesh
    program = lm_program(cfgm, kind, batch, seq, run_on)
    fields = measure(program, mesh, shortcut=shortcut)
    return _analysis({}, fields, _model_flops(cfg, kind, batch, seq),
                     mesh.size, HW.mxu_flops, stencil=False)


def lower_cell(cfg, shape_name: str, mesh, attn_impl: str | None = None,
               sharding: str | None = None, ssm_impl: str | None = None,
               *, shortcut: bool = True) -> dict:
    """One (arch × shape) cell on ``mesh``, the flags applied as the
    reference applies them → the record's analysis keys."""
    if sharding:
        cfg = dataclasses.replace(cfg, sharding=sharding)
    if attn_impl:
        cfg = dataclasses.replace(cfg, attention_impl=attn_impl)
    if ssm_impl:
        cfg = dataclasses.replace(cfg, ssm_impl=ssm_impl)
    info = C.SHAPES[shape_name]
    return lm_record(cfg, info["kind"], info["batch"], info["seq"], mesh,
                     shortcut=shortcut)


# ---------------------------------------------------------------- stencil --
def run_stencil_cell(spec_name: str, mesh, t_block: int | None = None,
                     inner: str = "jnp", *, shortcut: bool = True) -> dict:
    """One Table-2 stencil over ``mesh`` with deep-halo exchanges
    (``core/distributed.make_distributed_stencil``): dim 0 over the DP
    axes, dim 1 over ``model``, the domain rounded up to divide, ``t``
    steps per exchange → the record's analysis keys."""
    from repro_torch.core.distributed import make_distributed_stencil
    from repro_torch.core.planner import plan
    from repro_torch.core.stencil_spec import get

    spec = get(spec_name)
    pl = plan(spec, HW)
    axes = dict(mesh.shape)
    dp = tuple(a for a in ("pod", "data") if a in axes)
    dp = dp if len(dp) > 1 else dp[0]
    dp_size = math.prod(v for k, v in axes.items() if k in ("pod", "data"))
    mdl = axes.get("model", 1)
    dim_to_axis = {0: dp, 1: "model"}
    dom = list(spec.domain)
    dom[0] = math.ceil(dom[0] / dp_size) * dp_size
    dom[1] = math.ceil(dom[1] / mdl) * mdl
    tb = t_block or max(1, min(pl.t, dom[0] // dp_size // spec.radius,
                               dom[1] // mdl // spec.radius))
    t_total = int(os.environ.get("REPRO_STENCIL_TTOTAL", 0)) or tb * 2
    if t_total % tb:
        raise ValueError(f"REPRO_STENCIL_TTOTAL={t_total} is no multiple "
                         f"of t_block={tb}")
    run_on = representative(mesh) if shortcut else mesh
    fn, layout = make_distributed_stencil(spec, run_on, dim_to_axis,
                                          tuple(dom), t_total, tb,
                                          inner=inner)
    shards = layout.split(torch.empty(tuple(dom), dtype=torch.float32,
                                      device=META))
    arg = _nbytes(shards.flat[0])
    fields = measure(Program(lambda: fn(shards), arg,
                             lambda out: _nbytes(out.flat[0]), 0,
                             math.prod(dom) * t_total), mesh,
                     shortcut=shortcut)
    fields.update(t_block=tb, t_total=t_total, domain=dom)
    return fields


# ------------------------------------------------------------------- main --
def run_cell(arch: str, shape_name: str, mesh, mesh_name: str, outdir: str,
             attn_impl: str | None = None, sharding: str | None = None,
             ssm_impl: str | None = None) -> dict:
    n_chips = mesh.size
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "n_chips": int(n_chips)}
    if attn_impl:
        rec["mesh"] = mesh_name = f"{mesh_name}-{attn_impl}"
    if sharding:
        rec["mesh"] = mesh_name = f"{mesh_name}-{sharding}"
    if ssm_impl:
        rec["mesh"] = mesh_name = f"{mesh_name}-ssmstub"
    try:
        if arch == "stencil-suite":
            from repro_torch.core.stencil_spec import get
            fields = run_stencil_cell(
                shape_name, mesh,
                t_block=int(os.environ.get("REPRO_STENCIL_TBLOCK", 0))
                or None,
                inner=os.environ.get("REPRO_STENCIL_INNER", "jnp"))
            spec = get(shape_name)
            mf = spec.flops_per_cell * math.prod(fields["domain"]) \
                * fields["t_total"]
            _analysis(rec, fields, mf, n_chips, HW.thr_cmp, stencil=True)
        else:
            cfg = C.get_config(arch)
            ok, why = cfg.supports(shape_name)
            if not ok:
                rec.update(status="skipped", reason=why)
                _write(outdir, rec)
                return rec
            rec.update(lower_cell(cfg, shape_name, mesh, attn_impl,
                                  sharding, ssm_impl))
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    _write(outdir, rec)
    return rec


def _write(outdir, rec):
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir,
                        f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    rf = rec.get("roofline_fraction")
    tail = (rec.get("error", "")[:120] if rec["status"] == "error"
            else rec.get("reason", ""))
    print(f"[{rec['status']:7s}] {rec['arch']:24s} {rec['shape']:12s} "
          f"{rec['mesh']:6s} compile={rec.get('compile_s', '-')}s "
          f"dom={rec.get('dominant', '-')} "
          f"roofline={rf and round(rf, 3)} {tail}", flush=True)


def meshes_for(which: str) -> list:
    """``[(name, mesh)]`` of meta shards for ``--mesh``: one pod (16 ×
    16), two pods (2 × 16 × 16), or the smoke mesh ``(n // 4, 4)`` of
    ``REPRO_DRYRUN_DEVICES`` shards (default 512)."""
    out = []
    if which in ("single", "both"):
        out.append(("single", make_production_mesh(
            multi_pod=False, devices=[META] * 256)))
    if which in ("multi", "both"):
        out.append(("multi", make_production_mesh(
            multi_pod=True, devices=[META] * 512)))
    if which == "smoke":
        n = int(os.environ.get("REPRO_DRYRUN_DEVICES") or 512)
        out.append(("smoke", make_mesh((max(1, n // 4), 4),
                                       ("data", "model"),
                                       devices=[META] * n)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both", "smoke"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--attn", default=None,
                    choices=[None, "flash_jnp", "boundary_stub"])
    ap.add_argument("--sharding", default=None, choices=[None, "tp", "fsdp"])
    ap.add_argument("--ssm", default=None,
                    choices=[None, "chunked_jnp", "boundary_stub"])
    args = ap.parse_args(argv)

    archs = (C.list_archs() if args.arch == "all" else args.arch.split(","))
    for mesh_name, mesh in meshes_for(args.mesh):
        for arch in archs:
            if arch == "stencil-suite":
                from repro_torch.core.stencil_spec import names
                shapes = names() if args.shape == "all" \
                    else args.shape.split(",")
            else:
                shapes = (list(C.SHAPES) if args.shape == "all"
                          else args.shape.split(","))
            for shape in shapes:
                run_cell(arch, shape, mesh, mesh_name, args.out, args.attn,
                         args.sharding, args.ssm)


if __name__ == "__main__":
    main()

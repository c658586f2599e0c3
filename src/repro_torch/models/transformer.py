"""Model zoo of the port: decoder LMs (dense, MoE, SSM, hybrid), the
encoder and the VLM wrapper.

Counterpart of the reference's ``repro/models/transformer.py``.  Families:

  dense    — pre-norm attention + (Swi/Ge)GLU MLP   (danube/minicpm/gemma/qwen3)
  moe      — attention + top-k MoE FFN              (qwen3-moe/granite-moe)
  ssm      — mamba2 SSD mixer only                  (mamba2-130m)
  hybrid   — mamba2 blocks + one *shared* attention+MLP block applied
             every ``attn_every`` layers            (zamba2)
  encoder  — bidirectional attention, LayerNorm, masked-prediction head
             (frames arrive pre-embedded)           (hubert)
  vlm      — decoder LM with a patch-embedding prefix (internvl2)

The reference stacks the layers on a leading L dim and scans over them;
here the layers are an ``nn.ModuleList`` (``models/params.py``), the loop
is a Python loop, and a decode cache is a list of per-layer dicts (the
hybrid's shared block has a list of its own, one entry per invocation,
indexed by ``layer // attn_every``).  Attention goes through the
compile-once front door (``api/attention.py``), so a config with
``attention_impl="flash_pallas"`` runs the CUDA flash kernel in every
prefill layer that attends (none for the SSM family, one per shared
invocation for the hybrid; the encoder's is bidirectional).

Training: :func:`train_loss` is the reference's (``forward_hidden`` then
the chunked cross-entropy of ``models/layers.py``, plus the MoE's aux
loss times ``moe_aux_weight``).  With ``cfg.remat`` and grad enabled,
each layer runs under ``torch.utils.checkpoint`` (non-reentrant), as the
reference wraps it in ``jax.checkpoint`` with ``nothing_saveable``: only
the layer's input is kept, and the layer — with the hybrid's shared
block where it runs — is run again in the backward, so a
``flash_pallas`` config launches the flash forward kernel twice per
attention call and the backward kernels once.

On one device the MoE block calls ``moe.apply_moe``, the dense
dispatch, as the reference's ``apply_moe_ep`` does without a mesh.
Given a ``parallel.MeshModel`` (a ``params.OnMesh``) in place of the
parameter module, :func:`forward_hidden`, :func:`train_loss`,
:func:`prefill` and :func:`decode_step` hand it to its own methods,
which run on its mesh (``models/parallel.py``): tensor
parallel over ``model``, data parallel over the DP axes, the MoE expert
parallel (``apply_moe_ep``), the flash kernel per shard.  The dry
run's stand-ins ``attention_impl="boundary_stub"`` (inlined in
:func:`apply_attn`, never compiled) and ``ssm_impl="boundary_stub"``
(``models/ssm.py``) keep a layer's boundary traffic and drop its
sequence-mixing work, as the reference's do.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.api.attention import attention_program_for
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.params import (OnMesh, ParamDef, ParamModule,
                                       fsdp_transform)

ATTN_FAMILIES = ("dense", "encoder", "vlm", "moe")
FAMILIES = ATTN_FAMILIES + ("ssm", "hybrid")


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


# ---------------------------------------------------------------- attention --
def attn_defs(cfg):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((d, h * hd), (None, "model")),
        "wk": ParamDef((d, kv * hd), (None, "model")),
        "wv": ParamDef((d, kv * hd), (None, "model")),
        "wo": ParamDef((h * hd, d), ("model", None)),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), (), "ones")
        defs["k_norm"] = ParamDef((hd,), (), "ones")
    return defs


def _qkv(x, p, cfg, b, s):
    h, kv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q = L.matmul(x, p["wq"]).reshape(b, s, h, hd)
    k = L.matmul(x, p["wk"]).reshape(b, s, kv, hd)
    v = L.matmul(x, p["wv"]).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"])
        k = L.rms_norm(k, p["k_norm"])
    return q, k, v


def apply_attn(x, p, cfg, *, positions, causal=True):
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv(x, p, cfg, b, s)
    if cfg.rope_theta:
        cos, sin = L.rope_cos_sin(positions, hd, cfg.rope_theta)
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    if cfg.attention_impl == "boundary_stub":
        # the dry run's stand-in for the flash kernel: the same q/k/v/o
        # traffic, no S x S work (each head's k and v averaged over the
        # sequence, which a shard holds whole)
        g = h // cfg.kv_heads
        km = k.mean(dim=1, keepdim=True).repeat_interleave(g, dim=2)
        vm = v.mean(dim=1, keepdim=True).repeat_interleave(g, dim=2)
        out = q * km + vm
    else:
        prog = attention_program_for(cfg, causal=causal, dtype=q.dtype)
        out = prog.apply(q, k.to(q.dtype), v.to(q.dtype))
    return L.matmul(out.reshape(b, s, h * hd), p["wo"]), (k, v)


def apply_attn_decode(x, p, cfg, *, cache, layer_pos: int):
    """x: (B,1,d). cache dict: k,v (B,Sc,KV,hd), slot_pos (Sc,); the k/v
    caches are written in place."""
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv(x, p, cfg, b, 1)
    if cfg.rope_theta:
        pos = torch.tensor([[layer_pos]], device=x.device)
        cos, sin = L.rope_cos_sin(pos, hd, cfg.rope_theta)
        cos = cos.expand(b, 1, hd // 2)
        sin = sin.expand(b, 1, hd // 2)
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    kc, vc = attn.cache_update(cache["k"], cache["v"], k, v, layer_pos,
                               window=cfg.swa_window)
    slot_pos = attn.rolling_slot_pos(cache["slot_pos"], layer_pos, 1,
                                     kc.shape[1])
    out = attn.decode_attention(q, kc, vc, layer_pos + 1,
                                slot_pos=slot_pos, window=cfg.swa_window)
    y = L.matmul(out.reshape(b, 1, h * hd), p["wo"])
    return y, {"k": kc, "v": vc, "slot_pos": slot_pos}


def attn_cache_defs(cfg, batch: int, cache_len: int):
    kv, hd = cfg.kv_heads, cfg.head_dim
    sc = min(cache_len, cfg.swa_window) if cfg.swa_window else cache_len
    kv_pspec = _cache_pspec(cfg, batch, sc)
    return {
        "k": ParamDef((batch, sc, kv, hd), kv_pspec, "zeros"),
        "v": ParamDef((batch, sc, kv, hd), kv_pspec, "zeros"),
        "slot_pos": ParamDef((sc,), (), "zeros", dtype=torch.int32),
    }


def _cache_pspec(cfg, batch: int, seq: int) -> tuple:
    """The reference's KV-cache spec over both mesh axes: the batch over
    the DP axes when divisible, else the cache's sequence over ``data``
    (a B=1 decode); kv heads over ``model`` when divisible, else
    head_dim.  The port's mesh executor keeps the head split and the
    batch split, and replicates where the reference splits the sequence
    or head_dim (ROADMAP Queue 3, known deviations)."""
    mm = max(1, cfg.mesh_model)
    if cfg.kv_heads % mm == 0 and cfg.kv_heads >= mm:
        model_dims = (None, "model", None)
    elif cfg.head_dim % mm == 0:
        model_dims = (None, None, "model")
    else:
        model_dims = (None, None, None)
    if batch % max(1, cfg.mesh_dp) == 0 and batch >= cfg.mesh_dp > 1:
        return (cfg.dp_axes, *model_dims)
    if cfg.mesh_dp > 1 and seq % cfg.mesh_dp == 0:
        return (None, "data", *model_dims[1:])
    return (None, *model_dims)


# -------------------------------------------------------------------- blocks --
def block_defs(cfg):
    """Per-layer parameter defs for one block of cfg.family."""
    fam = cfg.family
    if fam in ("dense", "encoder", "vlm"):
        return {
            "ln1": L.norm_defs(cfg.d_model, cfg.norm),
            "attn": attn_defs(cfg),
            "ln2": L.norm_defs(cfg.d_model, cfg.norm),
            "mlp": L.mlp_defs(cfg.d_model, cfg.d_ff, cfg.act),
        }
    if fam == "moe":
        mdefs, _ = moe_mod.moe_defs(cfg.d_model, cfg.d_ff, cfg.n_experts,
                                    act=cfg.act)
        return {
            "ln1": L.norm_defs(cfg.d_model, cfg.norm),
            "attn": attn_defs(cfg),
            "ln2": L.norm_defs(cfg.d_model, cfg.norm),
            "moe": mdefs,
        }
    if fam in ("ssm", "hybrid"):
        return {
            "ln1": L.norm_defs(cfg.d_model, cfg.norm),
            "ssm": ssm_mod.ssm_defs(cfg.d_model, cfg.ssm_inner,
                                    cfg.ssm_heads, cfg.ssm_state,
                                    cfg.ssm_groups),
        }
    raise ValueError(fam)


def shared_attn_defs(cfg):
    """zamba2: one shared attention+MLP block reused every attn_every layers."""
    return {
        "ln1": L.norm_defs(cfg.d_model, cfg.norm),
        "attn": attn_defs(cfg),
        "ln2": L.norm_defs(cfg.d_model, cfg.norm),
        "mlp": L.mlp_defs(cfg.d_model, cfg.d_ff, cfg.act),
    }


def _ffn(x, bp, cfg):
    """The block's second half on the residual ``x`` → (y, aux)."""
    h = L.apply_norm(x, bp["ln2"], cfg.norm)
    if cfg.family == "moe":
        return moe_mod.apply_moe(
            h, bp["moe"], n_experts=cfg.n_experts,
            n_padded=cfg.n_experts_padded, top_k=cfg.top_k, act=cfg.act,
            capacity_factor=cfg.moe_capacity)
    return L.apply_mlp(h, bp["mlp"], cfg.act), 0.0


def apply_block(x, bp, cfg, *, positions):
    """One block of cfg.family → ``(x, aux, (k, v))``: aux is the MoE's
    loss (0.0 for the others), k and v are for the cache (None for a
    mamba block)."""
    if cfg.family in ATTN_FAMILIES:
        h, kv = apply_attn(L.apply_norm(x, bp["ln1"], cfg.norm), bp["attn"],
                           cfg, positions=positions,
                           causal=cfg.family != "encoder")
        x = x + h
        y, aux = _ffn(x, bp, cfg)
        return x + y, aux, kv
    y = ssm_mod.apply_ssm(L.apply_norm(x, bp["ln1"], cfg.norm), bp["ssm"],
                          cfg, chunk=cfg.ssm_chunk)
    return x + y, 0.0, None


def apply_shared(x, sp, cfg, *, positions):
    """The hybrid's shared attention+MLP block → ``(x, (k, v))``."""
    h, kv = apply_attn(L.apply_norm(x, sp["ln1"], cfg.norm), sp["attn"], cfg,
                       positions=positions)
    x = x + h
    return x + L.apply_mlp(L.apply_norm(x, sp["ln2"], cfg.norm), sp["mlp"],
                           cfg.act), kv


def runs_shared(cfg, idx: int) -> bool:
    """Whether layer ``idx`` of a hybrid applies the shared block first."""
    return cfg.family == "hybrid" and idx % cfg.attn_every == 0


def n_shared_invocations(cfg) -> int:
    """How often a hybrid's forward applies the shared block."""
    return -(-cfg.n_layers // cfg.attn_every) if cfg.family == "hybrid" \
        else 0


# ------------------------------------------------------------- full models --
def param_defs(cfg):
    """The parameter tree: ``blocks`` is a list of per-layer trees."""
    defs: dict[str, Any] = {"blocks": [block_defs(cfg)
                                       for _ in range(cfg.n_layers)]}
    if cfg.family == "encoder":
        defs["embed_in"] = {}  # frames arrive pre-embedded (modality stub)
        defs["mask_embed"] = ParamDef((cfg.d_model,), (), "normal", 1.0)
        defs["head"] = ParamDef((cfg.vocab, cfg.d_model), (None, "model"))
    else:
        defs["embed"] = L.embed_defs(cfg.vocab, cfg.d_model)
        if not cfg.tie_embeddings:
            defs["head"] = ParamDef((cfg.vocab, cfg.d_model),
                                    (None, "model"))
    if cfg.family == "hybrid":
        defs["shared_attn"] = shared_attn_defs(cfg)
    if cfg.family == "vlm":
        defs["patch_proj"] = ParamDef((cfg.vlm_patch_dim, cfg.d_model),
                                      (None, "model"))
    defs["ln_f"] = L.norm_defs(cfg.d_model, cfg.norm)
    if cfg.sharding == "fsdp":
        total = max(1, cfg.mesh_dp) * max(1, cfg.mesh_model)
        defs = fsdp_transform(defs, cfg.dp_axes, total)
    return defs


def build_model(cfg, device=None) -> ParamModule:
    """The uninitialised parameter module of ``cfg`` in
    ``cfg.param_dtype`` on ``device`` (fill it with
    ``params.init_params`` or ``load_state_dict``)."""
    return ParamModule(param_defs(cfg), dtype=cfg.param_dtype,
                       device=device)


def _embed(cfg, params, tokens):
    x = L.embed_lookup(tokens, params["embed"]["table"])
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _inputs(cfg, params, batch):
    """The stream the blocks read, in ``activ_dtype``: the frames (masked
    ones replaced by ``mask_embed``) for the encoder; the token
    embeddings otherwise, after the projected patches for the VLM."""
    if cfg.family == "encoder":
        x = batch["frames"].to(cfg.activ_dtype)
        if "mask" in batch:
            x = torch.where(batch["mask"][..., None],
                            params["mask_embed"].to(x.dtype), x)
        return x
    x = _embed(cfg, params, batch["tokens"])
    if cfg.family == "vlm":
        patches = L.matmul(batch["patches"].to(x.dtype),
                           params["patch_proj"])
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    return x.to(cfg.activ_dtype)


def _positions(x):
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def _layer(x, bp, shared, cfg, positions, idx):
    """Layer ``idx`` of the forward (the shared block first where a
    hybrid runs it) → (x, aux); the unit ``cfg.remat`` recomputes."""
    if runs_shared(cfg, idx):
        x, _ = apply_shared(x, shared, cfg, positions=positions)
    x, aux, _ = apply_block(x, bp, cfg, positions=positions)
    return x, aux


def forward_hidden(cfg, params, batch):
    """Inputs + blocks + final norm -> hidden (B, S, d), aux loss (0.0
    unless MoE; the VLM's patch rows are sliced off).  Differentiable;
    each layer is rematerialised in the backward when ``cfg.remat``.  On
    a mesh the hidden rows are gathered onto the first position's
    device, and the aux loss is the first position's."""
    _check_family(cfg)
    if isinstance(params, OnMesh):
        return params.forward_hidden(cfg, batch)
    x = _inputs(cfg, params, batch)
    positions = _positions(x)
    shared = params["shared_attn"] if cfg.family == "hybrid" else None
    remat = cfg.remat and torch.is_grad_enabled()
    aux = 0.0
    for idx, bp in enumerate(params["blocks"]):
        if remat:
            x, a = checkpoint(_layer, x, bp, shared, cfg, positions, idx,
                              use_reentrant=False)
        else:
            x, a = _layer(x, bp, shared, cfg, positions, idx)
        aux = aux + a
    x = L.apply_norm(x, params["ln_f"], cfg.norm)
    if cfg.family == "vlm":
        x = x[:, batch["patches"].shape[1]:]
    return x, aux


def train_loss(cfg, params, batch):
    """Mean cross-entropy plus ``moe_aux_weight`` × the MoE aux loss: the
    encoder against its untied head over ``batch["mask"]`` (no label
    shift); the decoders against the tied embedding or the head over
    ``batch["loss_mask"]`` (all positions when absent).  On a mesh it
    is the first position's copy of the replicated loss."""
    if isinstance(params, OnMesh):
        return params.train_loss(cfg, batch)
    hidden, aux = forward_hidden(cfg, params, batch)
    if cfg.family == "encoder":
        table = params["head"]
        mask = batch["mask"].float()
    else:
        table = (params["embed"]["table"] if cfg.tie_embeddings
                 else params["head"])
        mask = batch.get("loss_mask")
    loss = L.chunked_ce_loss(hidden, table, batch["labels"], mask,
                             chunk=cfg.loss_chunk)
    return loss + cfg.moe_aux_weight * aux


# ----------------------------------------------------------------- serving --
def logits_fn(cfg, params, hidden):
    table = (params["head"] if (cfg.family == "encoder"
                                or not cfg.tie_embeddings)
             else params["embed"]["table"])
    return torch.einsum("bsd,vd->bsv", hidden.float(), table.float())


def cache_defs(cfg, batch: int, cache_len: int):
    """Per-layer decode caches: ``{"attn": [...]}`` for the attention
    decoders, ``{"ssm": [...]}`` for the SSM, and for the hybrid also
    ``"shared_attn"``, one attention cache per shared invocation."""
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return {"attn": [attn_cache_defs(cfg, batch, cache_len)
                         for _ in range(cfg.n_layers)]}
    if fam == "ssm":
        return {"ssm": [_ssm_cache_defs(cfg, batch)
                        for _ in range(cfg.n_layers)]}
    if fam == "hybrid":
        return {
            "ssm": [_ssm_cache_defs(cfg, batch) for _ in range(cfg.n_layers)],
            "shared_attn": [attn_cache_defs(cfg, batch, cache_len)
                            for _ in range(n_shared_invocations(cfg))],
        }
    raise ValueError(f"{fam} has no decode cache (encoder-only)")


def _ssm_cache_defs(cfg, batch: int):
    """The last 4 pre-conv rows (``activ_dtype``) and the float32 state,
    with the reference's specs (the port's mesh executor also splits the
    state's heads over ``model``, as it splits the SSM's heads)."""
    b_ax = (cfg.dp_axes if (cfg.mesh_dp > 1 and batch % cfg.mesh_dp == 0
                            and batch >= cfg.mesh_dp) else None)
    return {
        "conv": ParamDef((batch, 4, cfg.ssm_inner), (b_ax, None, "model"),
                         "zeros"),
        "state": ParamDef((batch, cfg.ssm_heads, cfg.ssm_state,
                           cfg.ssm_head_dim), (b_ax, None, None, None),
                          "zeros", dtype=torch.float32),
    }


def _cast_like(new, old):
    return {name: t.to(old[name].dtype) for name, t in new.items()}


def _shared_attn_decode(x, params, cfg, shared_cache, inv_idx, pos):
    """Apply the zamba2 shared block with invocation ``inv_idx``'s cache
    (replaced in the list)."""
    sp = params["shared_attn"]
    sl = shared_cache[inv_idx]
    h, new_sl = apply_attn_decode(L.apply_norm(x, sp["ln1"], cfg.norm),
                                  sp["attn"], cfg, cache=sl, layer_pos=pos)
    x = x + h
    x = x + L.apply_mlp(L.apply_norm(x, sp["ln2"], cfg.norm), sp["mlp"],
                        cfg.act)
    shared_cache[inv_idx] = _cast_like(new_sl, sl)
    return x


@torch.no_grad()
def decode_step(cfg, params, cache, tokens, pos: int):
    """One decode step. tokens: (B, 1) int; pos: int (synchronized
    batch).  Returns (logits (B, 1, V) float32, cache); the cache's k/v
    tensors are updated in place."""
    if isinstance(params, OnMesh):
        return params.decode_step(cfg, cache, tokens, pos)
    fam = cfg.family
    x = _embed(cfg, params, tokens).to(cfg.activ_dtype)
    if fam in ("dense", "moe", "vlm"):
        new = []
        for bp, sl in zip(params["blocks"], cache["attn"]):
            h, new_sl = apply_attn_decode(
                L.apply_norm(x, bp["ln1"], cfg.norm), bp["attn"], cfg,
                cache=sl, layer_pos=pos)
            x = x + h
            y, _ = _ffn(x, bp, cfg)
            x = x + y
            new.append(_cast_like(new_sl, sl))
        new_cache = {"attn": new}
    elif fam in ("ssm", "hybrid"):
        shared = list(cache["shared_attn"]) if fam == "hybrid" else None
        new = []
        for idx, (bp, sl) in enumerate(zip(params["blocks"], cache["ssm"])):
            if runs_shared(cfg, idx):
                x = _shared_attn_decode(x, params, cfg, shared,
                                        idx // cfg.attn_every, pos)
            y, conv, state = ssm_mod.ssm_decode(
                L.apply_norm(x, bp["ln1"], cfg.norm), bp["ssm"], cfg,
                sl["conv"], sl["state"])
            new.append(_cast_like({"conv": conv, "state": state}, sl))
            x = x + y
        new_cache = {"ssm": new}
        if fam == "hybrid":
            new_cache["shared_attn"] = shared
    else:
        raise ValueError(fam)
    x = L.apply_norm(x, params["ln_f"], cfg.norm)
    return logits_fn(cfg, params, x), new_cache


@torch.no_grad()
def prefill(cfg, params, batch, cache_len: int):
    """Process a full prompt, returning (last-token logits, decode cache).
    The encoder returns its last frame's logits and an empty cache.  On a
    mesh the cache is mesh-shaped, one cache per position."""
    if isinstance(params, OnMesh):
        return params.prefill(cfg, batch, cache_len)
    fam = cfg.family
    _check_family(cfg)
    if fam == "encoder":
        hidden, _ = forward_hidden(cfg, params, batch)
        return logits_fn(cfg, params, hidden[:, -1:]), {}
    x = _inputs(cfg, params, batch)
    s = x.shape[1]
    positions = _positions(x)
    if fam in ("dense", "moe", "vlm"):
        caches = []
        for bp in params["blocks"]:
            x, _, (k, v) = apply_block(x, bp, cfg, positions=positions)
            caches.append(_to_cache(cfg, k, v, s, cache_len))
        cache = {"attn": caches}
    else:
        shared = ([None] * n_shared_invocations(cfg) if fam == "hybrid"
                  else None)
        caches = []
        for idx, bp in enumerate(params["blocks"]):
            if runs_shared(cfg, idx):
                x, (k, v) = apply_shared(x, params["shared_attn"], cfg,
                                         positions=positions)
                sl = _to_cache(cfg, k, v, s, cache_len)
                shared[idx // cfg.attn_every] = {
                    "k": sl["k"].to(cfg.activ_dtype),
                    "v": sl["v"].to(cfg.activ_dtype),
                    "slot_pos": sl["slot_pos"]}
            y, conv, state = ssm_mod.apply_ssm_with_state(
                L.apply_norm(x, bp["ln1"], cfg.norm), bp["ssm"], cfg,
                chunk=cfg.ssm_chunk)
            x = x + y
            caches.append({"conv": conv.to(cfg.activ_dtype),
                           "state": state.float()})
        cache = {"ssm": caches}
        if fam == "hybrid":
            cache["shared_attn"] = shared
    x = L.apply_norm(x, params["ln_f"], cfg.norm)
    return logits_fn(cfg, params, x[:, -1:]), cache


def _to_cache(cfg, k, v, s: int, cache_len: int):
    """Pack prefill (B,S,KV,hd) k/v into a (B,Sc,KV,hd) cache + slot map:
    a rolling window keeps the last ``Sc`` positions at ``pos % Sc``;
    unused slots hold position -1."""
    w = cfg.swa_window
    sc = min(cache_len, w) if w else cache_len
    b, _, kv, hd = k.shape
    dev = k.device
    kc = torch.zeros((b, sc, kv, hd), dtype=k.dtype, device=dev)
    vc = torch.zeros((b, sc, kv, hd), dtype=v.dtype, device=dev)
    if w and s > sc:                      # rolling window: keep last sc
        keep_pos = torch.arange(s - sc, s, device=dev)
        slots = keep_pos % sc
        kc[:, slots] = k[:, s - sc:]
        vc[:, slots] = v[:, s - sc:]
        slot_pos = torch.zeros((sc,), dtype=torch.int32, device=dev)
        slot_pos[slots] = keep_pos.to(torch.int32)
    else:
        kc[:, :s] = k
        vc[:, :s] = v
        slot_pos = torch.full((sc,), -1, dtype=torch.int32, device=dev)
        slot_pos[:min(s, sc)] = torch.arange(min(s, sc), dtype=torch.int32,
                                             device=dev)
    return {"k": kc, "v": vc, "slot_pos": slot_pos}

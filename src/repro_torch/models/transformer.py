"""Decoder LMs of the port: the dense family (pre-norm attention and a
(Swi/Ge)GLU MLP — h2o-danube, minicpm, gemma, qwen3).

Counterpart of the dense branches of the reference's
``repro/models/transformer.py``.  The reference stacks the layers on a
leading L dim and scans over them; here the layers are an
``nn.ModuleList`` (``models/params.py``) and the loop is a Python loop,
and the decode cache is a list of per-layer dicts.  Attention goes
through the compile-once front door (``api/attention.py``), so a config
with ``attention_impl="flash_pallas"`` runs the CUDA flash kernel in
every prefill layer.

Training: :func:`train_loss` is the reference's (``forward_hidden`` then
the chunked cross-entropy of ``models/layers.py``).  With ``cfg.remat``
and grad enabled, each block runs under ``torch.utils.checkpoint``
(non-reentrant), as the reference wraps it in ``jax.checkpoint`` with
``nothing_saveable``: only the block's input is kept, and the block is
run again in the backward — so a ``flash_pallas`` config launches the
flash forward kernel twice per layer and the backward kernels once.

The MoE, SSM, hybrid, encoder and VLM families raise
``NotImplementedError`` until their modules are ported (ROADMAP Queue 1
item 15).  The reference's ``L.shard`` constraints are no-ops without a
mesh and are dropped; the dry-run stand-in
``attention_impl="boundary_stub"`` comes with the dry runs (item 16):
``attention_program_for`` refuses it.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.api.attention import attention_program_for
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef, ParamModule

_LATER = "ROADMAP Queue 1 item 15 (model stack: MoE, SSM, hybrid, " \
         "encoder and VLM families)"


def _dense_only(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family} family is not ported to repro_torch yet: "
            f"{_LATER}")


# ---------------------------------------------------------------- attention --
def attn_defs(cfg):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((d, h * hd)),
        "wk": ParamDef((d, kv * hd)),
        "wv": ParamDef((d, kv * hd)),
        "wo": ParamDef((h * hd, d)),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), "ones")
        defs["k_norm"] = ParamDef((hd,), "ones")
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
    return {
        "k": ParamDef((batch, sc, kv, hd), "zeros"),
        "v": ParamDef((batch, sc, kv, hd), "zeros"),
        "slot_pos": ParamDef((sc,), "zeros", dtype=torch.int32),
    }


# -------------------------------------------------------------------- blocks --
def block_defs(cfg):
    """Per-layer parameter defs for one block of the dense family."""
    _dense_only(cfg)
    return {
        "ln1": L.norm_defs(cfg.d_model, cfg.norm),
        "attn": attn_defs(cfg),
        "ln2": L.norm_defs(cfg.d_model, cfg.norm),
        "mlp": L.mlp_defs(cfg.d_model, cfg.d_ff, cfg.act),
    }


def apply_block(x, bp, cfg, *, positions):
    """One dense block; returns (x, (k, v)) — k and v for the cache."""
    h, kv = apply_attn(L.apply_norm(x, bp["ln1"], cfg.norm), bp["attn"],
                       cfg, positions=positions)
    x = x + h
    y = L.apply_mlp(L.apply_norm(x, bp["ln2"], cfg.norm), bp["mlp"], cfg.act)
    return x + y, kv


# ------------------------------------------------------------- full models --
def param_defs(cfg):
    """The parameter tree: ``blocks`` is a list of per-layer trees."""
    defs: dict[str, Any] = {"blocks": [block_defs(cfg)
                                       for _ in range(cfg.n_layers)]}
    defs["embed"] = L.embed_defs(cfg.vocab, cfg.d_model)
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((cfg.vocab, cfg.d_model))
    defs["ln_f"] = L.norm_defs(cfg.d_model, cfg.norm)
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
    return x.to(cfg.activ_dtype)


def _block_out(x, bp, cfg, positions):
    return apply_block(x, bp, cfg, positions=positions)[0]


def forward_hidden(cfg, params, batch):
    """Embed + blocks + final norm -> hidden (B, S, d), aux loss (0 for
    the dense family).  Differentiable; each block is rematerialised in
    the backward when ``cfg.remat``."""
    _dense_only(cfg)
    x = _embed(cfg, params, batch["tokens"])
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    remat = cfg.remat and torch.is_grad_enabled()
    for bp in params["blocks"]:
        if remat:
            x = checkpoint(_block_out, x, bp, cfg, positions,
                           use_reentrant=False)
        else:
            x = _block_out(x, bp, cfg, positions)
    return L.apply_norm(x, params["ln_f"], cfg.norm), 0.0


def train_loss(cfg, params, batch):
    """Mean next-token cross-entropy over ``batch["loss_mask"]`` (all
    positions when absent), against the tied embedding or the head."""
    hidden, aux = forward_hidden(cfg, params, batch)
    table = (params["embed"]["table"] if cfg.tie_embeddings
             else params["head"])
    loss = L.chunked_ce_loss(hidden, table, batch["labels"],
                             batch.get("loss_mask"), chunk=cfg.loss_chunk)
    return loss + cfg.moe_aux_weight * aux


# ----------------------------------------------------------------- serving --
def logits_fn(cfg, params, hidden):
    table = (params["embed"]["table"] if cfg.tie_embeddings
             else params["head"])
    return torch.einsum("bsd,vd->bsv", hidden.float(), table.float())


def cache_defs(cfg, batch: int, cache_len: int):
    """Per-layer decode caches: ``{"attn": [layer's cache defs, ...]}``."""
    _dense_only(cfg)
    return {"attn": [attn_cache_defs(cfg, batch, cache_len)
                     for _ in range(cfg.n_layers)]}


@torch.no_grad()
def decode_step(cfg, params, cache, tokens, pos: int):
    """One decode step. tokens: (B, 1) int; pos: int (synchronized
    batch).  Returns (logits (B, 1, V) float32, cache); the cache's k/v
    tensors are updated in place."""
    _dense_only(cfg)
    x = _embed(cfg, params, tokens)
    new = []
    for bp, sl in zip(params["blocks"], cache["attn"]):
        h, new_sl = apply_attn_decode(
            L.apply_norm(x, bp["ln1"], cfg.norm), bp["attn"], cfg,
            cache=sl, layer_pos=pos)
        x = x + h
        y = L.apply_mlp(L.apply_norm(x, bp["ln2"], cfg.norm), bp["mlp"],
                        cfg.act)
        x = x + y
        new.append({name: t.to(sl[name].dtype) for name, t in new_sl.items()})
    x = L.apply_norm(x, params["ln_f"], cfg.norm)
    return logits_fn(cfg, params, x), {"attn": new}


@torch.no_grad()
def prefill(cfg, params, batch, cache_len: int):
    """Process a full prompt, returning (last-token logits, decode cache)."""
    _dense_only(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = torch.arange(s, device=x.device).expand(b, s)
    caches = []
    for bp in params["blocks"]:
        x, (k, v) = apply_block(x, bp, cfg, positions=positions)
        caches.append(_to_cache(cfg, k, v, s, cache_len))
    x = L.apply_norm(x, params["ln_f"], cfg.norm)
    return logits_fn(cfg, params, x[:, -1:]), {"attn": caches}


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

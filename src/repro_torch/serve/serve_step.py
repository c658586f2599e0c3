"""Serving entry points: prefill + decode step builders.

Counterpart of the reference's ``repro/serve/serve_step.py``.
``make_prefill``/``make_decode_step`` close over (cfg, cache_len); the
reference's launcher jits them, the port runs them eagerly.  Decode
carries an ``int`` ``pos`` (synchronized batched decode) and updates the
cache's k/v tensors in place.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer


def make_prefill(cfg, cache_len: int):
    def prefill_step(params, batch):
        logits, cache = transformer.prefill(cfg, params, batch, cache_len)
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_token, cache
    return prefill_step


def make_decode_step(cfg):
    def decode_one(params, cache, tokens, pos: int):
        logits, cache = transformer.decode_step(cfg, params, cache, tokens,
                                                pos)
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_token, cache
    return decode_one


def greedy_generate(cfg, params, prompt, max_new: int, cache_len: int):
    """Prefill + ``max_new - 1`` greedy decode steps → (B, max_new)
    int32 tokens.  A VLM's positions count its patches first."""
    prefill_step = make_prefill(cfg, cache_len)
    decode_one = make_decode_step(cfg)
    batch = prompt if isinstance(prompt, dict) else {"tokens": prompt}
    tok, cache = prefill_step(params, batch)
    pos = batch["tokens"].shape[1] if "tokens" in batch else 0
    if cfg.family == "vlm":
        pos += cfg.vlm_patches
    toks = [tok]
    for _ in range(max_new - 1):
        tok, cache = decode_one(params, cache, tok[:, None], pos)
        toks.append(tok)
        pos += 1
    return torch.stack(toks, dim=1)

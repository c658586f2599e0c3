"""Serving driver: batched prefill + greedy decode for any decoder arch.

Counterpart of the reference's ``repro/launch/serve.py``.

    python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
        [--full] [--batch 4] [--prompt-len 32] [--max-new 16] \\
        [--attention-impl flash_pallas] [--device cpu] \\
        [--n-data 2 --n-model 2]

The weights are the config's published shapes (``--full``; the reduced
CPU-sized config otherwise) initialised from ``--seed``, as the
reference does; no checkpoint is read.  A VLM's prompt is its
``vlm_patches`` patch embeddings (drawn from the same seeded generator)
before the tokens, and its cache and positions count them.  An
encoder-only arch does not decode and is refused.  ``attention_impl`` sets the
config field both packages share (``flash_pallas`` runs the CUDA flash
kernel in every prefill layer, ``flash_jnp`` the chunked torch path).
Times are CUDA events on the card (the host clock on the CPU): one
warm-up prefill and decode step, then the best of ``repeats`` passes,
each with a fresh prefill because decode consumes the cache.

``--n-data``/``--n-model`` above 1 serve on a ``(data, model)`` mesh
(``models/parallel.py``): ``n_data × n_model`` CPU shards with
``--device cpu``, else the visible GPUs cycled (one card: ``cuda:0`` ×
n).  The weights are made on one device and split onto the mesh, the
prompt is split over ``data``, and the print says how many flash
launches and collectives one prefill took.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

import repro_torch.configs as C
from repro_torch.api.attention import (attention_cache_stats,
                                       attention_program_for)
from repro_torch.core.device import Timer, resolve_device
from repro_torch.core.distributed import collective_counts, reset_collectives
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.launch.mesh import device_summary, lm_mesh
from repro_torch.models import transformer
from repro_torch.models.parallel import MeshModel, mesh_defs
from repro_torch.models.params import init_params
from repro_torch.serve import serve_step as serve


@dataclasses.dataclass
class ServeRun:
    """What one :func:`run` measured; times are on ``device``'s clock."""
    tokens: torch.Tensor          # (batch, max_new) int32
    prefill_ms: float             # best of ``repeats``
    decode_ms: float              # best of ``repeats``, all decode steps
    decode_steps: int
    decode_tok_per_s: float
    kernel_launches_per_prefill: int   # CUDA flash kernel launches
    peak_bytes: int               # device memory high-water mark (cuda)
    device: str
    collectives_per_prefill: dict  # {name: {axes: calls}} on a mesh


def run(arch: str, *, batch: int = 4, prompt_len: int = 32,
        max_new: int = 16, reduced: bool = True, n_data: int = 1,
        n_model: int = 1, seed: int = 0, repeats: int = 3, device=None,
        attention_impl: str | None = None) -> ServeRun:
    cfg = C.get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if cfg.family == "encoder":
        raise ValueError(f"{arch} is encoder-only: encoder-only archs do "
                         "not decode")
    if attention_impl is not None:
        cfg = dataclasses.replace(cfg, attention_impl=attention_impl)
    device = resolve_device(device)
    mesh = lm_mesh(n_data, n_model, device)
    if mesh is not None:
        cfg = cfg.with_mesh(mesh)
        mesh_defs(cfg, mesh)     # a refused layout fails before init
    if cfg.attention_impl != "boundary_stub":    # inlined, not compiled
        attention_program_for(cfg)   # a bad attention_impl fails before init
    gen = torch.Generator(device=device).manual_seed(seed)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params = init_params(transformer.build_model(cfg, device), gen)
    if mesh is not None:
        params = MeshModel(cfg, mesh, params)
    patches = cfg.vlm_patches if cfg.family == "vlm" else 0
    cache_len = prompt_len + max_new + patches + 8
    prompt = {"tokens": torch.randint(0, cfg.vocab, (batch, prompt_len),
                                      generator=gen, device=device)}
    if patches:
        prompt["patches"] = torch.randn(
            (batch, patches, cfg.vlm_patch_dim), generator=gen,
            device=device).to(cfg.activ_dtype)

    prefill = serve.make_prefill(cfg, cache_len)
    decode = serve.make_decode_step(cfg)
    pos = prompt_len + patches
    # warm-up: the first calls pay the kernel build and allocator growth
    before = flash_attention_fwd.launches
    reset_collectives()
    tok, cache = prefill(params, prompt)
    launches = flash_attention_fwd.launches - before
    collectives = collective_counts()
    tok, cache = decode(params, cache, tok[:, None], pos)

    t_prefill = t_decode = float("inf")
    for _ in range(max(1, repeats)):
        with Timer(device) as t:
            tok, cache = prefill(params, prompt)
        t_prefill = min(t_prefill, t.ms)
        toks = [tok]
        with Timer(device) as t:
            for i in range(max_new - 1):
                tok, cache = decode(params, cache, tok[:, None], pos + i)
                toks.append(tok)
        t_decode = min(t_decode, t.ms)
    out = torch.stack(toks, dim=1)
    steps = max_new - 1
    tok_s = steps * batch / max(t_decode * 1e-3, 1e-12)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    print(f"[serve] {arch}: prefill {batch}x{prompt_len} in "
          f"{t_prefill:.3f}ms; {steps} decode steps in {t_decode:.3f}ms "
          f"({tok_s:.1f} tok/s, best of {max(1, repeats)}) on "
          + (f"a ({n_data}, {n_model}) mesh of "
             f"{device_summary(mesh.devices.flat)}" if mesh is not None
             else str(device)), flush=True)
    stats = attention_cache_stats()["attention_programs"]
    print(f"[serve] attention programs: {stats['size']} compiled, "
          f"{stats['hits']} cache hits; flash kernel launches per "
          f"prefill: {launches}; collectives per prefill: "
          f"{sum(n for d in collectives.values() for n in d.values())} "
          f"{json.dumps(collectives)}", flush=True)
    return ServeRun(tokens=out, prefill_ms=t_prefill, decode_ms=t_decode,
                    decode_steps=steps, decode_tok_per_s=tok_s,
                    kernel_launches_per_prefill=launches, peak_bytes=peak,
                    device=str(device), collectives_per_prefill=collectives)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--n-data", type=int, default=1)
    ap.add_argument("--n-model", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--attention-impl", default=None,
                    choices=["flash_jnp", "flash_pallas"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    run(args.arch, batch=args.batch, prompt_len=args.prompt_len,
        max_new=args.max_new, reduced=not args.full, n_data=args.n_data,
        n_model=args.n_model, seed=args.seed, repeats=args.repeats,
        device=args.device, attention_impl=args.attention_impl)


if __name__ == "__main__":
    main()

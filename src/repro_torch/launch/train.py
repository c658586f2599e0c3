"""End-to-end trainer: ``--arch <id> --steps N``, with crash restart.

Counterpart of the reference's ``repro/launch/train.py``.

    python -m repro_torch.launch.train --arch h2o-danube-1.8b --steps 2 \\
        --batch 2 --seq 32 --device cpu
    python -m repro_torch.launch.train --arch h2o-danube-1.8b --full \\
        --steps 3 --batch 2 --seq 8192 --attention-impl flash_pallas

Weights and optimizer state start from ``--seed`` (or the newest
checkpoint with ``--resume auto``); batches are ``train/data.py``'s
deterministic (seed, step) batches, prefetched on a host thread; every
``--ckpt-every`` steps an async checkpoint is written, and the last step
is saved blocking.  The LR schedule's horizon is ``schedule_steps``
(default ``steps``), so a run cut short and resumed follows the same
schedule.  It runs on the card unless ``--device cpu``.  ``--n-data``
and ``--n-model`` above 1 train on a ``(data, model)`` mesh
(``models/parallel.py``): ``n_data × n_model`` CPU shards with
``--device cpu``, else the visible GPUs cycled (one card: ``cuda:0`` ×
n).  The weights are made on one device from ``--seed`` and split onto
the mesh, so a mesh run starts from the unsharded run's weights; a
checkpoint is mesh-independent, so ``--resume auto`` continues on
another mesh than the one that wrote it (elastic restore).
Reports per step the loss, LR and gradient norm; at the end the step
time (CUDA events on the card, the host clock on the CPU; the first
step, which builds the kernels, is left out when there are others),
tokens per second and peak device memory.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

import repro_torch.configs as C
from repro_torch.api.attention import attention_program_for
from repro_torch.core.device import Timer, resolve_device
from repro_torch.launch.mesh import device_summary, lm_mesh
from repro_torch.models import transformer
from repro_torch.models.parallel import MeshModel, mesh_defs
from repro_torch.models.params import init_params
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.data import Prefetcher
from repro_torch.train.train_step import make_train_step


def reduced_shapes(cfg, batch: int, seq: int) -> dict:
    """The input shapes of a ``batch`` × ``seq`` run, in the reference's
    order: frames, mask and labels for the encoder; tokens and labels,
    and for the VLM ``vlm_patches`` patches besides."""
    if cfg.family == "encoder":
        return {"frames": (batch, seq, cfg.d_model), "mask": (batch, seq),
                "labels": (batch, seq)}
    out = {"tokens": (batch, seq), "labels": (batch, seq)}
    if cfg.family == "vlm":
        out["patches"] = (batch, cfg.vlm_patches, cfg.vlm_patch_dim)
    return out


@dataclasses.dataclass
class TrainStats:
    """What one :func:`train` measured, on ``device``'s clock."""
    step_ms: float                # mean over the timed steps
    tokens_per_s: float
    peak_bytes: int               # device memory high-water mark (cuda)
    timed_steps: int
    device: str
    losses: list                  # every step's loss
    grad_norms: list              # every step's global gradient norm


def train(arch: str, *, steps: int = 100, batch: int = 8, seq: int = 128,
          reduced: bool = True, ckpt_dir: str | None = None,
          ckpt_every: int = 50, resume: str = "auto", seed: int = 0,
          n_data: int = 1, n_model: int = 1, lr: float = 3e-4,
          log_every: int = 10, schedule_steps: int | None = None,
          device=None, attention_impl: str | None = None):
    """Train ``arch`` for ``steps`` steps (counted from 0, so a resumed
    run does ``steps - start``).  Returns ``(params, state, losses)``
    and sets ``train.last_stats`` to a :class:`TrainStats`."""
    cfg = C.get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if attention_impl is not None:
        cfg = dataclasses.replace(cfg, attention_impl=attention_impl)
    device = resolve_device(device)
    mesh = lm_mesh(n_data, n_model, device)
    if mesh is not None:
        cfg = cfg.with_mesh(mesh)
        mesh_defs(cfg, mesh)     # a refused layout fails before init
    if cfg.attention_impl != "boundary_stub":    # inlined, not compiled
        attention_program_for(cfg)   # a bad attention_impl fails before init
    horizon = schedule_steps or steps   # keep LR schedule invariant across
    ocfg = opt.OptConfig(lr=lr,          # crash-restart runs of one job
                         warmup=min(20, horizon // 10 + 1),
                         total_steps=horizon, schedule=cfg.schedule)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    start = 0
    if ckpt_dir and resume == "auto" and (s := ckpt.latest_step(ckpt_dir)):
        params = (MeshModel(cfg, mesh) if mesh is not None
                  else transformer.build_model(cfg, device))
        tree = ckpt.restore(ckpt_dir, s, {"params": params,
                                          "opt": opt.init_state(params)})
        state = tree["opt"]
        start = s
        print(f"[train] resumed step {s} from {ckpt_dir}", flush=True)
    else:
        params = init_params(transformer.build_model(cfg, device),
                             torch.Generator(device=device).manual_seed(seed))
        if mesh is not None:
            params = MeshModel(cfg, mesh, params)
        state = opt.init_state(params)

    step_fn = make_train_step(cfg, ocfg)
    pf = Prefetcher(cfg, "train_4k", start_step=start, seed=seed,
                    reduced_shapes=reduced_shapes(cfg, batch, seq),
                    device=device)
    losses, gnorms, times = [], [], []
    t0 = time.time()
    try:
        for i in range(start, steps):
            step_idx, b = pf.next()
            assert step_idx == i
            with Timer(device) as clock:
                params, state, metrics = step_fn(params, state, b)
            times.append(clock.ms)
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["grad_norm"]))
            if i % log_every == 0 or i == steps - 1:
                print(f"[train] step {i} loss {losses[-1]:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {gnorms[-1]:.3f} "
                      f"({times[-1]:.1f} ms; {time.time() - t0:.1f}s)",
                      flush=True)
            if ckpt_dir and (i + 1) % ckpt_every == 0:
                ckpt.save(ckpt_dir, i + 1, {"params": params, "opt": state})
    finally:
        pf.close()
        ckpt.wait()
    if ckpt_dir:
        ckpt.save(ckpt_dir, steps, {"params": params, "opt": state},
                  block=True)
    timed = times[1:] if len(times) > 1 else times
    step_ms = sum(timed) / len(timed) if timed else float("nan")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    train.last_stats = TrainStats(
        step_ms=step_ms, tokens_per_s=batch * seq / (step_ms * 1e-3),
        peak_bytes=peak, timed_steps=len(timed), device=str(device),
        losses=losses, grad_norms=gnorms)
    where = (f"a ({n_data}, {n_model}) mesh of "
             f"{device_summary(mesh.devices.flat)}" if mesh is not None
             else str(device))
    print(f"[train] {arch}: {len(timed)} timed steps of {batch}x{seq} "
          f"tokens: {step_ms:.1f} ms/step, "
          f"{train.last_stats.tokens_per_s:.1f} tok/s, peak "
          f"{peak / 1e9:.3f} GB on {where}", flush=True)
    return params, state, losses


train.last_stats = None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="use the full (non-reduced) config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-data", type=int, default=1)
    ap.add_argument("--n-model", type=int, default=1)
    ap.add_argument("--attention-impl", default=None,
                    choices=["flash_jnp", "flash_pallas"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    _, _, losses = train(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        reduced=not args.full, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, resume=args.resume, lr=args.lr,
        seed=args.seed, n_data=args.n_data, n_model=args.n_model,
        device=args.device, attention_impl=args.attention_impl)
    if losses:
        print(f"[train] done: first-loss {losses[0]:.4f} last-loss "
              f"{losses[-1]:.4f}")


if __name__ == "__main__":
    main()

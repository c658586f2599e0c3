"""AdamW and the LR schedules (cosine, and minicpm's WSD).

Counterpart of the reference's ``repro/train/optimizer.py``.  Moments are
float32 whatever the parameters' dtype; the step clips by the global
gradient norm and then updates, in the reference's order of operations
(``adamw_update``).  Parameters are a ``ParamModule`` (or any module);
the optimizer state is ``{"m": {name: tensor}, "v": {name: tensor},
"count": 0-d int32 tensor}`` keyed by the parameters' names, which are
the reference tree's paths, so ``params_from_jax`` carries the
reference's ``m`` and ``v`` across as it carries its parameters.

The reference's ZeRO sharding of the moments (``zero_pspec``,
``opt_state_defs``'s specs) waits for LM-side sharding, ROADMAP Queue 1
item 8b: here the moments live beside the parameters on one device.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"      # cosine | wsd | constant
    stable_frac: float = 0.8      # WSD: fraction of steps at peak LR


def schedule_lr(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor), a float32
    0-d tensor computed in float32 as the reference computes it."""
    step = torch.as_tensor(step).float()
    f32 = torch.float32
    warm = torch.clamp((step + 1) / max(1, cfg.warmup), max=1.0)
    if cfg.schedule == "constant":
        return torch.tensor(cfg.lr, dtype=f32) * warm
    frac = torch.clamp((step - cfg.warmup)
                       / max(1, cfg.total_steps - cfg.warmup), 0.0, 1.0)
    if cfg.schedule == "wsd":
        # warmup -> stable plateau -> 1-sqrt decay (minicpm, arXiv:2404.06395)
        decay_frac = torch.clamp((frac - cfg.stable_frac)
                                 / max(1e-6, 1 - cfg.stable_frac), 0.0, 1.0)
        return cfg.lr * warm * (1.0 - (1 - 0.1) * torch.sqrt(decay_frac))
    cos = 0.5 * (1 + torch.cos(torch.tensor(math.pi, dtype=f32) * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_state(model: torch.nn.Module) -> dict:
    """Zero moments (float32, shaped and placed like each parameter) and
    a zero step count."""
    m = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
         for n, p in model.named_parameters()}
    v = {n: torch.zeros_like(t) for n, t in m.items()}
    dev = next(model.parameters()).device
    return {"m": m, "v": v,
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads))


@torch.no_grad()
def adamw_update(cfg: OptConfig, model: torch.nn.Module, grads: dict,
                 state: dict) -> tuple[dict, dict]:
    """One clipped AdamW step: ``grads`` maps each parameter name to its
    gradient (any float dtype).  The parameters are updated in place
    (rounded to their dtype once), as are the moments; returns
    ``(state, {"lr", "grad_norm"})`` with the count advanced."""
    step = state["count"]
    lr = schedule_lr(cfg, step)
    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.betas
    t = (step + 1).float()
    corr = torch.sqrt(1 - b2 ** t) / (1 - b1 ** t)
    for name, p in model.named_parameters():
        m, v = state["m"][name], state["v"][name]
        g32 = grads[name].float() * scale
        m.copy_(b1 * m + (1 - b1) * g32)
        v.copy_(b2 * v + (1 - b2) * g32 * g32)
        delta = corr * m / (torch.sqrt(v) + cfg.eps)
        p.copy_((p.float() * (1 - lr * cfg.weight_decay) - lr * delta)
                .to(p.dtype))
    state["count"] = step + 1
    return state, {"lr": lr, "grad_norm": gnorm}

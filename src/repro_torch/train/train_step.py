"""train_step: microbatched (gradient-accumulation) loss, grads, update.

Counterpart of the reference's ``repro/train/train_step.py``.  With
``cfg.microbatches > 1`` the global batch is cut into that many slices
along the batch dim; each slice's gradients (in the parameters' dtype,
from ``torch.autograd.grad``) are added into float32 buffers, never into
``.grad`` in the parameters' dtype, and one AdamW update follows the
last slice, as the reference's ``lax.scan`` accumulates in float32.

On a mesh (``params`` a ``parallel.MeshModel``) each microbatch is split
over the DP axes inside the model, every shard's gradients accumulate in
float32, and once a step the copies of each replicated leaf are summed
over the axes it is replicated on (``parallel.replica_grads``, one
counted ``psum`` a leaf); the leaves split over every axis keep theirs.
The ZeRO-sharded AdamW update follows (``train/optimizer.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.attention import attention_program_for
from repro_torch.models import parallel, transformer
from repro_torch.train import optimizer as opt


def shift_labels(batch):
    """Next-token targets from tokens when labels are the same sequence:
    labels shift left by one, and the last position is masked out."""
    if "tokens" in batch and "labels" in batch:
        lab = batch["labels"]
        mask = torch.ones(lab.shape, dtype=torch.float32, device=lab.device)
        mask[:, -1] = 0.0
        batch = dict(batch)
        batch["labels"] = torch.cat([lab[:, 1:], lab[:, -1:]], dim=1)
        batch["loss_mask"] = mask
    return batch


def loss_fn(cfg, params, batch):
    return transformer.train_loss(cfg, params, shift_labels(batch))


def make_train_step(cfg, ocfg: opt.OptConfig):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; ``params`` (a ``ParamModule``) and the state's
    tensors are updated in place and returned.  Metrics are 0-d float32
    tensors: ``loss``, ``lr``, ``grad_norm``."""
    n_micro = max(1, cfg.microbatches)
    # resolve the attention program once, so a bad head/chunk layout or
    # attention_impl fails here, not inside the first step (the dry
    # run's boundary_stub is inlined by the model, not compiled)
    if cfg.attention_impl != "boundary_stub":
        attention_program_for(cfg, causal=True)

    def grads_of(loss, leaves):
        # a leaf the loss does not reach gets a zero gradient, as in jax
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, gs)]

    def mesh_step(mm, opt_state, batch):
        shards = mm.leaves()
        keys = [(n, c) for n, a in shards.items() for c in np.ndindex(
            *a.shape)]
        leaves = [shards[n][c] for n, c in keys]
        b = next(iter(batch.values())).shape[0] // n_micro
        acc, tot = {}, 0.0
        for i in range(n_micro):
            mb = {k: x[i * b:(i + 1) * b] for k, x in batch.items()}
            loss = loss_fn(cfg, mm, mb)
            for key, g in zip(keys, grads_of(loss, leaves)):
                acc[key] = g.float() if i == 0 else acc[key] + g.float()
            tot = tot + loss.detach()
        grads = {}
        for n, a in shards.items():
            grads[n] = np.empty(a.shape, dtype=object)
            for c in np.ndindex(*a.shape):
                grads[n][c] = acc.pop((n, c)).div_(n_micro)
        grads = parallel.replica_grads(mm, grads)
        opt_state, stats = opt.adamw_update(ocfg, mm, grads, opt_state)
        return mm, opt_state, {"loss": tot / n_micro, **stats}

    def train_step(params, opt_state, batch):
        if isinstance(params, parallel.MeshModel):
            return mesh_step(params, opt_state, batch)
        names, leaves = zip(*params.named_parameters())
        if n_micro == 1:
            loss = loss_fn(cfg, params, batch)
            grads = dict(zip(names, grads_of(loss, leaves)))
            loss = loss.detach()
        else:
            b = next(iter(batch.values())).shape[0] // n_micro
            acc = {n: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                   for n, p in zip(names, leaves)}
            tot = torch.zeros((), dtype=torch.float32)
            for i in range(n_micro):
                mb = {k: x[i * b:(i + 1) * b] for k, x in batch.items()}
                loss = loss_fn(cfg, params, mb)
                for n, g in zip(names, grads_of(loss, leaves)):
                    acc[n] += g.float()
                tot = tot.to(loss.device) + loss.detach()
            grads = {n: g / n_micro for n, g in acc.items()}
            loss = tot / n_micro
        opt_state, stats = opt.adamw_update(ocfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **stats}

    return train_step

"""Gradient compression for the cross-pod reduction: an int8 all-reduce.

Counterpart of the reference's ``repro/train/compress.py``.  The
``pod`` axis of the production mesh crosses the data-center network, an
order of magnitude slower than the links inside a pod, so the once-a-step
gradient all-reduce over it is the one collective worth compressing:

    q = clip(round_sr(x / scale), -127, 127)      scale = max|x| / 127
    y = psum(q) · scale                           psum on int32

Stochastic rounding keeps the estimator unbiased (E[q·scale] = x), so
SGD converges as it does uncompressed, in expectation; the wire carries
1 byte a gradient instead of 4 (float32) or 2 (bf16).  The shards share
one scale, the ``pmax`` of theirs, so the sum stays linear, and the
integer codes are summed as int32 so 127 × n cannot overflow.

The reference draws its rounding from ``jax.random`` keys folded with
the shard's index; here each shard draws from its own explicit
``torch.Generator`` (:func:`shard_generators`), so the bits differ from
the reference's and the port is held to its contracts instead: the
error of one sum within ``n · max|x| / 127``, no bias over many draws,
and data-parallel SGD through it converging (``tests/
test_torch_compress.py``).  Shards are a single-process mesh's
(``core/distributed.py``): the ``psum`` and ``pmax`` are its counted
collectives.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distributed import _axes, pmax, psum, smap
from repro_torch.models.params import NamedSharding


def shard_generators(mesh, seed: int) -> np.ndarray:
    """One ``torch.Generator`` per mesh position, on its device, seeded
    from ``seed`` and the position's flat index, so no two shards draw
    the same rounding."""
    out = np.empty(mesh.devices.shape, dtype=object)
    for i, c in enumerate(np.ndindex(*out.shape)):
        out[c] = torch.Generator(device=mesh.devices[c]).manual_seed(
            int(seed) * 65_537 + i)
    return out


def _stochastic_round(x, generator):
    lo = torch.floor(x)
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return lo + (u < x - lo).to(x.dtype)


def _scale(x) -> torch.Tensor:
    return torch.clamp(x.abs().max().float(), min=1e-30) / 127.0


def quantize_int8(x, generator):
    """x → (int8 codes, float32 scale), unbiased under stochastic
    rounding."""
    scale = _scale(x)
    q = _stochastic_round(x.float() / scale, generator)
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize(q, scale):
    return q.float() * scale


def compressed_psum(xs: np.ndarray, ax, mesh, generators: np.ndarray):
    """Quantized all-reduce of mesh-shaped ``xs`` over ``ax``: the
    shards' scales ``pmax``ed, int8 codes summed as int32 (``psum``) →
    the float32 sum on every member."""
    scales = pmax(smap(_scale, xs), ax, mesh)
    qs = smap(lambda x, s, g: torch.clamp(_stochastic_round(
        x.float() / s, g), -127, 127).to(torch.int8), xs, scales, generators)
    totals = psum(smap(lambda q: q.to(torch.int32), qs), ax, mesh)
    return smap(lambda t, s: t.float() * s, totals, scales)


def compressed_psum_tree(tree: dict, ax, mesh, generators: np.ndarray):
    """:func:`compressed_psum` leaf by leaf, each with its own scales."""
    return {k: compressed_psum(v, ax, mesh, generators)
            for k, v in tree.items()}


def make_compressed_allreduce_step(loss_fn, mesh, axis_name="data",
                                   lr: float = 1e-2):
    """A data-parallel SGD step with the int8 all-reduce of the gradients
    — the pattern the trainer would slot in for the ``pod`` axis.

        step = make_compressed_allreduce_step(loss_fn, mesh, "data", 0.05)
        params = step(params, (X, Y), seed)

    ``params`` is a dict of tensors, replicated on every shard; the
    batch's tensors are split along dim 0 over ``axis_name``; ``seed``
    seeds the shards' rounding.  Returns the updated parameters: the
    reduced gradient is the same on every shard, so the update is made
    once, from the first position's."""
    n = int(np.prod([mesh.shape[a] for a in _axes(axis_name)]))
    split = NamedSharding(mesh, (axis_name,))
    whole = NamedSharding(mesh, ())

    def step(params: dict, batch, seed: int) -> dict:
        ps = {k: smap(lambda t: t.requires_grad_(True), whole.split(v))
              for k, v in params.items()}
        bs = [split.split(t) for t in batch]
        grads = {k: np.empty(mesh.devices.shape, dtype=object) for k in ps}
        for c in np.ndindex(*mesh.devices.shape):
            local = {k: v[c] for k, v in ps.items()}
            loss = loss_fn(local, tuple(b[c] for b in bs))
            for k, g in zip(local, torch.autograd.grad(
                    loss, list(local.values()))):
                grads[k][c] = g
        grads = compressed_psum_tree(grads, axis_name, mesh,
                                     shard_generators(mesh, seed))
        first = next(np.ndindex(*mesh.devices.shape))
        return {k: (ps[k][first] - lr * (grads[k][first] / n)
                    .to(ps[k][first].dtype)).detach() for k in ps}

    return step



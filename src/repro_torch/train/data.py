"""Synthetic deterministic data pipeline.

Counterpart of the reference's ``repro/train/data.py``.  Every batch is
a pure function of (seed, step), drawn with the reference's own
``np.random.RandomState`` recipe, input by input in the same order, so
the port trains on the reference's exact batches (tokens, and the
encoder's frames and mask and the VLM's patches); they are handed over
as tensors on the requested device.  A restarted run regenerates any step's batch with no
coordination.  :class:`Prefetcher` keeps ``prefetch`` batches in flight
on a host thread.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.configs.base import SHAPES


def train_shapes(cfg, shape_name: str) -> dict:
    """The input shapes of a training cell of ``SHAPES`` (the
    reference's ``input_specs`` for ``kind == "train"``, in its order):
    frames, mask and labels for the encoder; tokens, patches and labels
    (the sequence less the patches) for the VLM; tokens and labels
    otherwise."""
    info = SHAPES[shape_name]
    if info["kind"] != "train":
        raise ValueError(f"{shape_name} is not a training cell")
    b, s = info["batch"], info["seq"]
    if cfg.family == "encoder":
        return {"frames": (b, s, cfg.d_model), "mask": (b, s),
                "labels": (b, s)}
    if cfg.family == "vlm":
        st = s - cfg.vlm_patches
        return {"tokens": (b, st),
                "patches": (b, cfg.vlm_patches, cfg.vlm_patch_dim),
                "labels": (b, st)}
    return {"tokens": (b, s), "labels": (b, s)}


def batch_for_step(cfg, shape_name: str, step: int, seed: int = 0,
                   reduced_shapes=None, device=None) -> dict:
    """The deterministic synthetic batch of ``step``, drawn input by
    input in the order of the shapes, as the reference draws it: noisy
    arithmetic token sequences (next = cur + 1, 5 % replaced at random),
    int32, for ``tokens`` and ``labels`` (labels equal to the tokens
    where both are drawn: the next-token shift is the train step's); a
    bool ``mask`` of 15 % of the frames; standard normal ``frames`` and
    ``patches``, in ``cfg.activ_dtype`` for a cell of ``SHAPES`` and in
    float32 for ``reduced_shapes`` (a map of each input name to its
    shape), as the reference's ``input_specs`` and
    ``launch/train.reduced_shapes`` type them."""
    specs = (train_shapes(cfg, shape_name) if reduced_shapes is None
             else reduced_shapes)
    floats = cfg.activ_dtype if reduced_shapes is None else torch.float32
    rng = np.random.RandomState((seed * 1_000_003 + step) % (2**31 - 1))
    out = {}
    for k, shape in specs.items():
        if k in ("tokens", "labels"):
            b, s = shape
            offs = rng.randint(0, cfg.vocab, size=(b, 1))
            seqs = (offs + np.arange(s)[None, :]) % cfg.vocab
            noise = rng.rand(b, s) < 0.05
            seqs = np.where(noise, rng.randint(0, cfg.vocab, size=(b, s)),
                            seqs)
            out[k] = torch.from_numpy(seqs.astype(np.int32))
        elif k == "mask":
            out[k] = torch.from_numpy(rng.rand(*shape) < 0.15)
        else:
            out[k] = torch.from_numpy(rng.randn(*shape)).to(floats)
    if "tokens" in out and "labels" in out:
        out["labels"] = out["tokens"]          # LM: next-token via shift
    return {k: v.to(device) for k, v in out.items()}


class Prefetcher:
    """Background-thread batch producer: overlaps making the next batches
    with the device's work on this one."""

    def __init__(self, cfg, shape_name: str, start_step: int = 0,
                 seed: int = 0, prefetch: int = 2, reduced_shapes=None,
                 device=None):
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()

        def worker():
            step = start_step
            while not self._stop.is_set():
                b = batch_for_step(cfg, shape_name, step, seed,
                                   reduced_shapes)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, b), timeout=0.2)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._device = device
        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def next(self):
        step, b = self._q.get()
        return step, {k: v.to(self._device) for k, v in b.items()}

    def close(self):
        self._stop.set()
        self._t.join()

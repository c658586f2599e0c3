"""Checkpoints: one ``.npy`` per leaf + ``manifest.json``, atomic, async.

Counterpart of the reference's ``repro/train/checkpoint.py``:

  * a checkpoint is a directory ``step_<N>/`` holding one ``.npy`` per
    leaf of the saved tree (keyed by its path: ``params/blocks.0.attn.wq``,
    ``opt/m/...``, ``opt/count``) and ``manifest.json`` (step, leaf files,
    dtypes; bfloat16 leaves are stored as their int16 bits);
  * a save writes ``step_<N>.tmp<id>/`` and renames it into place, so a
    crash mid-save never leaves a half-written ``step_<N>`` for
    :func:`latest_step` to find, and a corrupt or unreadable manifest
    makes its checkpoint invisible to :func:`latest_step` and refused by
    :func:`restore`;
  * a save is async: the caller blocks only for the host copy of the
    tree, and a thread writes the files.

Unlike the reference, writers never overlap: one lock serialises them
in the process, and ``save(block=True)`` (and :func:`wait`) joins every
pending writer first.  In the reference a still-running async save of
step N can remove and replace ``step_N`` after a blocking save of the
same step has returned, so a restore right after it can find leaves
missing.

Checkpoints are mesh-independent: ``save`` gathers every leaf of a
``parallel.MeshModel`` and every ``Sharded`` moment whole, and
``restore`` splits each onto whatever mesh the ``like`` tree is placed
on — the elastic restore of the reference's ``shardings=`` (write on
one device, resume on a ``(2, 1)`` mesh, or the other way round).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from repro_torch.models.params import Sharded
from repro_torch.models.parallel import MeshModel

_write_lock = threading.Lock()      # one writer at a time
_pending: list[threading.Thread] = []
_pending_lock = threading.Lock()
_STEP_DIR = re.compile(r"^step_(\d+)$")


def _flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, torch.nn.Module):
        return {f"{prefix}{n}": p for n, p in tree.named_parameters()}
    if isinstance(tree, MeshModel):
        return {f"{prefix}{n}": Sharded(s, tree.shardings[n], tree.flat[n]
                                        .shape)
                for n, s in tree.leaves().items()}
    if isinstance(tree, Sharded):
        return {prefix[:-1]: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: torch.as_tensor(tree)}


def _to_numpy(t) -> tuple[np.ndarray, str]:
    t = (t.gather("cpu").detach() if isinstance(t, Sharded)
         else t.detach().to("cpu", copy=True))
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy(), name


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def wait() -> None:
    """Join every pending async writer of this process."""
    while True:
        with _pending_lock:
            threads = list(_pending)
        if not threads:
            return
        for t in threads:
            t.join()


def save(ckpt_dir: str, step: int, tree, *, block: bool = False):
    """Persist ``tree`` (parameter modules, dicts of tensors, 0-d counts)
    at ``step``; async unless ``block``.  The tree is copied to the host
    before this returns, so the caller may update it in place at once."""
    if block:
        wait()
    host = {k: _to_numpy(v) for k, v in _flatten(tree).items()}

    def write():
        with _write_lock:
            tmp = os.path.join(ckpt_dir,
                               f"step_{step}.tmp{threading.get_ident()}")
            final = os.path.join(ckpt_dir, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
            names, dtypes = {}, {}
            for i, (k, (arr, dt)) in enumerate(host.items()):
                np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
                names[k], dtypes[k] = f"leaf_{i}.npy", dt
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "leaves": names, "dtypes": dtypes},
                          f)
            old = f"{final}.old{threading.get_ident()}"
            if os.path.isdir(final):
                os.rename(final, old)
            os.rename(tmp, final)
            shutil.rmtree(old, ignore_errors=True)

    def run():
        try:
            write()
        finally:
            with _pending_lock:
                _pending.remove(t)

    t = threading.Thread(target=run, daemon=True)
    with _pending_lock:
        _pending.append(t)
    t.start()
    if block:
        t.join()
    return t


def _readable_manifest(path: str) -> bool:
    """True when ``path`` parses as a checkpoint manifest: a truncated or
    garbage ``manifest.json`` must make its checkpoint invisible, not
    crash the resume."""
    try:
        with open(path) as f:
            m = json.load(f)
        return isinstance(m, dict) and "leaves" in m
    except (OSError, ValueError):
        return False


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := _STEP_DIR.match(d))
             and _readable_manifest(os.path.join(ckpt_dir, d,
                                                 "manifest.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like_tree):
    """Load ``step`` into the structure of ``like_tree``: a module's
    parameters (a ``MeshModel``'s shards) are overwritten in place, a
    ``Sharded`` leaf becomes a new one split as the ``like`` leaf is, a
    dict a new dict of tensors in each ``like`` leaf's dtype and on its
    device.  A corrupt or unreadable manifest raises ``ValueError``
    (resume via ``latest_step`` never selects one)."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise ValueError(
            f"checkpoint step_{step} has no readable manifest ({e}); "
            "it is corrupt or was never finalized — pick a step from "
            "latest_step(), which skips such checkpoints") from e
    if not isinstance(manifest, dict) or "leaves" not in manifest:
        raise ValueError(
            f"checkpoint step_{step} manifest is not a leaves table; "
            "the checkpoint is corrupt")
    dtypes = manifest.get("dtypes", {})

    def load(key, shape, dtype, device):
        arr = np.load(os.path.join(d, manifest["leaves"][key]))
        t = _from_numpy(arr, dtypes.get(key, ""))
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"checkpoint step_{step} leaf {key}: shape "
                             f"{tuple(t.shape)}, expected {tuple(shape)}")
        return t.to(dtype=dtype, device=device)

    def build(node, prefix):
        if isinstance(node, torch.nn.Module):
            with torch.no_grad():
                for n, p in node.named_parameters():
                    p.copy_(load(f"{prefix}{n}", p.shape, p.dtype, p.device))
            return node
        if isinstance(node, MeshModel):
            node.load_state_dict({
                n: load(f"{prefix}{n}", node.flat[n].shape, s.flat[0].dtype,
                        "cpu") for n, s in node.leaves().items()})
            return node
        if isinstance(node, Sharded):
            return Sharded.split(load(prefix[:-1], node.shape, node.dtype,
                                      "cpu"), node.sharding)
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in node.items()}
        like = torch.as_tensor(node)
        return load(prefix[:-1], like.shape, like.dtype, like.device)

    return build(like_tree, "")

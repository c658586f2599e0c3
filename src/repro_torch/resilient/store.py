"""Atomic, checksummed, async checkpoint store for stencil campaigns
(counterpart of ``repro.resilient.store``).

One checkpoint = one directory ``leg_<k>/`` holding the carry field
(``carry.npy``) plus ``manifest.json``.  The manifest is the campaign's
identity card: the program fingerprint (spec signature, §6 plan
fingerprint, shape/dtype/boundary/depth/mode), the leg index and steps
done, a CRC-32 checksum of the payload's bytes, and the campaign
schedule (``total_t``, ``every``).  ``resume`` validates every
fingerprint field against the live program and refuses mismatches with
the fix spelled out — a checkpoint can never be silently replayed into
a different computation.

Write discipline:

  * **atomic** — everything lands in ``leg_<k>.tmp<ident>/`` first and
    is ``os.rename``d into place as the last act; a crash mid-save
    leaves a ``.tmp`` orphan that ``legs()`` never lists, so the latest
    *visible* checkpoint is always complete;
  * **async** — ``save`` copies the carry to host memory on the
    caller's thread (synchronous with the device), then hands the file
    writes to a daemon thread; the campaign loop only blocks on the
    device fetch.  ``wait()`` is the barrier (the runner calls it
    before any rollback load and at campaign end);
  * **checksummed** — ``load`` recomputes the CRC and raises
    :class:`CorruptCheckpoint` on mismatch; ``load_latest_good`` walks
    backward past corrupt legs so a flipped bit on disk costs one leg
    of recompute, not the campaign.

numpy has no bfloat16: a bf16 carry is saved as its ``uint16`` bit
pattern, with ``carry_dtype: "bfloat16"`` in the manifest, and loaded
back to the same bits.  The payload and manifest follow the reference's
layout, but checkpoints are not meant to cross between the two
packages: the fingerprints differ (the port's hardware model and device
are its own), so each package refuses the other's at resume.

    store = CampaignStore(tmpdir, keep=3)
    store.save(1, y, manifest_dict)
    store.wait()
    leg, carry, manifest, skipped = store.load_latest_good()
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch

MANIFEST = "manifest.json"
PAYLOAD = "carry.npy"

# manifest fields that must match the live program exactly at resume;
# (mesh, plan) are validated separately — they may drift together under
# the elastic-restore policy (a smaller mesh replans per shard)
STRICT_FIELDS = ("spec_signature", "shape", "dtype", "compute_dtype",
                 "boundary", "t", "mode", "hw", "kind")

_FIX = {
    "spec_signature": "compile the same tap set (define_stencil with "
                      "identical taps/cost overrides)",
    "shape": "compile_stencil(spec, shape={want}) — a checkpoint cannot "
             "be resharded onto a different domain",
    "dtype": "compile_stencil(..., dtype={want})",
    "compute_dtype": "compile_stencil(..., compute_dtype={want})",
    "boundary": "compile_stencil(..., boundary={want})",
    "t": "compile_stencil(..., t={want}) — legs are temporal-block-"
         "aligned, so the sweep depth is part of the schedule",
    "mode": "compile_stencil(..., mode={want})",
    "hw": "compile_stencil(..., hw=<{want} model>)",
    "kind": "run the {want} entry point (run_resumable vs "
            "run_sharded_resumable) the campaign was started with",
    "total_t": "call run_resumable(..., {field}={want}) — changing the "
               "step count mid-campaign would break leg alignment",
    "every": "call run_resumable(..., {field}={want}) — changing the "
             "leg width mid-campaign would break leg alignment",
    "plan": "compile the program that wrote the checkpoint (the same "
            "shape, t and hardware model), or resume with "
            "RetryPolicy(elastic=True) on the same mesh family",
    "mesh": "compile_stencil(..., mesh={want}), or resume with "
            "RetryPolicy(elastic=True) to re-place the carry onto the "
            "live mesh",
}


class CheckpointError(RuntimeError):
    """Base of the store's typed failures; ``reason`` is machine-readable."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}" + (f": {detail}" if detail else ""))
        self.reason = reason


class CorruptCheckpoint(CheckpointError):
    """The on-disk payload does not match its manifest (checksum
    mismatch, unreadable manifest, missing payload).  Recoverable: fall
    back to an earlier leg (``load_latest_good`` does)."""

    def __init__(self, detail: str = ""):
        super().__init__("corrupt_checkpoint", detail)


class ResumeMismatch(CheckpointError):
    """The checkpoint was written by a different computation than the
    live program — refused, with the fix per field spelled out."""

    def __init__(self, mismatches: list):
        self.mismatches = mismatches
        lines = []
        for field, have, want in mismatches:
            fix = _FIX.get(field, "recompile to match").format(
                want=want, field=field)
            lines.append(f"  {field}: checkpoint has {want!r}, live "
                         f"program has {have!r} — fix: {fix}")
        super().__init__(
            "resume_mismatch",
            "checkpoint does not match the live program:\n"
            + "\n".join(lines))


def checksum(arr: np.ndarray) -> int:
    """CRC-32 of the payload's raw bytes (dtype/shape are covered by the
    manifest's fingerprint fields, so the payload bytes are enough)."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def to_host(carry) -> tuple:
    """``(payload ndarray, carry dtype name)``: a copy of ``carry`` in
    host memory (a bf16 tensor as its ``uint16`` bit pattern)."""
    if isinstance(carry, np.ndarray):
        return np.array(carry, copy=True), carry.dtype.name
    t = carry.detach().to("cpu", copy=True).contiguous()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def from_host(arr: np.ndarray, dtype_name: str | None) -> torch.Tensor:
    """The carry a payload holds, as a CPU tensor (bf16 from its bits)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype_name == "bfloat16":
        return t.view(torch.int16).view(torch.bfloat16)
    return t


class CampaignStore:
    """Directory of ``leg_<k>/`` checkpoints with atomic writes, async
    serialization, checksums, and bounded retention.

    ``keep`` newest checkpoints are retained (older ones are pruned
    after each successful save) — deep rollback is bounded by design;
    a campaign that needs more history raises ``keep``.
    """

    def __init__(self, root: str, keep: int = 3):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.root = str(root)
        self.keep = keep
        self._threads: list = []
        self._lock = threading.Lock()
        os.makedirs(self.root, exist_ok=True)

    # ------------------------------------------------------------ paths ----
    def _dir(self, leg: int) -> str:
        return os.path.join(self.root, f"leg_{leg}")

    def legs(self) -> list:
        """Complete (renamed-into-place) leg indices, ascending.  ``.tmp``
        orphans from a crashed save are invisible by construction."""
        if not os.path.isdir(self.root):
            return []
        out = []
        for d in os.listdir(self.root):
            if not d.startswith("leg_") or ".tmp" in d:
                continue
            if not os.path.exists(os.path.join(self.root, d, MANIFEST)):
                continue
            try:
                out.append(int(d.split("_", 1)[1]))
            except ValueError:
                continue
        return sorted(out)

    def latest_leg(self) -> int | None:
        legs = self.legs()
        return legs[-1] if legs else None

    # ------------------------------------------------------------- save ----
    def save(self, leg: int, carry, manifest: dict, *, block: bool = False,
             sabotage: str | None = None) -> threading.Thread:
        """Checkpoint ``carry`` (a tensor on any device, or an ndarray)
        at ``leg``.

        The device fetch happens here, synchronously — the snapshot is
        consistent even if the campaign keeps overwriting buffers — and
        the file writes happen on a daemon thread (``block=True`` joins
        it, for tests and the final barrier).

        ``sabotage`` is the fault-injection seam (``repro_torch.faults``):
        ``'crash'`` abandons the ``tmp`` dir before the rename (what a
        mid-save SIGKILL leaves behind); ``'corrupt'`` flips payload
        bytes after the rename (a bad disk).  Production callers leave
        it ``None``.
        """
        host, dtype_name = to_host(carry)
        m = dict(manifest)
        m["leg"] = int(leg)
        m["checksum"] = checksum(host)
        m["payload"] = PAYLOAD
        m["carry_dtype"] = dtype_name

        def write():
            tmp = self._dir(leg) + f".tmp{threading.get_ident()}"
            final = self._dir(leg)
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
            np.save(os.path.join(tmp, PAYLOAD), host)
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump(m, f, indent=1)
            if sabotage == "crash":      # die before the atomic rename
                return
            shutil.rmtree(final, ignore_errors=True)
            try:
                os.rename(tmp, final)
            except OSError:              # concurrent save of the leg won
                shutil.rmtree(tmp, ignore_errors=True)
                return
            if sabotage == "corrupt":
                _flip_payload_bytes(os.path.join(final, PAYLOAD))
            self._prune()

        t = threading.Thread(target=write, daemon=True,
                             name=f"ckpt-leg-{leg}")
        with self._lock:
            self._threads.append(t)
        t.start()
        if block:
            t.join()
        return t

    def wait(self) -> None:
        """Barrier: join every outstanding writer (rollback loads and
        campaign completion call this first)."""
        with self._lock:
            threads, self._threads = self._threads, []
        for t in threads:
            t.join()

    def _prune(self) -> None:
        with self._lock:
            for leg in self.legs()[:-self.keep] if self.keep else []:
                shutil.rmtree(self._dir(leg), ignore_errors=True)

    # ------------------------------------------------------------- load ----
    def load(self, leg: int) -> tuple:
        """``(carry, manifest)`` for ``leg``, the carry a CPU tensor;
        raises :class:`CorruptCheckpoint` on an unreadable manifest, a
        missing payload, or a checksum mismatch."""
        d = self._dir(leg)
        try:
            with open(os.path.join(d, MANIFEST)) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise CorruptCheckpoint(
                f"leg {leg}: unreadable manifest ({e})") from e
        try:
            arr = np.load(os.path.join(d, manifest.get("payload", PAYLOAD)))
        except (OSError, ValueError) as e:
            raise CorruptCheckpoint(
                f"leg {leg}: unreadable payload ({e})") from e
        want = manifest.get("checksum")
        have = checksum(arr)
        if want != have:
            raise CorruptCheckpoint(
                f"leg {leg}: payload checksum {have} != manifest {want} "
                "(bytes changed on disk)")
        return from_host(arr, manifest.get("carry_dtype")), manifest

    def load_latest_good(self) -> tuple:
        """``(leg, carry, manifest, skipped)`` for the newest checkpoint
        that passes its checksum; corrupt newer legs are listed in
        ``skipped`` (the rollback loses their compute, nothing else).
        Raises :class:`CorruptCheckpoint` when checkpoints exist but
        none loads, and :class:`CheckpointError('no_checkpoint')` when
        the store is empty."""
        legs = self.legs()
        if not legs:
            raise CheckpointError("no_checkpoint",
                                  f"{self.root} holds no checkpoints")
        skipped = []
        for leg in reversed(legs):
            try:
                arr, manifest = self.load(leg)
            except CorruptCheckpoint as e:
                skipped.append((leg, str(e)))
                continue
            return leg, arr, manifest, skipped
        raise CorruptCheckpoint(
            f"every checkpoint in {self.root} is corrupt: "
            + "; ".join(msg for _, msg in skipped))

    # ------------------------------------------------------- validation ----
    @staticmethod
    def check_fingerprint(manifest: dict, fingerprint: dict, *,
                          total_t: int, every: int,
                          elastic: bool = True) -> list:
        """Refuse (``ResumeMismatch``) any drift between the checkpoint's
        manifest and the live program's fingerprint + schedule.  Returns
        the list of *elastic* drifts (mesh/plan) that were allowed —
        empty on an exact match; with ``elastic=False`` those refuse
        too (strict resume)."""
        mismatches, allowed = [], []
        for field in STRICT_FIELDS:
            have, want = fingerprint.get(field), manifest.get(field)
            if have != want:
                mismatches.append((field, have, want))
        for field, want in (("total_t", total_t), ("every", every)):
            if manifest.get(field) != want and want is not None:
                mismatches.append((field, want, manifest.get(field)))
        mesh_drift = manifest.get("mesh") != fingerprint.get("mesh")
        plan_drift = manifest.get("plan") != fingerprint.get("plan")
        if mesh_drift:
            (allowed if elastic else mismatches).append(
                ("mesh", fingerprint.get("mesh"), manifest.get("mesh")))
        if plan_drift and not mesh_drift:
            # same mesh but a different plan is a different computation
            # schedule on the same hardware — always refused
            mismatches.append(
                ("plan", fingerprint.get("plan"), manifest.get("plan")))
        if mismatches:
            raise ResumeMismatch(mismatches)
        return allowed


def _flip_payload_bytes(path: str, n: int = 8) -> None:
    """Corrupt ``n`` bytes in the middle of the payload (past the npy
    header, so ``np.load`` still parses and only the checksum catches
    it) — the fault-injection model of a bad disk/bit rot."""
    size = os.path.getsize(path)
    off = max(size // 2, 128)
    with open(path, "r+b") as f:
        f.seek(off)
        chunk = f.read(n)
        f.seek(off)
        f.write(bytes((b ^ 0xFF) for b in chunk))

"""Persistent plan database: measured winners, keyed and checksummed
(the port's own copy of ``repro.tuning.plandb``).

One record = one JSON file under the DB directory, named by the SHA-256
digest of its key.  The key is everything a measured plan is conditioned
on — change any component and the record is a different plan:

  * ``spec.signature`` — the tap structure + cost-model numbers (the
    same registry-free identity ``plan_bucketed`` keys on);
  * the 64-rounded shape bucket (a plan tuned at (500, 500) serves
    (512, 512) but not (1024, 1024));
  * the hardware fingerprint, ``cuda:<device name>`` or ``cpu:<processor>``
    (a plan tuned on a CPU must never serve a card);
  * the execution tier: ``native`` is the CUDA kernel; the CPU's plain
    version takes ``interpret``, the reference's name for "not the native
    kernel", so the key schema is the reference's unchanged.

The torch version is deliberately NOT part of the key: it is stored in
the record (``torch_version``) and checked at lookup, so an upgrade turns
every old record into a *stale* entry that is skipped with a warning (and
reclaimed by ``prune_stale``) instead of silently orphaning files under
dead keys.  The default directory is the port's own
(``$REPRO_TORCH_PLANDB``, else ``~/.cache/repro_torch/plandb``): the two
packages never share record files.

Write discipline is the ``resilient/store.py`` pattern: payload lands in
``<digest>.json.tmp<pid>`` and is ``os.rename``d into place as the last
act — a SIGKILL mid-save leaves a ``.tmp`` orphan that ``get`` never
reads, never a torn visible record.  Every record carries a CRC-32 of
its canonical payload; corrupt or unparseable records are a *miss with
a warning*, never an exception — a flipped bit on disk costs one
re-tune, not the front door.

Records keep the reference's ``plan`` fields; ``lazy_batch`` and
``num_buffers`` are written as 1, since the port's kernels have no such
knob.

    db = PlanDB(path)
    db.put(key, record)                      # atomic + checksummed
    rec = db.get(key)                        # None on miss/corrupt/stale
"""
from __future__ import annotations

import hashlib
import json
import os
import platform
import time
import warnings
import zlib

SCHEMA_VERSION = 1
_BUCKET = 64     # mirrors repro_torch.api.plan_bucketed's shape rounding


def _pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def default_db_path() -> str:
    """``$REPRO_TORCH_PLANDB`` when set, else
    ``~/.cache/repro_torch/plandb``."""
    env = os.environ.get("REPRO_TORCH_PLANDB")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "plandb")


def hw_fingerprint(device=None) -> str:
    """``cuda:<device name>`` of ``device`` (default: the current CUDA
    device when there is one, else the CPU), or ``cpu:<processor>``,
    spaces as ``_`` — resolved at call time (tune/tuned-compile paths),
    never at import, so importing the package initializes no CUDA."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        kind = f"cuda:{torch.cuda.get_device_name(device)}"
    else:
        kind = f"cpu:{platform.processor() or 'cpu'}"
    return kind.replace(" ", "_")


def tier_for(device) -> str:
    """``native`` for the CUDA kernel, ``interpret`` for the CPU's plain
    version (see the module docstring)."""
    import torch

    return "native" if torch.device(device).type == "cuda" else "interpret"


def torch_version() -> str:
    import torch

    return torch.__version__


def db_key(spec, shape, hw_fp: str, tier: str) -> dict:
    """The JSON-safe lookup key (see module docstring for the contract).

    ``tier`` is ``"interpret"`` or ``"native"`` — which executor family
    the wall times that picked this plan came from (:func:`tier_for`).
    """
    if tier not in ("interpret", "native"):
        raise ValueError(f"tier must be 'interpret' or 'native', got "
                         f"{tier!r}")
    return {
        "schema": SCHEMA_VERSION,
        "signature": repr(spec.signature),
        "shape_bucket": [_pad_to(int(d), _BUCKET) for d in shape],
        "hw": hw_fp,
        "tier": tier,
    }


def _canonical(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def key_digest(key: dict) -> str:
    return hashlib.sha256(_canonical(key)).hexdigest()[:24]


def record_checksum(record: dict) -> int:
    """CRC-32 over the canonical payload, ``checksum`` field excluded."""
    body = {k: v for k, v in record.items() if k != "checksum"}
    return zlib.crc32(_canonical(body))


def make_record(key: dict, plan, exec_mode: str, measured: dict) -> dict:
    """A winner as a self-describing JSON record (the plan fields are
    exactly what ``plan_from_record`` re-pins onto the analytic base;
    ``lazy_batch`` and ``num_buffers`` are the reference's fields, 1 on
    the port's kernels)."""
    return {
        "key": key,
        "torch_version": torch_version(),
        "plan": {
            "t": int(plan.t),
            "block": [int(b) for b in plan.block],
            "lazy_batch": 1,
            "num_buffers": 1,
            "exec_mode": str(exec_mode),
        },
        "measured": dict(measured),
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }


def plan_from_record(spec, shape, hw, record: dict, itemsize: int = 4):
    """Rebuild a pinned :class:`EbisuPlan` from a DB record: the analytic
    plan for (spec, shape bucket, hw) with the measured ``t`` and
    ``block`` pinned over it, and ``halo``, ``smem_bytes`` and
    ``threads`` recomputed for that tile — the same pinning the search
    used to time the candidate (:func:`repro_torch.tuning.search.
    pinned_plan`), so tuned execution replays the measured
    configuration exactly."""
    from repro_torch.tuning.search import pin

    p = record["plan"]
    return pin(spec, shape, hw, int(p["t"]),
               tuple(int(b) for b in p["block"]), itemsize)


class PlanDB:
    """Directory of one-record-per-file JSON plans (module docstring has
    the key/staleness/atomicity contract).

        db = PlanDB("/path/to/db")
        db.put(db_key(spec, shape, hw_fingerprint(), "interpret"), rec)
        db.get(key)       # record dict, or None (miss/corrupt/stale)
    """

    def __init__(self, root: str | None = None):
        self.root = str(root) if root else default_db_path()

    def _path(self, key: dict) -> str:
        return os.path.join(self.root, f"{key_digest(key)}.json")

    # ------------------------------------------------------------- put ----
    def put(self, key: dict, record: dict, *,
            sabotage: str | None = None) -> str:
        """Atomically persist ``record`` under ``key``; returns the path.

        ``sabotage`` is the fault-injection seam (tests only):
        ``'crash'`` abandons the ``.tmp`` file before the rename — what
        a mid-save SIGKILL leaves behind; ``'corrupt'`` flips payload
        bytes after the rename — a bad disk.
        """
        os.makedirs(self.root, exist_ok=True)
        rec = dict(record)
        rec["key"] = key
        rec["checksum"] = record_checksum(rec)
        final = self._path(key)
        tmp = final + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(rec, f, indent=1, sort_keys=True)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        if sabotage == "crash":      # die before the atomic rename
            return tmp
        os.rename(tmp, final)
        if sabotage == "corrupt":
            _flip_bytes(final)
        return final

    # ------------------------------------------------------------- get ----
    def get(self, key: dict) -> dict | None:
        """The record under ``key``, or ``None``.  Corrupt (unparseable /
        checksum mismatch / wrong key in the file) and stale (other torch
        version) records are misses WITH a warning — the caller falls
        back to the analytic plan, never crashes."""
        path = self._path(key)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, ValueError) as e:
            warnings.warn(f"plandb: skipping corrupt record {path} "
                          f"(unparseable: {e})", stacklevel=2)
            return None
        if not isinstance(rec, dict) or "checksum" not in rec:
            warnings.warn(f"plandb: skipping corrupt record {path} "
                          "(no checksum)", stacklevel=2)
            return None
        if record_checksum(rec) != rec["checksum"]:
            warnings.warn(f"plandb: skipping corrupt record {path} "
                          "(checksum mismatch — bytes changed on disk)",
                          stacklevel=2)
            return None
        if rec.get("key") != key:
            warnings.warn(f"plandb: skipping record {path} whose stored "
                          "key does not match its digest (hand-edited?)",
                          stacklevel=2)
            return None
        live = torch_version()
        if rec.get("torch_version") != live:
            warnings.warn(
                f"plandb: skipping stale record {path} (tuned under torch "
                f"{rec.get('torch_version')}, running {live} — re-tune or "
                "`python -m repro_torch.tuning prune-stale`)", stacklevel=2)
            return None
        return rec

    def lookup(self, spec, shape, tier: str, device=None) -> dict | None:
        """``get`` with the key derived from the live hardware (that of
        ``device``, see :func:`hw_fingerprint`)."""
        return self.get(db_key(spec, shape, hw_fingerprint(device), tier))

    # ------------------------------------------------------ maintenance ----
    def entries(self) -> list[tuple[str, dict | None]]:
        """Every visible ``(path, record-or-None)``; ``None`` marks a file
        that fails to parse (``show-db`` reports it, ``get`` skips it).
        ``.tmp`` orphans from crashed saves are never listed."""
        if not os.path.isdir(self.root):
            return []
        out = []
        for fname in sorted(os.listdir(self.root)):
            if not fname.endswith(".json"):
                continue
            path = os.path.join(self.root, fname)
            try:
                with open(path) as f:
                    rec = json.load(f)
                if record_checksum(rec) != rec.get("checksum"):
                    rec = None
            except (OSError, ValueError):
                rec = None
            out.append((path, rec))
        return out

    def prune_stale(self) -> list[str]:
        """Delete corrupt records and records tuned under another torch
        version (plus ``.tmp`` orphans); returns the removed paths."""
        removed = []
        live = torch_version()
        for path, rec in self.entries():
            if rec is None or rec.get("torch_version") != live:
                os.remove(path)
                removed.append(path)
        if os.path.isdir(self.root):
            for fname in os.listdir(self.root):
                if ".json.tmp" in fname:
                    path = os.path.join(self.root, fname)
                    os.remove(path)
                    removed.append(path)
        return removed


def resolve_db(plan_db) -> PlanDB:
    """``None`` → default path; ``str``/path → that directory; a
    :class:`PlanDB` passes through."""
    if isinstance(plan_db, PlanDB):
        return plan_db
    return PlanDB(plan_db if plan_db else None)


def _flip_bytes(path: str, n: int = 6) -> None:
    """Corrupt ``n`` bytes mid-file (fault model: bit rot — the JSON may
    still parse, the checksum catches it)."""
    size = os.path.getsize(path)
    off = max(size // 2, 2)
    with open(path, "r+b") as f:
        f.seek(off)
        chunk = f.read(n)
        f.seek(off)
        f.write(bytes((b ^ 0xFF) for b in chunk))

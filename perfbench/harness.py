"""One run of one cell: resolve its names from ``BENCHMARK.json`` to the
files that hold them, set up, measure, check against the reference and
print the result line.

Every name is found by its file:

    configs/<config>.json       a configuration; its ``kind`` names
    references/<kind>.py        the plain reference that judges its answers
    traffic/<traffic>.json      a traffic mix; its ``generator`` names
    generators/<generator>.py   the code that sets the cell up and drives
                                the program through the window
    cells/<workload>.json       the limits of the cell's check, and the
                                mix's parameters the cell sets itself
    metrics/<metric>.py         the reader of one metric

A name with no file is an error.  A generator module holds ``run(cell)``
(a :class:`window.Run`), ``CHECKS`` (the numbers its runs compare),
``FAULTS`` and ``plant(kind, cell)`` (for ``check_correct.py``); a
reference module holds ``gap(config, answer, **args)`` and
``control(config, **args)``; a metric module ``read(run, cell)``, which
returns a number, or None where it finds nothing to read.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from perfbench import window
from perfbench.yardstick import percentile

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DTYPES = {"float32": torch.float32, "float64": torch.float64}


class MissingName(LookupError):
    """A name in ``BENCHMARK.json`` that no file answers to."""


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(path.read_text())


def entry(entries: list, name: str, what: str) -> dict:
    """The one entry of ``entries`` named ``name``."""
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise MissingName(f"{what} {name!r}: {len(found)} entries in "
                          "BENCHMARK.json")
    return found[0]


def _json_file(path: Path, what: str) -> dict:
    if not path.is_file():
        raise MissingName(f"{what}: no file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def load_module(folder: str, name: str, what: str):
    """The module ``<folder>/<name>.py``, loaded once a process."""
    path = HERE / folder / f"{name}.py"
    if not isinstance(name, str) or not path.is_file():
        raise MissingName(f"{what} {name!r}: no file "
                          f"{path.relative_to(ROOT)}")
    key = f"perfbench.{folder}.{name.replace('.', '_')}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]


def load_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return load_module("metrics", name, "metric").read


def metrics_for(bench: dict, workload: str, traced: bool) -> list:
    """The metric entries a run of ``workload`` reports: its end-to-end
    metrics untraced, its per-layer metrics traced.  A metric without a
    ``workloads`` list applies where its end-to-end metric does."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


@dataclasses.dataclass
class Cell:
    """A resolved cell and the run's arguments."""
    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float                    # perf_counter at process start
    generator: object = None          # the module generators/<name>.py
    reference: object = None          # the module references/<kind>.py
    domain: tuple = ()                # the configuration's, unless given

    def __post_init__(self):
        self.marks = {}
        self.mark("imports")
        self.domain = tuple(self.domain or self.config.get("domain", ()))
        self.dtype = DTYPES[self.config["dtype"]]
        self.gen = torch.Generator(self.device).manual_seed(
            self.seed % (1 << 63))

    def mark(self, stage: str) -> None:
        """Note the seconds since the process started at the end of a
        set-up stage (reported beside ``setup_s``)."""
        self.marks[stage] = time.perf_counter() - self.started

    def field(self, shape) -> torch.Tensor:
        """Uniform [0, 1) values of ``shape``, made on the device from the
        seed in one call."""
        return torch.rand(tuple(shape), generator=self.gen,
                          dtype=self.dtype, device=self.device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def event(self):
        """A recorded CUDA event on the card, or a stand-in elsewhere."""
        if self.device.type != "cuda":
            return _Done()
        ev = torch.cuda.Event()
        ev.record()
        return ev


class _Done:
    def synchronize(self) -> None:
        pass


def resolve(bench: dict, workload: str, **run_args) -> Cell:
    wl = entry(bench["workloads"], workload, "workload")
    cfg_entry = entry(bench["configs"], wl["config"], "config")
    config = _json_file(ROOT / cfg_entry["file"], f"config {wl['config']!r}")
    reference = load_module("references", config.get("kind"),
                            f"config {wl['config']!r}: kind")
    traffic = _json_file(HERE / "traffic" / f"{wl['traffic']}.json",
                         f"traffic {wl['traffic']!r}")
    generator = load_module("generators", traffic.get("generator"),
                            f"traffic {wl['traffic']!r}: generator")
    cell_file = _json_file(HERE / "cells" / f"{workload}.json",
                           f"cell {workload!r}")
    traffic = dict(traffic, **cell_file.get("traffic", {}))
    limits = cell_file["limits"]
    missing = set(generator.CHECKS) - set(limits)
    if missing:
        raise MissingName(f"cell {workload!r}: no limit for "
                          f"{', '.join(sorted(missing))}")
    return Cell(name=workload, config=config, traffic=traffic,
                limits=limits, generator=generator, reference=reference,
                **run_args)


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's or
    the JAX package's (names compared whole: ``repro_torch`` passes)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def compare(run: window.Run, cell: Cell) -> dict:
    """Each number compared, the worst of its kind, with its limit: the
    program's output against the reference run from the same input (the
    reference module's ``gap``).  A number with nothing to compare reads
    infinite.  Every request has to
    be answered: a refusal at admission is an answer (it counts in the
    latency, as infinite), a request lost or failed in the service is not
    (``lost``)."""
    checks = {name: 0.0 if any(c[0] == name for c in run.compare)
              else math.inf for name in cell.limits}
    for name, answer, args in run.compare:
        err = cell.reference.gap(cell.config, answer, **args)
        checks[name] = max(checks.get(name, 0.0), err)
    out = {k: {"value": v, "limit": cell.limits[k]} for k, v in checks.items()}
    out["lost"] = {"value": run.failed - run.refused, "limit": 0}
    return out


def run_cell(bench: dict, cell: Cell) -> dict:
    """Set up, measure, check; the result line as a dict."""
    run = cell.generator.run(cell)
    device = {"platform": "gpu" if cell.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(cell.device)
                       if cell.device.type == "cuda" else "cpu"),
              "count": 1,
              "memory_peak_bytes": (torch.cuda.max_memory_allocated(
                  cell.device) if cell.device.type == "cuda" else 0)}
    metrics = {}
    for m in metrics_for(bench, cell.name, cell.trace):
        value = load_reader(m["name"])(run, cell)
        if value is None and m in bench["end_to_end"]:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if value is not None:
            metrics[m["name"]] = {"value": _number(value), "unit": m["unit"]}
    result = {"correct": None, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": device}
    if cell.trace:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s()
        result["breakdown"] = run.trace.breakdown()
    result["window"] = window_notes(run)
    run.trace = None
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()     # room for the reference
    checks = compare(run, cell)
    run.compare.clear()
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = {k: {"value": _number(c["value"]),
                            "limit": c["limit"]} for k, c in checks.items()}
    return result


def window_notes(run: window.Run) -> dict:
    """Notes beside the result that no bound or check reads: the window's
    length, when each set-up stage ended, the generator's own notes, and
    in an open loop the refusals, how late the generator sent and the
    backlog when the last request fell due."""
    out = {"window_s": run.window_s, "setup_stages_s": run.setup_stages,
           **run.notes}
    if run.lateness_ms:
        out.update(refused=run.refused,
                   lateness_p50_ms=percentile(run.lateness_ms, 50),
                   lateness_p95_ms=percentile(run.lateness_ms, 95),
                   lateness_max_ms=max(run.lateness_ms),
                   backlog_at_close=run.backlog_at_close)
    return out


def _number(v):
    """A JSON number, or null for a value that is not finite."""
    v = float(v) if not isinstance(v, int) else v
    return v if math.isfinite(v) else None

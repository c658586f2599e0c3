"""CPU checks of the harness itself (not collected by pytest; run it by
name): ``python3 perfbench/check_harness.py`` exits 0 when all hold.

They cover the metric arithmetic on hand-made traces, the traffic
generator (same seed, same schedule; every seed the same work), that
every name in ``BENCHMARK.json`` resolves to its file and that a name
with no file is an error, the reference at tiny sizes against a loop
written out by hand, and that nothing the harness imports is JAX or the
JAX package (top-level module names compared whole).
"""
from __future__ import annotations

import ast
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import harness, window, yardstick  # noqa: E402
from perfbench.trace import WINDOW, Trace  # noqa: E402

FAILURES: list = []
SERVE = harness.load_module("generators", "open_service", "generator")
REF = harness.load_module("references", "stencil", "kind")


def expect(cond, what: str) -> None:
    if not cond:
        FAILURES.append(what)


def close(a, b, rel=1e-9) -> bool:
    return a is not None and math.isclose(a, b, rel_tol=rel)


def check_arithmetic() -> None:
    # union: overlapping, nested and clipped intervals, and the gaps left
    covered, gaps = yardstick.union([(2, 5), (4, 7), (5, 6), (9, 12), (0, 1)],
                                    1, 11)
    expect(covered == 5 + 2, f"union covered {covered}")
    expect(gaps == [(1, 2), (7, 9)], f"union gaps {gaps}")
    expect(yardstick.union([], 0, 3) == (0.0, [(0, 3)]), "empty union")
    # the roofline: bytes bind two depth-1 launches, operations 100 steps
    pct = yardstick.roofline_pct([1e-5, 3e-5], 10 ** 6, 2 * 10 ** 6, 10,
                                 "float32")
    expect(close(pct, 100 * 2 * 8e6 / 3.35e12 / 4e-5), f"roofline {pct}")
    pct = yardstick.roofline_pct([1e-5, 3e-5], 10 ** 6, 200 * 10 ** 6, 10,
                                 "float32")
    expect(close(pct, 100 * 2e9 / 67e12 / 4e-5), f"operations roofline {pct}")
    # a launch more costs its bytes and its time: nothing vanishes
    pct = yardstick.roofline_pct([1e-5] * 3, 10 ** 6, 3 * 10 ** 6, 10,
                                 "float32")
    expect(close(pct, 100 * 3 * 8e6 / 3.35e12 / 3e-5), f"three launches {pct}")
    expect(yardstick.roofline_pct([], 10, 10, 10, "float32") is None,
           "a kernel with no launch traced reads nothing")
    expect(close(yardstick.mfu_pct(67 * 10 ** 9, 100, 1.0, "float32"), 10.0),
           "mfu")
    expect(yardstick.percentile([5, 1, 4, 2, 3], 50) == 3, "median")
    expect(yardstick.percentile(list(range(1, 101)), 95) == 95, "p95")
    expect(yardstick.percentile([1.0] * 19 + [math.inf], 95) == 1.0, "p95 inf")
    expect(yardstick.percentile([1.0] * 18 + [math.inf] * 2, 95) == math.inf,
           "a failure in the tail")


def fake_trace() -> Trace:
    """Window 0–100 ns; two 2-D kernel launches, a copy, and spans."""
    ops = [("void tile2d_kernel<float, 8>(x)", 10, 40),
           ("void tile2d_kernel<float, 8>(x)", 45, 75),
           ("Memcpy DtoD", 30, 50),
           ("void tile2d_kernel<float, 8>(x)", 120, 130)]   # after the window
    spans = [(WINDOW, 0, 100), ("program.run", 0, 20),
             ("harness.wait", 20, 90), ("program.run", 90, 100)]
    return Trace((0, 100), ops, spans)


def check_trace_readers() -> None:
    tr = fake_trace()
    expect(close(tr.busy_s(), 65e-9), f"busy {tr.busy_s()}")
    expect(close(tr.window_s(), 100e-9), "window")
    expect(len(tr.ops_named("tile2d_kernel")) == 2, "ops in the window")
    bd = tr.breakdown()
    expect(bd["device_ops"][0][0].startswith("void tile2d_kernel")
           and close(bd["device_ops"][0][1], 60e-9), f"top op {bd}")
    # gaps: 0–10 begins under program.run, 75–100 under harness.wait
    gaps = dict(bd["idle_gaps"])
    expect(close(gaps.get("program.run"), 10e-9)
           and close(gaps.get("harness.wait"), 25e-9), f"gaps {gaps}")
    config = json.loads((ROOT / "perfbench/configs/j2d5pt.json").read_text())
    cell = type("C", (), {"config": config})()
    cells = 1000
    run = window.Run(setup_s=1.0, window_s=2.0, attempted=2, failed=0,
                     trace=tr, counters={"kernel_launches": 240},
                     calls=2, cells=cells, depth=5,
                     geometry={"cell_updates": 6000},
                     useful_cell_updates=2 * 5 * cells)
    read = harness.load_reader
    want = 100 * 2 * 2 * cells * 4 / 3.35e12 / 60e-9
    expect(close(read("kernel2d_roofline")(run, cell), want), "2-D roofline")
    expect(read("kernel3d_roofline")(run, cell) is None,
           "a kernel absent from the trace reads nothing")
    expect(close(read("device_idle.run")(run, cell), 35.0), "idle")
    expect(close(read("device_idle.serve")(run, cell), 35.0), "serve idle")
    expect(close(read("launches_per_call")(run, cell), 120.0), "launches")
    expect(close(read("planner_redundancy")(run, cell), 1.2), "redundancy")
    expect(close(read("mfu")(run, cell),
                 100 * 1e4 * 10 / 2.0 / 67e12), "mfu reader")
    expect(close(read("gcells_per_s")(run, cell), 1e4 / 2.0 / 1e9),
           "gcells")
    run.latencies_ms = [float(v) for v in range(1, 101)]
    run.counters.update(completed=90, errored=10, batches=40)
    expect(read("latency_p95_ms")(run, cell) == 95.0, "p95 reader")
    expect(read("latency_p50_ms")(run, cell) == 50.0, "p50 reader")
    expect(close(read("serve_batch_size")(run, cell), 2.5), "batch size")


def check_verdict() -> None:
    """A refusal at admission is an answer, a request lost in the service
    is not, and a number with nothing to compare fails."""
    config = json.loads((ROOT / "perfbench/configs/j2d5pt.json").read_text())
    cell = type("C", (), {"config": config, "reference": REF,
                          "limits": {"served_max_abs_err": 1e-3}})()
    x = torch.rand(6, 7, dtype=torch.float64)
    good = [("served_max_abs_err", REF.run(x, config, 2),
             {"x": x, "steps": 2})]
    for failed, refused, compared, want in ((3, 3, good, True),
                                            (3, 2, good, False),
                                            (0, 0, [], False)):
        run = window.Run(setup_s=0.0, window_s=1.0, attempted=9,
                         failed=failed, refused=refused,
                         compare=list(compared))
        checks = harness.compare(run, cell)
        ok = all(c["value"] <= c["limit"] for c in checks.values())
        expect(ok is want, f"verdict {failed=} {refused=} "
               f"compared={bool(compared)}: {checks}")


def check_generator() -> None:
    tr = json.loads((ROOT / "perfbench/traffic/serve_open.json").read_text())
    a = SERVE.open_schedule(tr, 2 ** 31 + 99, 10.0, 2)
    expect(a == SERVE.open_schedule(tr, 2 ** 31 + 99, 10.0, 2),
           "same seed, same schedule")
    b = SERVE.open_schedule(tr, 12345, 10.0, 2)
    expect(a != b, "another seed, another order")
    expect(len(a) == len(b) == round(tr["rate_per_s"] * 10), "request count")
    for sched in (a, b):
        expect(math.isclose(sched[-1][0], 10.0), "last request due at the end")
        expect(all(x[0] <= y[0] for x, y in zip(sched, sched[1:])),
               "due order")

    def gaps(s):
        dues = [0.0] + [r[0] for r in s]
        return sorted(y - x for x, y in zip(dues, dues[1:]))

    expect(max(abs(p - q) for p, q in zip(gaps(a), gaps(b))) < 1e-6,
           "every seed the same gaps")
    for k in (1, 2):
        expect(sorted(r[k] for r in a) == sorted(r[k] for r in b),
               "every seed the same tenants and shapes")
    expect(SERVE.check_sample(a, tr, 7, 2) == SERVE.check_sample(
        a, tr, 7, 2), "same seed, same checked requests")
    expect(len(SERVE.check_sample(a, tr, 7, 2))
           == 2 * tr["check_per_shape"], "checked requests of each shape")
    expect(SERVE.served_shapes(tr, (8352, 8352))
           == [(8352, 8352), (4176, 4176)], "served shapes")
    bench = harness.load_benchmark()
    steps = {w: harness.resolve(bench, w, seed=1, seconds=1, trace=False,
                                device=torch.device("cpu"), started=0.0)
             .traffic.get("steps_per_call")
             for w in ("j2d5pt.run", "j3d7pt.run")}
    expect(steps == {"j2d5pt.run": 600, "j3d7pt.run": 240},
           f"each cell's own steps a call {steps}")


def check_batch_sample() -> None:
    """The serve check holds every row of one batch of each (shape, size),
    drawn among those batches; a replaced batch drops its results."""
    class Tk:
        def __init__(self, i):
            self.id, self.value = i, f"y{i}"      # its result, once done

    counts = {}
    for seed in range(400):
        sample = SERVE.BatchSample(seed, also_kept={2})
        batches = [[Tk(10 * b + r) for r in range(3)] for b in range(4)]
        for b in batches:
            sample.offer((0, 3), b)
            for tk in b:             # dispatched: the service's on_done
                if tk.id not in sample.ids and tk.id != 2:
                    tk.value = None
        sample.offer((1, 1), [Tk(99)])
        held = sample.held[(0, 3)]
        expect(sample.ids == {tk.id for tk in held} | {99},
               f"held ids {sample.ids}")
        for b in batches:
            for tk in b:
                kept = tk.id in sample.ids or tk.id == 2
                expect((tk.value is not None) == kept,
                       f"seed {seed}: ticket {tk.id} value {tk.value}")
        counts[held[0].id] = counts.get(held[0].id, 0) + 1
    expect(sorted(counts) == [0, 10, 20, 30]
           and min(counts.values()) > 60, f"a uniform draw {counts}")


def check_names() -> None:
    bench = harness.load_benchmark()
    for wl in bench["workloads"]:
        cell = harness.resolve(bench, wl["name"], seed=1, seconds=1,
                               trace=False, device=torch.device("cpu"),
                               started=0.0)
        reported = harness.metrics_for(bench, wl["name"], False)
        names = [m["name"] for m in reported]
        expect("setup_s" in names and len(names) >= 2,
               f"{wl['name']}: end-to-end metrics {names}")
        layer = harness.metrics_for(bench, wl["name"], True)
        expect(bool(layer), f"{wl['name']}: no per-layer metric")
        for m in reported + layer:
            expect(callable(harness.load_reader(m["name"])),
                   f"reader of {m['name']}")
        expect(set(cell.limits) == set(cell.generator.CHECKS),
               f"{wl['name']}: limits {sorted(cell.limits)}")
        expect(callable(cell.generator.run)
               and callable(cell.generator.plant)
               and callable(cell.reference.gap)
               and callable(cell.reference.control),
               f"{wl['name']}: generator and reference")
    for m in bench["per_layer"]:
        e2e = [e for e in bench["end_to_end"] if e["name"] == m["moves"]]
        expect(len(e2e) == 1, f"{m['name']} moves {m['moves']}")
        for w in m.get("workloads", []):
            expect(w in e2e[0].get("workloads", [w]),
                   f"{m['name']}: {w} does not report {m['moves']}")
    # a name with no file is an error, never a silent skip
    for broken, what in (
            ({"traffic": "no_such_mix"}, "traffic"),
            ({"config": "no_such_config"}, "config"),
            ({"name": "no.such.cell"}, "cell")):
        b = json.loads(json.dumps(bench))
        wl = dict(b["workloads"][0], **broken)
        b["workloads"].append(wl)
        try:
            harness.resolve(b, wl["name"], seed=1, seconds=1, trace=False,
                            device=torch.device("cpu"), started=0.0)
            expect(False, f"a {what} with no file resolved")
        except harness.MissingName:
            pass
    for folder, name in (("metrics", "no_such_metric"),
                         ("generators", "no_such_generator"),
                         ("references", "no_such_kind"),
                         ("references", None)):
        try:
            harness.load_module(folder, name, folder)
            expect(False, f"{folder} {name!r} with no file resolved")
        except harness.MissingName:
            pass


def check_contract_shape() -> None:
    """The limits of ``BENCHMARK.json`` that a run alone would not show."""
    bench = harness.load_benchmark()
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    expect(set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}, "keys")
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            expect(bool(name.match(e["name"])), f"name {e['name']}")
            expect((group, e["name"]) not in seen, f"twice: {e['name']}")
            seen.add((group, e["name"]))
            if "unit" in e:
                expect(bool(unit.match(e["unit"])), f"unit {e['unit']}")
                expect(e["better"] in ("lower", "higher"), "better")
            for key in {"configs": ("why", "source"), "workloads": ("why",),
                        "per_layer": ("layer",)}.get(group, ()):
                expect(0 < len(e[key]) <= 200
                       and not set(e[key]) & {"\n", "\t"},
                       f"{e['name']}.{key}")
    for m in bench["end_to_end"]:
        expect(0 < m["bound"] <= 0.25, f"bound of {m['name']}")
    cells = len(bench["workloads"])
    total = (2 + 14 * cells) * (bench["run_seconds"] + 60) + cells * 180 \
        + 1200
    expect(total <= 43200, f"a full check takes {total} s")
    expect((2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200
           <= 43200, "run_seconds fits 24 cells")


def check_reference() -> None:
    """The reference against a loop written out by hand, in float64."""
    rng = np.random.default_rng(3)
    for name, shape in (("j2d5pt", (5, 7)), ("j3d7pt", (4, 5, 6))):
        config = json.loads((ROOT / f"perfbench/configs/{name}.json")
                            .read_text())
        config = dict(config, dtype="float64")
        x = rng.random(shape)
        want = x.copy()
        for _ in range(3):
            nxt = np.zeros_like(want)
            for idx in np.ndindex(*shape):
                acc = 0.0
                for off, c in config["taps"]:
                    src = tuple(i + o for i, o in zip(idx, off))
                    if all(0 <= s < n for s, n in zip(src, shape)):
                        acc += c * want[src]
                nxt[idx] = acc
            want = nxt
        got = REF.run(torch.from_numpy(x), config, 3).numpy()
        expect(np.abs(got - want).max() < 1e-12, f"reference {name}")
        batch = torch.from_numpy(np.stack([x, 2 * x]))
        got2 = REF.run(batch, config, 3).numpy()
        expect(np.abs(got2[1] - 2 * want).max() < 1e-12,
               f"reference {name} on a batch")
        low = REF.run(torch.from_numpy(x), config, 3, "bfloat16")
        expect(low.dtype == torch.bfloat16, "the control's precision")


def check_imports() -> None:
    """No module the harness loads, and no import it names, is JAX's or
    the JAX package's; nothing reads the old ``benchmarks/`` folder."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import torch\n"
            "from perfbench import harness, window, sweep_serve, "
            "check_correct\n"
            "bench = harness.load_benchmark()\n"
            "for m in bench['end_to_end'] + bench['per_layer']:\n"
            "    harness.load_reader(m['name'])\n"
            "for w in bench['workloads']:\n"
            "    harness.resolve(bench, w['name'], seed=1, seconds=1, "
            "trace=False, device=torch.device('cpu'), started=0.0)\n"
            "import repro_torch.serve.stencil_service, "
            "repro_torch.api.program\n"
            "print(harness.forbidden_modules())\n"
            % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    expect(out.returncode == 0 and out.stdout.strip().endswith("[]"),
           f"modules loaded: {out.stdout[-300:]} {out.stderr[-300:]}")
    forbidden = set(harness.FORBIDDEN)
    for path in sorted((ROOT / "perfbench").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                expect(n.split(".")[0] not in forbidden,
                       f"{path.name} imports {n}")
        if path.name != Path(__file__).name:
            expect("benchmarks/" not in path.read_text(),
                   f"{path.name} names benchmarks/")
    expect(harness.forbidden_modules() == [], "this process")
    expect(not {"repro_torch"} & forbidden, "the port's name is not forbidden")


def main() -> int:
    torch.set_num_threads(2)
    for check in (check_arithmetic, check_trace_readers, check_verdict,
                  check_generator, check_batch_sample,
                  check_names, check_contract_shape, check_reference,
                  check_imports):
        before = len(FAILURES)
        check()
        print(f"{'ok ' if len(FAILURES) == before else 'BAD'} "
              f"{check.__name__}")
    for f in FAILURES:
        print("  failed:", f)
    return 1 if FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())

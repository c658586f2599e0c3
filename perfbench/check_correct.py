"""The check that decides ``correct``, held to its control and its faults.

Not collected by pytest (run it by name).  Two modes:

    python3 perfbench/check_correct.py
        On the CPU, at the sizes each cell's file gives under
        ``cpu_check``, with the harness's look for a card skipped: each
        cell's sound run comes out correct, and its control and each fault
        its generator can have (``FAULTS``) come out not correct.  Exits 0
        when every case comes out as it should.

    python3 perfbench/check_correct.py --chip --workload j2d5pt.run \\
        --seeds 11,12,... --control-seeds 21,22,23 --seconds 3 \\
        [--fault-seeds 31,32,33]
        On the card at the cell's own size, in one process: the numbers
        compared on each seed of the program, then of the control (the
        reference one precision down, put in the program's place by the
        cell's generator), then of each of the generator's faults.  Prints
        the lower reading (the largest of the program's) and the upper
        (the smallest of the control's and of each fault's) of each number,
        from which the cell's limits are set.

The faults are planted under the timed path by the generator's
``plant``; those of the stencil generators are in ``generators/_stencil.py``.
No cell crosses chips, so none can lose an exchange.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from perfbench import harness  # noqa: E402


def one_run(bench, workload, *, seed, seconds, device, kind=None,
            domain=(), traffic=None) -> dict:
    cell = harness.resolve(bench, workload, seed=seed, seconds=seconds,
                           trace=False, device=device,
                           started=time.perf_counter(), domain=domain)
    if traffic:
        cell.traffic = dict(cell.traffic, **traffic)
    with cell.generator.plant(kind, cell):
        return harness.run_cell(bench, cell)


def cpu_case(workload: str) -> dict:
    return json.loads((harness.HERE / "cells" / f"{workload}.json")
                      .read_text())["cpu_check"]


def cpu_check() -> int:
    """Each cell's sound run correct; its control and faults not."""
    torch.set_num_threads(2)
    bench = harness.load_benchmark()
    cpu = torch.device("cpu")
    bad = 0
    for wl in bench["workloads"]:
        workload = wl["name"]
        case = cpu_case(workload)
        gen = harness.resolve(bench, workload, seed=0, seconds=1,
                              trace=False, device=cpu,
                              started=0.0).generator
        for kind in (None, "control") + tuple(gen.FAULTS):
            r = one_run(bench, workload, seed=(1 << 31) + 17,
                        seconds=case["seconds"], device=cpu, kind=kind,
                        domain=tuple(case["domain"]),
                        traffic=case.get("traffic"))
            want = kind is None
            ok = r["correct"] is want
            bad += not ok
            print(f"{'ok ' if ok else 'BAD'} {workload} "
                  f"{kind or 'sound'}: correct={r['correct']} "
                  f"{json.dumps(r['checks'])} {json.dumps(r['window'])}")
    return 1 if bad else 0


def chip_readings(args) -> int:
    bench = harness.load_benchmark()
    dev = torch.device("cuda", 0)
    gen = harness.resolve(bench, args.workload, seed=0, seconds=1,
                          trace=False, device=dev, started=0.0).generator
    plan = [(None, args.seeds), ("control", args.control_seeds)]
    plan += [(f, args.fault_seeds) for f in gen.FAULTS]
    rows = {}
    for kind, seeds in plan:
        for seed in seeds:
            r = one_run(bench, args.workload, seed=seed,
                        seconds=args.seconds, device=dev, kind=kind)
            row = {k: c["value"] for k, c in r["checks"].items()}
            rows.setdefault(kind or "program", {})[seed] = row
            print(json.dumps({"workload": args.workload,
                              "run": kind or "program", "seed": seed,
                              "attempted": r["attempted"],
                              "correct": r["correct"], "checks": row,
                              "window": r["window"]}), flush=True)
            torch.cuda.empty_cache()
    summary = {}
    for name in next(iter(rows["program"].values())):
        prog = [row[name] for row in rows["program"].values()]
        summary[name] = {"lower": max(v if v is not None else float("inf")
                                      for v in prog), "program": prog}
        for kind in rows:
            if kind != "program":
                got = [row.get(name) for row in rows[kind].values()]
                summary[name][kind] = got
                summary[name][f"upper_{kind}"] = min(
                    v if v is not None else float("inf") for v in got)
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chip", action="store_true")
    ap.add_argument("--workload")
    ap.add_argument("--seeds", type=lambda s: [int(v) for v in s.split(",")])
    ap.add_argument("--control-seeds", default=[],
                    type=lambda s: [int(v) for v in s.split(",")])
    ap.add_argument("--fault-seeds", default=[],
                    type=lambda s: [int(v) for v in s.split(",")])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    return chip_readings(args) if args.chip else cpu_check()


if __name__ == "__main__":
    sys.exit(main())

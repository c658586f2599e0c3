"""Find the highest rate a serving cell's mix sustains: its open loop at a
list of offered rates, in one process on the card.

    python3 perfbench/sweep_serve.py --workload j2d5pt.serve \\
        --rates 150,200,250,300 --seconds 30 --seed 5

One JSON line a rate: requests, failures, latency p50/p95/p99 (from the
scheduled send time), the backlog when the last request fell due, how
long the queue took to drain after it, the generator's lateness and the
mean batch.  The cell's own runs never search: its traffic file holds
the rate chosen from this sweep.
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
from perfbench.yardstick import percentile  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True,
                    type=lambda s: [float(v) for v in s.split(",")])
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)
    bench = harness.load_benchmark()
    for rate in args.rates:
        cell = harness.resolve(bench, args.workload, seed=args.seed,
                               seconds=args.seconds, trace=False,
                               device=torch.device("cuda", 0),
                               started=time.perf_counter())
        cell.traffic = dict(cell.traffic, rate_per_s=rate)
        run = cell.generator.run(cell)
        lat = run.latencies_ms
        # the tail in each tenth of the window, by due time
        tenths = [percentile(lat[k * len(lat) // 10:(k + 1) * len(lat) // 10],
                             95) for k in range(10)]
        print(json.dumps({
            "rate_per_s": rate, "requests": run.attempted,
            "failed": run.failed,
            "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
            "p99_ms": percentile(lat, 99),
            "backlog_at_close": run.backlog_at_close,
            "drain_s": run.window_s - args.seconds,
            "lateness_p95_ms": percentile(run.lateness_ms, 95),
            "batch_size": (run.counters.get("completed", 0)
                           / max(1, run.counters.get("batches", 0))),
            "p95_ms_by_tenth": tenths}),
            flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

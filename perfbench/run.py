"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload j2d5pt.run --seed 7 --seconds 10 \\
        --trace 0

Runs from the root of a checkout on a machine with the card the cell asks
for; refuses, printing no result, without one.  The last line of standard
output is the result as JSON; the numbers compared with the reference
are the last lines of standard error, each beside its limit.
"""
import time

STARTED = time.perf_counter()      # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# build and kernel caches at fixed paths inside the checkout (the port's
# own libraries build into src/repro_torch/kernels/_build/, also inside)
CACHE = ROOT / "perfbench" / ".cache"
CACHES = {"TORCH_EXTENSIONS_DIR": CACHE / "torch_extensions",
          "TRITON_CACHE_DIR": CACHE / "triton"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(path)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import harness

    bench = harness.load_benchmark()
    chips = harness.entry(bench["workloads"], args.workload,
                         "workload")["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 3
    cell = harness.resolve(bench, args.workload, seed=args.seed,
                           seconds=args.seconds, trace=bool(args.trace),
                           device=torch.device("cuda", 0), started=STARTED)
    result = harness.run_cell(bench, cell)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: the process loaded {', '.join(bad)}; the "
              "program under test and the harness may not", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

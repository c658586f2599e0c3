"""``python -m repro_torch.tuning`` — the tuning front door.

Subcommands (the reference's, ``repro.tuning.cli``):

  sweep        budgeted measured search per spec; winners -> plan DB
  check        compile ``mode="tuned"`` and exit nonzero on a DB miss
               (a second process proving the DB replays with no timing)
  show-db      list every record with its key, winner, and health
  prune-stale  delete corrupt records and records tuned under another
               torch version

``--device`` picks the card (``cuda``, the default) or the CPU's plain
version (``cpu``); the DB keys the two apart.

    PYTHONPATH=src python -m repro_torch.tuning sweep --device cpu \\
        --stencil j2d5pt --scale 64 --budget 24 --db /tmp/plandb
    PYTHONPATH=src python -m repro_torch.tuning check --device cpu \\
        --stencil j2d5pt --scale 64 --db /tmp/plandb
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _specs(args, ap):
    from repro_torch.core.stencil_spec import TABLE2, get

    if getattr(args, "taps", None) or getattr(args, "spec_json", None):
        from repro_torch.api import (define_stencil, parse_taps,
                                     spec_from_json)

        return [define_stencil(parse_taps(args.taps),
                               normalize=args.normalize)
                if args.taps else spec_from_json(args.spec_json)]
    names = (list(TABLE2) if args.stencil == "all"
             else args.stencil.split(","))
    unknown = [n for n in names if n not in TABLE2]
    if unknown:
        ap.error(f"unknown stencil(s) {unknown}; choose from "
                 f"{list(TABLE2)} — or pass --taps/--spec-json for a "
                 "custom stencil")
    return [get(n) for n in names]


def _shape(spec, args):
    from repro_torch.stencils.data import reduced_domain

    if args.shape:
        shape = tuple(int(d) for d in args.shape.split(","))
        if len(shape) != spec.ndim:
            raise SystemExit(f"--shape {args.shape} is {len(shape)}-D but "
                             f"{spec.name} is {spec.ndim}-D")
        return shape
    return reduced_domain(spec, args.scale)


def cmd_sweep(args, ap) -> int:
    from repro_torch.tuning.plandb import PlanDB
    from repro_torch.tuning.search import tune

    db = PlanDB(args.db)
    results = []
    for spec in _specs(args, ap):
        res = tune(spec, _shape(spec, args), db=db, budget=args.budget,
                   total_t=args.t_total, max_candidates=args.candidates,
                   device=args.device,
                   log=lambda *a: print(*a, flush=True))
        results.append({"stencil": spec.name, "winner": res.winner.label(),
                        "record": res.record})
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
            f.write("\n")
        print(f"[tune] wrote {args.json}")
    return 0


def cmd_check(args, ap) -> int:
    """Exit 0 iff every requested spec resolves mode='tuned' from the
    DB (``prog.tuned['source'] == 'plandb'``) — zero search either way;
    the last line gives the timing calls this process made."""
    from repro_torch.api import compile_stencil
    from repro_torch.tuning.search import TIMING

    status = 0
    for spec in _specs(args, ap):
        shape = _shape(spec, args)
        prog = compile_stencil(spec, shape, mode="tuned", plan_db=args.db,
                               device=args.device)
        src = (prog.tuned or {}).get("source")
        ok = src == "plandb"
        print(f"[tuned-check] {spec.name} {shape}: source={src} "
              f"t={prog.t} mode={prog.mode} block={prog.plan.block} -> "
              f"{'HIT' if ok else 'MISS'}")
        if not ok:
            status = 1
    print(f"[tuned-check] timing_calls={TIMING['calls']}")
    return status


def cmd_show_db(args, ap) -> int:
    from repro_torch.tuning.plandb import PlanDB, torch_version

    db = PlanDB(args.db)
    entries = db.entries()
    print(f"[plandb] {db.root}: {len(entries)} record(s)")
    live = torch_version()
    for path, rec in entries:
        name = os.path.basename(path)
        if rec is None:
            print(f"  {name}  CORRUPT (skipped at lookup; prune-stale "
                  "removes it)")
            continue
        key, plan, m = rec.get("key", {}), rec.get("plan", {}), \
            rec.get("measured", {})
        stale = ("" if rec.get("torch_version") == live
                 else f"  STALE (torch {rec.get('torch_version')} != "
                      f"{live})")
        print(f"  {name}  sig={key.get('signature', '?')[:40]}... "
              f"bucket={key.get('shape_bucket')} hw={key.get('hw')} "
              f"tier={key.get('tier')}{stale}")
        print(f"    t={plan.get('t')} block={plan.get('block')} "
              f"lazy_batch={plan.get('lazy_batch')} "
              f"mode={plan.get('exec_mode')} | "
              f"{m.get('best_us')}us ({m.get('ratio_to_naive')}x naive, "
              f"{m.get('timing_calls')} calls) {rec.get('created', '')}")
    return 0


def cmd_prune_stale(args, ap) -> int:
    from repro_torch.tuning.plandb import PlanDB

    removed = PlanDB(args.db).prune_stale()
    for path in removed:
        print(f"[plandb] removed {path}")
    print(f"[plandb] pruned {len(removed)} stale/corrupt record(s)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tuning",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, tuning_knobs: bool):
        p.add_argument("--db", default=None,
                       help="plan DB directory (default: "
                            "$REPRO_TORCH_PLANDB or "
                            "~/.cache/repro_torch/plandb)")
        if tuning_knobs:
            p.add_argument("--device", choices=("cuda", "cpu"),
                           default="cuda",
                           help="time and replay on the card (default) or "
                                "the CPU's plain version")
            p.add_argument("--stencil", default="all")
            p.add_argument("--scale", type=int, default=64)
            p.add_argument("--shape", default=None,
                           help="explicit comma-separated domain "
                                "(overrides --scale)")
            p.add_argument("--taps", default=None,
                           help="tune a custom stencil from a JSON tap "
                                "list (define_stencil)")
            p.add_argument("--spec-json", default=None,
                           help="tune a custom stencil from a JSON spec "
                                "file")
            p.add_argument("--normalize", action="store_true",
                           help="rescale --taps coefficients to sum to 1")

    p = sub.add_parser("sweep", help="measured search; winners -> DB")
    common(p, True)
    p.add_argument("--budget", type=int, default=64,
                   help="max timing calls across all halving rounds")
    p.add_argument("--t-total", type=int, default=None,
                   help="chain length timed per candidate")
    p.add_argument("--candidates", type=int, default=12)
    p.add_argument("--json", default=None)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("check",
                       help="mode='tuned' compile; exit 1 on DB miss")
    common(p, True)
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser("show-db", help="list records + health")
    common(p, False)
    p.set_defaults(fn=cmd_show_db)

    p = sub.add_parser("prune-stale",
                       help="delete corrupt/stale-torch records")
    common(p, False)
    p.set_defaults(fn=cmd_prune_stale)

    args = ap.parse_args(argv)
    return args.fn(args, ap)


if __name__ == "__main__":
    sys.exit(main())

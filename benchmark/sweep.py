"""The session-count sweep that sets a cell's ``sessions``: the cell run
once at each count, one line of numbers per count.

    python benchmark/sweep.py --workload <name> --sessions 1,2,4,7 --seed <n> --seconds <s> [--trace 0|1] [--out PATH]

The knee is the smallest count whose aggregate fps is within 10 % of the
sweep's best. Each count is one run of ``run.py``'s fleet with the cell's
``sessions`` replaced; nothing else of the cell changes. ``--out`` also
writes the lines as JSON.
"""
import argparse
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sessions", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import run as entry
    entry._environment()
    from slambench import fleet, spec
    import torch
    if not torch.cuda.is_available():
        print("sweep: CUDA is not available", file=sys.stderr)
        return 3
    bench = spec.load(entry.ROOT)
    rows = []
    for k, n in enumerate(int(x) for x in args.sessions.split(",")):
        cell = spec.cell(entry.ROOT, bench, args.workload)
        cell["traffic"]["sessions"] = n
        res, code = fleet.run(cell, args.seed + k, args.seconds, args.trace,
                              time.monotonic())
        row = {"sessions": n, "code": code,
               "result": None if res is None else entry._finite(res)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    ok = [r for r in rows if r["result"] and "fps" in r["result"]["metrics"]]
    if ok:
        best = max(r["result"]["metrics"]["fps"]["value"] for r in ok)
        knee = min(r["sessions"] for r in ok
                   if r["result"]["metrics"]["fps"]["value"] >= 0.9 * best)
        print(json.dumps({"best_fps": best, "knee_sessions": knee}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

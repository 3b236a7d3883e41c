"""The control of ``correct``: a cell run with the plain reference put in
the program's place one precision below the configuration's (TF32
products in the pyramid and the detector, bfloat16 arithmetic in the
stereo depth and the pose solve). Every run it makes has to come out not
correct; its numbers are the upper readings that the limits in
``limits/<cell>.json`` were set below.

    python benchmark/control.py --workload <name> --seeds 11,12,13 --seconds 10

prints one JSON line per seed: ``correct`` and each number beside its
limit. The benchmark's own runs never run it.
"""
import argparse
import json
import os
import sys
import time


def run_control(workload, seed, seconds, opts=None, cell_edit=None):
    """One control run of ``workload``: (result, exit code)."""
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    import run as entry
    entry._environment()
    from slambench import fleet, spec
    cell = spec.cell(entry.ROOT, spec.load(entry.ROOT), workload)
    if cell_edit is not None:
        cell = cell_edit(cell)
    o = {"control": True}
    o.update(opts or {})
    return fleet.run(cell, seed, seconds, 0, time.monotonic(), o)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    bad = 0
    for s in (int(x) for x in args.seeds.split(",")):
        res, code = run_control(args.workload, s, args.seconds)
        line = {"seed": s, "code": code,
                "correct": None if res is None else res["correct"],
                "checks": None if res is None else res["checks"]}
        print(json.dumps(line), flush=True)
        bad += line["correct"] is not False
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

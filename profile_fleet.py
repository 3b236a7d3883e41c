"""Where the host time of one cell of the port's benchmark goes inside the
port, on one NVIDIA GPU.

Run from the repository root:

    python3 profile_fleet.py --workload <cell> --seed <n> [--seconds S]
                             [--json PATH]
    python3 profile_fleet.py --workload <cell> --seed <n> --cost ROUNDS
                             [--seconds S] [--json PATH]

The first form runs the cell as ``benchmark/run.py --trace 1`` does, with
the port's recorder (``coebslam_tpu_torch.utils.metrics``) on in every
session (``benchmark/slambench/program.py``). It prints the per-layer
metrics, the five that read the program's spans and counters among them;
then per program span the calls, host ms, device ms and kernels per frame;
the reads to the host and their wait per site per frame; the host
counters, per frame in the window (``keyframes``, ``maint_dispatches``,
``pose_gn_replays``, ``pose_gn_captures``, ...) and per session before it
(the warm-up's frames, ``BeforeWindow``); the mean of each device counter
per frame; and every idle gap of the card by name. The second form
measures what the recorder costs: untraced runs of the cell in turns with
the recorder off and on, ROUNDS of each (a pair shares its seed), each
printed with its end-to-end metrics and host ms per frame. ``--json``
also writes all of it. Without CUDA it exits with code 3.
"""
import argparse
import json
import os
import sys
import time

T_START = time.monotonic()
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]

import run as bench_run  # noqa: E402

BEFORE = ".before_window"


class BeforeWindow:
    """In a run's ``opts``: unpickled in a session's process, it makes the
    program's window also keep, as ``<counter>.before_window``, the host
    counters of the frames whose ``step`` ended before the window (the
    warm-up's)."""

    def __reduce__(self):
        return (_install_before_window, ())


def _install_before_window():
    from slambench import program
    plain = program.window

    def window(rec, lo_ns, hi_ns):
        out = plain(rec, lo_ns, hi_ns)
        before = {s["request"] for s in rec["spans"]
                  if s["path"] == "step" and s["t1"] <= lo_ns}
        for n, per in rec["counters"].items():
            out["counters"][n + BEFORE] = sum(v for r, v in per.items()
                                              if r in before)
        return out

    program.window = window
    return BeforeWindow()


def _traced(cell, seed, seconds, log):
    from slambench import program
    keep = []
    res, code = program.run(cell, seed, seconds, 1, T_START,
                            opts={"before_window": BeforeWindow()}, log=log,
                            keep=keep)
    if res is None:
        return None, code
    run = keep[0]
    n = max(run.frames, 1)
    labs = {k[len(program.PREFIX):]: {"calls": v["calls"] / n,
                                      "host_ms": v["host_ms"] / n,
                                      "device_ms": v["device_ms"] / n,
                                      "kernels": v["kernels"] / n}
            for k, v in run.spans.items() if k.startswith(program.PREFIX)}
    prog = run.program
    steps = max(prog["steps"], 1)
    dev = {name: {f: v / max(row["rows"], 1) for f, v in row.items()
                  if f != "rows"}
           for name, row in prog["device_counters"].items()}
    out = {"result": res, "frames": run.frames, "steps": prog["steps"],
           "labels_per_frame": labs,
           "reads_per_frame": {k: v / steps for k, v in prog["reads"].items()},
           "read_ms_per_frame": {k: v / 1e6 / steps
                                 for k, v in prog["read_ns"].items()},
           "counters": prog["counters"], "device_counters_mean": dev,
           "idle_s": run.idle}
    print(f"{res['device']['kind']}: {run.frames} frames, "
          f"{prog['steps']} steps in the window, correct {res['correct']}")
    for k, v in res["metrics"].items():
        print(f"  {k:22s} {v['value']:.6g} {v['unit']}")
    print("program spans per frame: calls, host ms, device ms, kernels")
    for k, v in sorted(labs.items(), key=lambda x: -x[1]["host_ms"]):
        print(f"  {v['calls']:6.3f} {v['host_ms']:9.3f} {v['device_ms']:8.3f}"
              f" {v['kernels']:9.1f}  {k}")
    print(f"reads per frame {out['reads_per_frame']} (sum "
          f"{sum(out['reads_per_frame'].values()):.4f}), wait ms per frame "
          f"{ {k: round(v, 3) for k, v in out['read_ms_per_frame'].items()} }")
    sessions = int(cell["traffic"]["sessions"])
    print("host counters per frame in the window; per session before it:")
    for k, v in sorted(prog["counters"].items()):
        if k.endswith(BEFORE):
            print(f"  {v / sessions:9.4f}  {k}")
        else:
            print(f"  {v / steps:9.4f}  {k}")
    print(f"device counters, mean per frame {dev}")
    print("idle gaps (s):")
    for k, v in sorted(run.idle.items(), key=lambda x: -x[1]):
        print(f"  {v:10.4f}  {k}")
    return out, code


def _cost(cell, seed, seconds, rounds, log):
    from slambench import program
    runs = []
    for r in range(rounds):
        order = (False, True) if r % 2 == 0 else (True, False)
        for on in order:
            keep = []
            res, code = program.run(cell, seed + r, seconds, 0,
                                    time.monotonic(), log=log, keep=keep,
                                    recorder=on)
            if res is None:
                return None, code
            row = {"recorder": on, "seed": seed + r,
                   "metrics": {k: v["value"]
                               for k, v in res["metrics"].items()},
                   "host_ms_per_frame": sum(keep[0].host_ms)
                   / max(keep[0].frames, 1)}
            runs.append(row)
            print(f"recorder {'on ' if on else 'off'} seed {seed + r}: "
                  f"{row['metrics']} host ms/frame "
                  f"{row['host_ms_per_frame']:.3f}", flush=True)
    return {"runs": runs}, 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--cost", type=int, default=0,
                    help="rounds of untraced runs, recorder off and on")
    ap.add_argument("--json", help="also write the readings to this file")
    args = ap.parse_args()
    bench_run._environment()
    import torch
    if not torch.cuda.is_available():
        print("profile_fleet: CUDA is not available", file=sys.stderr)
        return 3
    from slambench import spec
    bench = spec.load(ROOT)
    cell = spec.cell(ROOT, bench, args.workload)
    log = (lambda s: print(s, file=sys.stderr, flush=True))
    if args.cost:
        out, code = _cost(cell, args.seed, args.seconds, args.cost, log)
    else:
        out, code = _traced(cell, args.seed, args.seconds, log)
    if out is not None and args.json:
        with open(args.json, "w") as f:
            json.dump(bench_run._finite(out), f, indent=1)
    return code or (1 if out is None else 0)


if __name__ == "__main__":
    sys.exit(main())

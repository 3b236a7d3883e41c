"""Where the FAST kernel's time goes, block by block, on one NVIDIA GPU.

Run from the repository root:

    python3 fast_timeline.py [--reps 3] [--json PATH]

Builds ``coebslam_tpu_torch/csrc/fast.cu`` with ``-DFAST_TIMELINE``, in
which every block writes the card's global timer at the ends of its
phases: tiles known, first live tile staged, its strength done, its
outputs stored, and the zero warp's dead-tile stores done. The kernel runs
on the main path's canvas (a rendered 640x480 frame's 8 levels), once cold
(behind the 128 MiB write of ``chip_smoke.py``'s timing) and once warm,
``--reps`` times each; each run prints, per phase, the spread over blocks
(minimum, 10th, 50th and 90th percentile, maximum) in microseconds after
the first block started, beside the CUDA-event time of the same call, and
for the blocks of one SM, taken in the order they were staged, the median
time each rank was staged and finished its strength.
The stamps cost a few instructions and one store each, so the phase times
are the instrumented kernel's. First it prints the static counts of the
min/max, shared-memory and global-memory instructions in the SASS of the
kernel as it is built without stamps (``cuobjdump``, from the CUDA
toolkit). Without CUDA it exits with code 2.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

PHASES = ("tiles known", "staged", "strength done", "stored",
          "zero warp done")
SASS_OPS = ("VIMNMX3", "VIMNMX", "FMNMX", "LDS", "STS", "STG", "LDGSTS")


def sass_mix(lib, cuobjdump):
    """{kernel: {opcode: count}} of a built library's SASS (static counts
    from ``cuobjdump -sass``), for the opcodes in SASS_OPS."""
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    mix = {}
    for func in text.split("Function : ")[1:]:
        name = func.split()[0]
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                         func)
        mix[name] = {op: ops.count(op) for op in SASS_OPS}
    return mix


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3, help="runs per mode")
    ap.add_argument("--json", help="also write the summary here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fast_timeline: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_smoke import card, l2_flush
    from coebslam_tpu_torch.config import SystemConfig
    from coebslam_tpu_torch.ops import extractor, fast_cuda
    from coebslam_tpu_torch.utils import synthetic

    dev = torch.device("cuda")
    card_line = card()
    print(card_line, flush=True)
    mix = sass_mix(fast_cuda.build(),
                   Path(fast_cuda._nvcc()).with_name("cuobjdump"))
    for name, ops in mix.items():
        print(f"SASS of {name} (static counts): {ops}", flush=True)
    lib = fast_cuda.load(fast_cuda.build(defines=("FAST_TIMELINE",)))
    lib.coebslam_fast_timeline.argtypes = [ctypes.c_void_p]
    cfg = SystemConfig()
    planes = synthetic.make_room(seed=0, device=dev)
    pose = synthetic.camera_trajectory(10, radius=0.35)[3]
    frame = torch.clamp(synthetic.render(cfg.camera, pose, planes)[0], 0, 255)
    canv, hw = extractor.level_canvas(frame, cfg.orb)
    thr = torch.tensor(float(cfg.orb.fast_threshold_min), device=dev)
    flush = l2_flush(torch)
    stamps = np.zeros((4096, 2 + len(PHASES)), np.uint64)
    runs = []
    for mode in ("cold", "warm"):
        for rep in range(args.reps):
            for _ in range(3):
                fast_cuda.run(lib, canv, thr, hw)
            torch.cuda.synchronize()
            lib.coebslam_fast_timeline(stamps.ctypes.data)   # clears them
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(10 ** 6)
            if mode == "cold":
                flush()
            a.record()
            fast_cuda.run(lib, canv, thr, hw)
            b.record()
            b.synchronize()
            if lib.coebslam_fast_timeline(stamps.ctypes.data) != 0:
                raise RuntimeError("reading the timeline failed")
            t = stamps[stamps[:, 0] > 0].astype(np.int64)
            t0 = t[:, 0].min()
            run = {"mode": mode, "event_us": a.elapsed_time(b) * 1e3,
                   "blocks": len(t), "phases": {}}
            print(f"{mode} {rep}: event {run['event_us']:.2f} us, "
                  f"{len(t)} blocks; us after the first block started "
                  f"(min p10 p50 p90 max):", flush=True)
            for k, name in enumerate(PHASES, start=1):
                v = (t[:, k][t[:, k] > 0] - t0) / 1e3
                if len(v):
                    q = [float(x) for x in
                         np.percentile(v, [0, 10, 50, 90, 100])]
                    run["phases"][name] = q
                    print(f"  {name:15s} n={len(v):4d} "
                          + " ".join(f"{x:6.2f}" for x in q), flush=True)
            # Blocks of one SM, in the order their first tile was staged:
            # the median over SMs of each rank's staged and strength times.
            by_sm = {}
            for row in t[t[:, 2] > 0]:
                by_sm.setdefault(int(row[6]), []).append(row)
            ranks = max(len(v) for v in by_sm.values())
            run["rank_on_sm"] = []
            for r in range(ranks):
                rows = [sorted(v, key=lambda x: x[2])[r] for v in by_sm.values()
                        if len(v) > r]
                st = float(np.median([x[2] - t0 for x in rows])) / 1e3
                sd = float(np.median([x[3] - t0 for x in rows])) / 1e3
                run["rank_on_sm"].append([st, sd])
                print(f"  rank {r} on its SM: staged {st:6.2f}, strength "
                      f"done {sd:6.2f} (median over {len(rows)} SMs)",
                      flush=True)
            runs.append(run)
    summary = {"card": card_line, "shape": list(canv.shape), "sass": mix,
               "runs": runs}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()

"""Time other builds of the FAST kernel beside this one, on one NVIDIA GPU.

Run from the repository root:

    python3 compare_fast_kernels.py OTHER.cu [OTHER2.cu ...] [--n 200]
        [--json PATH]

Each OTHER.cu is a source with the C interface of
``coebslam_tpu_torch/csrc/fast.cu``, for example an earlier commit's,
written with ``git show COMMIT:coebslam_tpu_torch/csrc/fast.cu`` into a
git-ignored directory such as ``build/``. Every source is built with the
same nvcc flags, and its ptxas report (registers, shared memory, spills)
is printed. Each kernel is checked bit-equal to the plain version on the
main path's canvas (a rendered 640x480 frame's 8 levels) at thr 7 and 10;
the run fails if this source's kernel differs, and marks another that
differs (a diagnostic variant, for example) in its output. Then, for
each other source X in turn, X and this source are timed in the order
X, this, this, X, each as ``chip_smoke.py`` phase 5 times the kernel
(median of --n calls, each behind a device-side sleep): cold (behind a
128 MiB write) and warm. Two yardsticks are timed the same way: an empty
kernel (what the timing cannot go below) and one ``fill_`` of as many
bytes as the two outputs.
Prints the card, the times, the bound from ``fast_cuda.work`` and a JSON
summary as the last line (also written to --json). Without CUDA it exits
with code 2.
"""
import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="+", help="other kernel sources")
    ap.add_argument("--n", type=int, default=200, help="calls per timing")
    ap.add_argument("--json", help="also write the summary here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_fast_kernels: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_smoke import (FP32_OPS_PER_S, MEM_BYTES_PER_S, _device_ms,
                            _fail, card, l2_flush, ptxas_report)
    from coebslam_tpu_torch.config import SystemConfig
    from coebslam_tpu_torch.ops import extractor, fast, fast_cuda
    from coebslam_tpu_torch.utils import synthetic

    dev = torch.device("cuda")
    card_line = card()
    print(card_line, flush=True)
    this = str(Path(fast_cuda.__file__).parents[1] / "csrc" / "fast.cu")
    libs = {}
    for src in [this] + args.others:
        path = fast_cuda.build(Path(src))
        libs[src] = fast_cuda.load(path)
        for line in ptxas_report(path):
            print(f"{src}: ptxas: {line}", flush=True)

    cfg = SystemConfig()
    planes = synthetic.make_room(seed=0, device=dev)
    pose = synthetic.camera_trajectory(10, radius=0.35)[3]
    frame = torch.clamp(synthetic.render(cfg.camera, pose, planes)[0], 0, 255)
    canv, hw = extractor.level_canvas(frame, cfg.orb)
    equal = {}
    for src, lib in libs.items():
        equal[src] = True
        for t in (7.0, 10.0):
            thr = torch.tensor(t, device=dev)
            st_k, sc_k = fast_cuda.run(lib, canv, thr, hw)
            st_p, sc_p = fast.strength_and_score_plain(canv, thr, hw)
            equal[src] &= torch.equal(st_k, st_p) and torch.equal(sc_k, sc_p)
        if src == this and not equal[src]:
            _fail(f"{src} differs from the plain version")
        print(f"{src}: {'bit-equal to' if equal[src] else 'DIFFERS from'} "
              f"the plain version at thr 7 and 10", flush=True)

    thr = torch.tensor(float(cfg.orb.fast_threshold_min), device=dev)
    flushes = {"cold": l2_flush(torch), "warm": None}

    def timed(fn):
        return {mode: _device_ms(torch, fn, args.n, f)
                for mode, f in flushes.items()}

    out = torch.empty(2 * canv.numel(), device=dev)
    yardsticks = {"empty kernel": timed(lambda: torch.cuda._sleep(0)),
                  "fill_ of the outputs' bytes": timed(lambda: out.fill_(0))}
    for name, t in yardsticks.items():
        print(f"{name}: " + ", ".join(f"{m} {v:.4f} ms" for m, v in t.items()),
              flush=True)
    times = {src: {mode: [] for mode in flushes} for src in libs}
    for other in args.others:
        for src in (other, this, this, other):
            t = timed(lambda lib=libs[src]: fast_cuda.run(lib, canv, thr, hw))
            for mode, v in t.items():
                times[src][mode].append(v)
            print(f"{src}: " + ", ".join(f"{m} {v:.4f} ms"
                                         for m, v in t.items()), flush=True)
    n_bytes, n_ops = fast_cuda.work(hw.tolist(), *canv.shape)
    bound_ms = max(n_bytes / MEM_BYTES_PER_S, n_ops / FP32_OPS_PER_S) * 1e3
    summary = {"card": card_line, "shape": list(canv.shape),
               "bound_ms": bound_ms, "bytes": n_bytes, "ops": n_ops,
               "yardsticks": yardsticks,
               "kernels": {src: {
                   "bit_equal": equal[src],
                   "cold_ms": t["cold"], "warm_ms": t["warm"],
                   "cold_median_ms": float(np.median(t["cold"])),
                   "bound_share": bound_ms / float(np.median(t["cold"]))}
                   for src, t in times.items()}}
    for src, k in summary["kernels"].items():
        print(f"{src}: cold median {k['cold_median_ms']:.4f} ms = "
              f"{k['bound_share']:.1%} of the {bound_ms:.4f} ms bound "
              f"on {card_line}", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()

"""Write the TUM-format replica sequence to disk.

Counterpart of ``tools/make_tum_replica.py`` of the JAX package: renders
the deterministic stand-in for a TUM fr3 dynamic sequence (fr3
calibration, a walking person, motion-blur windows, a camera-shake
segment; ``utils/replica.py``) and writes it as a TUM sequence directory
through ``replica.write``. It renders on the card (CUDA, which must
exist) unless --cpu is given.

Usage:
  python3 -m coebslam_tpu_torch.tools.make_tum_replica OUT_DIR
      [--frames 400] [--seed 0] [--walkers 1] [--cpu]
Then:
  python3 -m coebslam_tpu_torch.examples.run_tum_rgbd OUT_DIR
      --boxes OUT_DIR/boxes.txt
"""
from __future__ import annotations

import argparse
import sys
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python3 -m coebslam_tpu_torch.tools.make_tum_replica",
        description="Write the TUM-format replica sequence.")
    ap.add_argument("out")
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--walkers", type=int, default=1)
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Returns ``replica.write``'s result and the seconds it took."""
    from ..utils import replica
    from ..utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None, "make_tum_replica")
    t0 = time.perf_counter()
    out = replica.write(args.out, n_frames=args.frames, seed=args.seed,
                        walkers=args.walkers, device=device, progress=True)
    secs = time.perf_counter() - t0
    print(f"wrote {len(out['stamps'])} frames to {args.out} "
          f"({out['bytes'] / 2 ** 20:.1f} MiB) in {secs:.1f}s", flush=True)
    out["seconds"] = secs
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

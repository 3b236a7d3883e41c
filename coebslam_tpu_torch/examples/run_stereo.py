"""Offline stereo driver for KITTI and EuRoC sequences (the reference's
``stereo_kitti`` and ``stereo_euroc``).

Counterpart of ``examples/run_stereo.py`` of the JAX package: rectified
left/right pairs (through ``io/png.py``) into ``System.track_stereo``;
writes ``KeyFrameTrajectory.txt``, ``CameraTrajectoryKITTI.txt`` and
``CameraTrajectory.txt``.

Usage:
  python3 -m coebslam_tpu_torch.examples.run_stereo kitti SEQUENCE_DIR
      [--settings F] [--max-frames N] [--out DIR] [--cpu]
  python3 -m coebslam_tpu_torch.examples.run_stereo euroc SEQUENCE_DIR
      [--timestamps F] [...]

Without --cpu it runs on CUDA, which must exist. The per-frame ms it
prints is the host clock around ``track_stereo`` (PNG decoding
excluded).
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python3 -m coebslam_tpu_torch.examples.run_stereo",
        description="Track a KITTI or EuRoC stereo sequence.")
    ap.add_argument("dataset", choices=["kitti", "euroc"])
    ap.add_argument("sequence")
    ap.add_argument("--settings")
    ap.add_argument("--timestamps", help="EuRoC timestamp file")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--out")
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def track(system, entry, frames, n: int):
    """Feed ``frames(i) -> (stamp, *images)`` for i < n through
    ``entry``; returns (states, host seconds of the tracking calls)."""
    states, total = [], 0.0
    for i in range(n):
        stamp, *images = frames(i)
        t0 = time.perf_counter()
        state, inl = entry(*images, stamp)
        dt = time.perf_counter() - t0
        total += dt
        states.append(state)
        if i % 25 == 0 or state != "OK":
            print(f"frame {i:4d}  {state:16s} inliers={inl:4d} "
                  f"kfs={len(system.map.valid_keyframes()):3d} "
                  f"pts={len(system.map.valid_points()):5d} "
                  f"{dt * 1e3:6.1f} ms", flush=True)
    return states, total


def run(args: argparse.Namespace) -> dict:
    """Returns the ``System``, the per-frame states, the output directory
    and the seconds of the tracking calls."""
    from ..io import euroc, kitti
    from ..slam.system import System
    from ..utils.device import resolve_device
    from .run_tum_rgbd import load_settings

    device = resolve_device("cpu" if args.cpu else None, "run_stereo")
    cfg = load_settings(args.settings).replace(sensor="stereo")
    if args.dataset == "kitti":
        seq = kitti.load_kitti_sequence(args.sequence)
        if seq.right_files is None:
            sys.exit(f"{args.sequence}/image_1 not found: not a stereo "
                     "sequence")
        pairs = seq.load_stereo
    else:
        seq = euroc.load_euroc_sequence(args.sequence, args.timestamps)
        if seq.cam1_files is None:
            sys.exit(f"{args.sequence}/mav0/cam1 not found: not a stereo "
                     "sequence")

        def pairs(i):
            stamp, gl = seq.load_frame(i)
            return stamp, gl, euroc.load_gray(seq.cam1_files[i])

    n = len(seq) if args.max_frames <= 0 else min(len(seq), args.max_frames)
    system = System(cfg, device=device)
    states, secs = track(system, system.track_stereo, pairs, n)

    out_dir = args.out or "."
    os.makedirs(out_dir, exist_ok=True)
    system.save_keyframe_trajectory_tum(
        os.path.join(out_dir, "KeyFrameTrajectory.txt"))
    system.save_trajectory_kitti(
        os.path.join(out_dir, "CameraTrajectoryKITTI.txt"))
    system.save_trajectory_tum(os.path.join(out_dir, "CameraTrajectory.txt"))
    print(f"trajectories saved to {out_dir}")
    return {"system": system, "states": states, "out_dir": out_dir,
            "track_s": secs, "n": n}


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

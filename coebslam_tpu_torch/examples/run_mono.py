"""Offline monocular driver for TUM, KITTI and EuRoC sequences (the
reference's ``mono_tum``, ``mono_kitti`` and ``mono_euroc``).

Counterpart of ``examples/run_mono.py`` of the JAX package: two-view
initialisation, tracking and triangulated map growth through
``System.track_monocular``; writes ``KeyFrameTrajectory.txt`` and
``CameraTrajectoryKITTI.txt`` (kitti) or ``CameraTrajectory.txt``.

Usage:
  python3 -m coebslam_tpu_torch.examples.run_mono {tum,kitti,euroc}
      SEQUENCE_DIR [--settings F] [--timestamps F] [--max-frames N]
      [--out DIR] [--cpu]

Without --cpu it runs on CUDA, which must exist. The per-frame ms it
prints is the host clock around ``track_monocular`` (PNG decoding
excluded).
"""
from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python3 -m coebslam_tpu_torch.examples.run_mono",
        description="Track a monocular TUM, KITTI or EuRoC sequence.")
    ap.add_argument("dataset", choices=["tum", "kitti", "euroc"])
    ap.add_argument("sequence")
    ap.add_argument("--settings")
    ap.add_argument("--timestamps", help="EuRoC timestamp file")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--out")
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Returns the ``System``, the per-frame states, the output directory
    and the seconds of the tracking calls."""
    from ..io import euroc, kitti, tum
    from ..slam.system import System
    from ..utils.device import resolve_device
    from .run_stereo import track
    from .run_tum_rgbd import load_settings

    device = resolve_device("cpu" if args.cpu else None, "run_mono")
    cfg = load_settings(args.settings).replace(sensor="monocular")
    if args.dataset == "tum":
        seq = tum.load_tum_sequence(args.sequence)

        def frames(i):                      # (stamp, gray)
            return seq.load_frame(i)[:2]
    elif args.dataset == "kitti":
        seq = kitti.load_kitti_sequence(args.sequence)
        frames = seq.load_frame
    else:
        seq = euroc.load_euroc_sequence(args.sequence, args.timestamps)
        frames = seq.load_frame

    n = len(seq) if args.max_frames <= 0 else min(len(seq), args.max_frames)
    system = System(cfg, device=device)
    states, secs = track(system, system.track_monocular, frames, n)

    out_dir = args.out or "."
    os.makedirs(out_dir, exist_ok=True)
    system.save_keyframe_trajectory_tum(
        os.path.join(out_dir, "KeyFrameTrajectory.txt"))
    if args.dataset == "kitti":
        system.save_trajectory_kitti(
            os.path.join(out_dir, "CameraTrajectoryKITTI.txt"))
    else:
        system.save_trajectory_tum(
            os.path.join(out_dir, "CameraTrajectory.txt"))
    print(f"trajectories saved to {out_dir}")
    return {"system": system, "states": states, "out_dir": out_dir,
            "track_s": secs, "n": n}


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""End-to-end demo without a dataset: track a rendered RGB-D orbit of the
synthetic room with the host ``Tracker`` and ``LocalMapper``, print each
frame's state, score the ATE against the ground truth and write the
trajectory in TUM format.

Counterpart of ``examples/run_synthetic.py`` of the JAX package.

Usage:
  python3 -m coebslam_tpu_torch.examples.run_synthetic [N_FRAMES]
      [--out DIR] [--cpu]

Frames are rendered on the device the run uses (CUDA unless --cpu).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python3 -m coebslam_tpu_torch.examples.run_synthetic",
        description="Track a rendered orbit of the synthetic room.")
    ap.add_argument("n_frames", nargs="?", type=int, default=30)
    ap.add_argument("--out", default=".")
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Returns the ``Tracker``, the per-frame states and the ATE."""
    from ..config import SystemConfig
    from ..eval import ate
    from ..io import trajectory
    from ..slam.local_mapping import LocalMapper
    from ..slam.map import MapArena
    from ..slam.tracking import Tracker
    from ..utils import synthetic
    from ..utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None, "run_synthetic")
    n_frames = args.n_frames
    cfg = SystemConfig()
    planes = synthetic.make_room(seed=0, device=device)
    poses = synthetic.camera_trajectory(n_frames, radius=0.35)

    arena = MapArena(cfg)
    tracker = Tracker(cfg, arena, device)
    mapper = LocalMapper(cfg, arena, device)
    tracker.on_keyframe = mapper.process_keyframe

    states = []
    for i, pose in enumerate(poses):
        gray, depth = synthetic.render(cfg.camera, pose, planes)[:2]
        state, n = tracker.process_frame(gray, depth, stamp=i / 30.0)
        states.append(state)
        print(f"frame {i:3d}  {state:16s} inliers={n:4d} "
              f"kfs={len(arena.valid_keyframes()):3d} "
              f"points={len(arena.valid_points()):5d} "
              f"budget={tracker.state.budget}", flush=True)

    # ATE against the ground truth (world = the first camera's frame).
    R0, t0 = poses[0].R.numpy(), poses[0].t.numpy()
    gt = []
    for p in poses:
        R = p.R.numpy() @ R0.T
        t = p.t.numpy() - R @ t0
        gt.append(-R.T @ t)
    est = [-R.T @ t for _, R, t in tracker.trajectory]
    stamps = np.arange(n_frames) / 30.0
    res = ate.ate_rmse(stamps[:len(est)], np.asarray(est), stamps,
                       np.asarray(gt))
    print(f"\nATE RMSE: {res['rmse'] * 100:.2f} cm  "
          f"(median {res['median'] * 100:.2f} cm over {res['pairs']} poses)")

    os.makedirs(args.out, exist_ok=True)
    out = os.path.join(args.out, "CameraTrajectory.txt")
    trajectory.save_tum(out, [s for s, _, _ in tracker.trajectory],
                        [(R, t) for _, R, t in tracker.trajectory])
    print(f"trajectory saved to {out}")
    return {"tracker": tracker, "states": states, "ate": res}


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The replica scenes' camera path and motion blur.

Counterpart of the numpy parts of ``coebslam_tpu/utils/replica.py`` that
the wide-baseline stereo scene uses: the handheld walking trajectory and
the separable box blur. The PNG writer of the TUM-format replica is not
part of the port.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..geometry.se3 import SE3
from . import synthetic


def walking_trajectory(n_frames: int, seed: int = 3) -> List[SE3]:
    """Handheld fr3_walking_xyz-like camera path: multi-frequency sway in
    x/y/z plus gentle yaw/pitch, bounded so the room stays in view.
    Returns world-to-camera poses (SE3 of float32 CPU tensors)."""
    rng = np.random.RandomState(seed)
    ph = rng.uniform(0, 2 * np.pi, size=8)
    poses = []
    for i in range(n_frames):
        s = i / 30.0                      # seconds
        c = np.array([
            0.35 * np.sin(0.55 * s + ph[0]) + 0.12 * np.sin(1.3 * s + ph[1]),
            0.15 * np.sin(0.75 * s + ph[2]) + 0.05 * np.sin(1.7 * s + ph[3]),
            -1.2 + 0.25 * np.sin(0.4 * s + ph[4]),
        ], np.float32)
        yaw = 0.10 * np.sin(0.6 * s + ph[5]) + 0.04 * np.sin(1.9 * s + ph[6])
        pitch = 0.05 * np.sin(0.8 * s + ph[7])
        Rwc = (synthetic._rot_y(yaw) @ synthetic._rot_x(pitch)).astype(
            np.float32)
        Rcw = Rwc.T
        poses.append(SE3(torch.from_numpy(np.ascontiguousarray(Rcw)),
                         torch.from_numpy((-Rcw @ c).astype(np.float32))))
    return poses


def box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """Separable box blur (motion-blur stand-in), edge-padded."""
    if k <= 1:
        return img
    pad = k // 2
    x = np.pad(img, ((0, 0), (pad, pad)), mode="edge")
    c = np.cumsum(x, axis=1, dtype=np.float64)
    x = (np.concatenate([c[:, k - 1:k], c[:, k:] - c[:, :-k]], axis=1)) / k
    x = np.pad(x, ((pad, pad), (0, 0)), mode="edge")
    c = np.cumsum(x, axis=0, dtype=np.float64)
    x = (np.concatenate([c[k - 1:k, :], c[k:, :] - c[:-k, :]], axis=0)) / k
    return x.astype(np.float32)

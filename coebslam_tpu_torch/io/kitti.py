"""KITTI odometry sequence loading.

Counterpart of ``coebslam_tpu/io/kitti.py`` (the reference's
``mono_kitti.cc`` LoadImages: ``times.txt`` and ``image_0/%06d.png``,
``image_1/`` for the right camera). Images are decoded by ``io/png.py``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from . import png


@dataclass
class KittiSequence:
    root: str
    stamps: np.ndarray           # [N]
    left_files: List[str]
    right_files: Optional[List[str]] = None
    gt_poses: Optional[np.ndarray] = None    # [N, 3, 4] row-major cam-to-world

    def __len__(self):
        return len(self.left_files)

    def load_frame(self, i: int) -> Tuple[float, np.ndarray]:
        """Returns (timestamp, gray [H, W] float32 0..255) for the left cam."""
        gray = _load_gray(os.path.join(self.root, self.left_files[i]))
        return float(self.stamps[i]), gray

    def load_stereo(self, i: int) -> Tuple[float, np.ndarray, np.ndarray]:
        if self.right_files is None:
            raise ValueError(f"{self.root} has no image_1")
        gl = _load_gray(os.path.join(self.root, self.left_files[i]))
        gr = _load_gray(os.path.join(self.root, self.right_files[i]))
        return float(self.stamps[i]), gl, gr


def _load_gray(path: str) -> np.ndarray:
    img = png.read(path)
    if img.ndim == 3:
        img = (0.299 * img[..., 0] + 0.587 * img[..., 1]
               + 0.114 * img[..., 2])
    return img.astype(np.float32)


def load_kitti_sequence(root: str,
                        poses_file: Optional[str] = None) -> KittiSequence:
    """Load a KITTI odometry sequence directory: ``times.txt`` and
    ``image_0/`` (left grey), ``image_1/`` (right grey) when present;
    ``poses_file`` is the benchmark's 12-numbers-per-line ground truth."""
    with open(os.path.join(root, "times.txt")) as f:
        stamps = np.asarray([float(line) for line in f if line.strip()])

    def listdir(sub):
        d = os.path.join(root, sub)
        if not os.path.isdir(d):
            return None
        return [os.path.join(sub, n) for n in sorted(os.listdir(d))
                if n.endswith((".png", ".jpg"))]

    left = listdir("image_0")
    if left is None:
        raise FileNotFoundError(f"{root}/image_0 not found")
    right = listdir("image_1")
    n = min(len(stamps), len(left))

    gt = None
    if poses_file and os.path.exists(poses_file):
        gt = np.loadtxt(poses_file).reshape(-1, 3, 4)

    return KittiSequence(root=root, stamps=stamps[:n], left_files=left[:n],
                         right_files=right[:n] if right else None,
                         gt_poses=gt)

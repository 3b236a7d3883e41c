"""EuRoC MAV sequence loading.

Counterpart of ``coebslam_tpu/io/euroc.py`` (the reference's
``mono_euroc.cc`` LoadImages: a timestamp list and
``mav0/cam0/data/<stamp>.png``; ground truth from
``mav0/state_groundtruth_estimate0/data.csv``). Images are decoded by
``io/png.py``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from . import png


def load_gray(path: str) -> np.ndarray:
    """An image file as float32 grey (the luma of a colour image)."""
    img = png.read(path).astype(np.float32)
    if img.ndim == 3:
        img = 0.299 * img[..., 0] + 0.587 * img[..., 1] \
            + 0.114 * img[..., 2]
    return img


@dataclass
class EurocSequence:
    root: str
    stamps: np.ndarray           # [N] seconds
    cam0_files: List[str]
    cam1_files: Optional[List[str]] = None
    gt_stamps: Optional[np.ndarray] = None
    gt_poses: Optional[np.ndarray] = None     # [M, 7] tx ty tz qw qx qy qz

    def __len__(self):
        return len(self.cam0_files)

    def load_frame(self, i: int) -> Tuple[float, np.ndarray]:
        return float(self.stamps[i]), load_gray(self.cam0_files[i])


def _csv_rows(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line.split(",")


def load_euroc_sequence(root: str,
                        timestamp_file: Optional[str] = None
                        ) -> EurocSequence:
    """Load an EuRoC sequence root (the directory holding ``mav0/``).

    ``timestamp_file``: an explicit list of nanosecond stamps (the
    reference ships EuRoC_TimeStamps/*.txt); by default cam0's data.csv.
    """
    cam0 = os.path.join(root, "mav0", "cam0", "data")
    cam1 = os.path.join(root, "mav0", "cam1", "data")

    if timestamp_file:
        with open(timestamp_file) as f:
            ns = [line.strip() for line in f if line.strip()]
    else:
        ns = [row[0] for row in _csv_rows(
            os.path.join(root, "mav0", "cam0", "data.csv"))]

    stamps = np.asarray([int(s) * 1e-9 for s in ns])
    files0 = [os.path.join(cam0, f"{s}.png") for s in ns]
    keep = [i for i, p in enumerate(files0) if os.path.exists(p)]
    stamps = stamps[keep]
    files0 = [files0[i] for i in keep]
    files1 = None
    if os.path.isdir(cam1):
        files1 = [os.path.join(cam1, os.path.basename(p)) for p in files0]

    gt_stamps = gt_poses = None
    gt_csv = os.path.join(root, "mav0", "state_groundtruth_estimate0",
                          "data.csv")
    if os.path.exists(gt_csv):
        arr = np.asarray([[float(v) for v in row[:8]]
                          for row in _csv_rows(gt_csv)])
        gt_stamps = arr[:, 0] * 1e-9
        gt_poses = arr[:, 1:8]          # tx ty tz qw qx qy qz

    return EurocSequence(root=root, stamps=stamps, cam0_files=files0,
                         cam1_files=files1, gt_stamps=gt_stamps,
                         gt_poses=gt_poses)

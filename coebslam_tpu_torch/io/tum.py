"""TUM RGB-D sequence loading and association.

Counterpart of ``coebslam_tpu/io/tum.py``: the reference's
``associate.py`` pairing (closest stamps within 0.02 s, through
``eval/ate.associate``) and its ``rgbd_tum.cc`` file loading. Images are
decoded by ``io/png.py``; the grey conversion and the casts are the JAX
package's, in numpy float64.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..eval.ate import associate
from . import png


def _gray64(rgb: np.ndarray) -> np.ndarray:
    """ITU-R 601 luma of an RGB(A) image, in float64."""
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


@dataclass
class TumSequence:
    root: str
    rgb_stamps: np.ndarray       # [N]
    rgb_files: List[str]
    depth_stamps: np.ndarray     # [N]
    depth_files: List[str]
    gt_stamps: Optional[np.ndarray] = None       # [M]
    gt_poses: Optional[np.ndarray] = None        # [M, 7] tx ty tz qx qy qz qw

    def __len__(self):
        return len(self.rgb_files)

    def load_frame(self, i: int, depth_factor: float = 5000.0
                   ) -> Tuple[float, np.ndarray, np.ndarray]:
        """Returns (timestamp, gray [H,W] float32 0..255, depth [H,W] float32
        metres)."""
        rgb = png.read(os.path.join(self.root, self.rgb_files[i]))
        gray = (_gray64(rgb) if rgb.ndim == 3 else rgb).astype(np.float32)
        depth_raw = png.read(os.path.join(self.root, self.depth_files[i]))
        depth = depth_raw.astype(np.float32) / depth_factor
        return float(self.rgb_stamps[i]), gray, depth

    def load_frame_raw(self, i: int
                       ) -> Tuple[float, np.ndarray, np.ndarray]:
        """Returns (timestamp, gray uint8, depth uint16): the sensor's
        wire types, which the realtime path casts and scales on the device
        (3 bytes per pixel uploaded instead of 8). The grey of a colour
        image is truncated, not rounded."""
        rgb = png.read(os.path.join(self.root, self.rgb_files[i]))
        gray = (_gray64(rgb) if rgb.ndim == 3 else rgb).astype(np.uint8)
        depth = png.read(os.path.join(self.root, self.depth_files[i]))
        return float(self.rgb_stamps[i]), gray, depth.astype(np.uint16)


def _lines(path: str):
    """The non-empty lines of a text list, comments ('#') removed."""
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                yield line


def _read_file_list(path: str) -> Tuple[np.ndarray, List[str]]:
    stamps, files = [], []
    for line in _lines(path):
        parts = line.split()
        stamps.append(float(parts[0]))
        files.append(parts[1])
    return np.asarray(stamps), files


def load_tum_sequence(root: str, max_difference: float = 0.02) -> TumSequence:
    """Load and associate a TUM sequence directory (rgb.txt, depth.txt and,
    when present, groundtruth.txt)."""
    rgb_stamps, rgb_files = _read_file_list(os.path.join(root, "rgb.txt"))
    dep_stamps, dep_files = _read_file_list(os.path.join(root, "depth.txt"))
    pairs = associate(rgb_stamps, dep_stamps, max_difference)
    ri = [p[0] for p in pairs]
    di = [p[1] for p in pairs]

    gt_stamps = gt_poses = None
    gt_path = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_path):
        arr = np.asarray([[float(x) for x in line.split()]
                          for line in _lines(gt_path)])
        gt_stamps, gt_poses = arr[:, 0], arr[:, 1:8]

    return TumSequence(
        root=root,
        rgb_stamps=rgb_stamps[ri], rgb_files=[rgb_files[i] for i in ri],
        depth_stamps=dep_stamps[di], depth_files=[dep_files[i] for i in di],
        gt_stamps=gt_stamps, gt_poses=gt_poses)


def load_association_file(root: str, assoc_path: str) -> TumSequence:
    """Load a sequence through a precomputed association file (the
    Examples/RGB-D/associations/*.txt format: stamp rgb stamp depth)."""
    rs, rf, ds, df = [], [], [], []
    for line in _lines(assoc_path):
        p = line.split()
        rs.append(float(p[0]))
        rf.append(p[1])
        ds.append(float(p[2]))
        df.append(p[3])
    return TumSequence(root=root, rgb_stamps=np.asarray(rs), rgb_files=rf,
                       depth_stamps=np.asarray(ds), depth_files=df)

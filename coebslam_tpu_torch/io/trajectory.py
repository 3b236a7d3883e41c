"""Trajectory writers and readers, TUM and KITTI formats.

Counterpart of ``coebslam_tpu/io/trajectory.py``, numpy with the
quaternion computed in the reference's mixed precision (see ``_quat``), so
both packages write the same text.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..geometry import so3


def _quat(R_wc: np.ndarray) -> np.ndarray:
    """The quaternion of a float64 rotation as the JAX package's writer
    computes it: the sums and differences of entries in float64, rounded
    to float32 where they enter the float32 arithmetic."""
    terms = so3.quat_terms(torch.from_numpy(np.asarray(R_wc, np.float64)))
    f32 = lambda x: x.to(torch.float32)
    terms = {k: tuple(map(f32, v)) if isinstance(v, tuple) else f32(v)
             for k, v in terms.items()}
    return so3.quat_from_terms(terms).numpy()


def save_tum(path: str, stamps: Sequence[float], poses_cw) -> None:
    """Write ``stamp tx ty tz qx qy qz qw`` lines of camera-to-world poses.

    Args:
      poses_cw: iterable of (R_cw [3, 3], t_cw [3]) world-to-camera poses.
    """
    lines = []
    for stamp, (R_cw, t_cw) in zip(stamps, poses_cw):
        R_cw = np.asarray(R_cw, np.float64)
        t_cw = np.asarray(t_cw, np.float64)
        R_wc = R_cw.T
        t_wc = -R_wc @ t_cw
        q = _quat(R_wc)                        # (w, x, y, z)
        lines.append("%.6f %.7f %.7f %.7f %.7f %.7f %.7f %.7f" % (
            stamp, t_wc[0], t_wc[1], t_wc[2], q[1], q[2], q[3], q[0]))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_tum(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read TUM format -> (stamps [N], xyz + quat [N, 7])."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            rows.append([float(x) for x in line.split()])
    arr = np.asarray(rows)
    return arr[:, 0], arr[:, 1:8]


def save_kitti(path: str, poses_cw) -> None:
    """Write rows of the 3x4 camera-to-world matrices."""
    lines = []
    for R_cw, t_cw in poses_cw:
        R_cw = np.asarray(R_cw, np.float64)
        t_cw = np.asarray(t_cw, np.float64)
        R_wc = R_cw.T
        t_wc = -R_wc @ t_cw
        M = np.hstack([R_wc, t_wc[:, None]])
        lines.append(" ".join("%.9e" % x for x in M.ravel()))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def tum_to_matrices(xyzq: np.ndarray) -> np.ndarray:
    """[N, 7] tx ty tz qx qy qz qw -> [N, 4, 4] camera-to-world matrices."""
    out = np.tile(np.eye(4), (len(xyzq), 1, 1))
    for i, row in enumerate(xyzq):
        q = np.array([row[6], row[3], row[4], row[5]], np.float32)
        out[i, :3, :3] = so3.quat_to_matrix(torch.from_numpy(q)).numpy()
        out[i, :3, 3] = row[:3]
    return out

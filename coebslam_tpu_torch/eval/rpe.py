"""Relative pose error over a fixed frame delta (evaluate_rpe.py's
semantics: for each index i, the estimated motion i -> i + delta against
the ground truth's; translational and rotational RMSE). Counterpart of
``coebslam_tpu/eval/rpe.py``."""
from __future__ import annotations

from typing import Dict

import numpy as np


def _se3_inv(T):
    R, t = T[:3, :3], T[:3, 3]
    out = np.eye(4)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


def rpe(est_T, gt_T, delta: int = 1) -> Dict[str, float]:
    """Args: est_T, gt_T: [N, 4, 4] aligned camera-to-world poses, indexed
    alike. Returns the translational and rotational RMSE and means."""
    est_T = np.asarray(est_T, np.float64)
    gt_T = np.asarray(gt_T, np.float64)
    n = min(len(est_T), len(gt_T)) - delta
    terrs, rerrs = [], []
    for i in range(n):
        de = _se3_inv(est_T[i]) @ est_T[i + delta]
        dg = _se3_inv(gt_T[i]) @ gt_T[i + delta]
        err = _se3_inv(dg) @ de
        terrs.append(np.linalg.norm(err[:3, 3]))
        cos = np.clip((np.trace(err[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        rerrs.append(np.arccos(cos))
    terrs = np.array(terrs)
    rerrs = np.array(rerrs)
    return {
        "trans_rmse": float(np.sqrt((terrs ** 2).mean())),
        "trans_mean": float(terrs.mean()),
        "rot_rmse": float(np.sqrt((rerrs ** 2).mean())),
        "rot_mean": float(rerrs.mean()),
        "pairs": int(n),
    }

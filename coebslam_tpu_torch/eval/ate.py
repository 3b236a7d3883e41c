"""Absolute trajectory error — the acceptance metric.

The port's own copy of ``coebslam_tpu/eval/ate.py`` (numpy only), so a
machine without JAX can score a run.

Re-implements the scoring pipeline the reference is judged by
(`evaluate_ate.py`: Horn alignment at lines 47-77, RMSE at line 190, with
`associate.py` timestamp pairing): given estimated and ground-truth
trajectories, find the rigid alignment minimizing squared error (Horn 1987
closed form via SVD) and report translational RMSE.

numpy (host-side, evaluation only — not a hot path).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def associate(stamps_a, stamps_b, max_difference: float = 0.02):
    """Greedy closest-timestamp association (associate.py semantics: sort all
    candidate pairs by |dt|, accept greedily, each stamp used once).

    Returns list of (idx_a, idx_b).
    """
    stamps_a = np.asarray(stamps_a)
    stamps_b = np.asarray(stamps_b)
    pairs = []
    for i, ta in enumerate(stamps_a):
        j = int(np.argmin(np.abs(stamps_b - ta)))
        dt = abs(float(stamps_b[j] - ta))
        if dt <= max_difference:
            pairs.append((dt, i, j))
    pairs.sort()
    used_a, used_b, out = set(), set(), []
    for dt, i, j in pairs:
        if i in used_a or j in used_b:
            continue
        used_a.add(i)
        used_b.add(j)
        out.append((i, j))
    out.sort()
    return out


def horn_align(model: np.ndarray, data: np.ndarray, with_scale: bool = False
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Least-squares rigid alignment data ~= s * R @ model + t (Horn closed
    form, the same SVD construction as evaluate_ate.py:47-77; s == 1
    unless ``with_scale`` — the Sim3 variant monocular scoring needs,
    since a mono map's scale is normalized, not metric).

    Args:
      model, data: [3, N] point sets (estimated / ground truth).
    Returns:
      (R [3,3], t [3,1], trans_error [N]) — per-pair residual norms after
      alignment.
    """
    model = np.asarray(model, np.float64)
    data = np.asarray(data, np.float64)
    model_zero = model - model.mean(1, keepdims=True)
    data_zero = data - data.mean(1, keepdims=True)
    W = model_zero @ data_zero.T
    U, D, Vt = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = 1.0
    if with_scale:
        var = (model_zero * model_zero).sum()
        s = float(np.trace(np.diag(D) @ S) / max(var, 1e-12))
    t = data.mean(1, keepdims=True) - s * (R @ model.mean(1, keepdims=True))
    aligned = s * (R @ model) + t
    err = aligned - data
    trans_error = np.sqrt((err * err).sum(0))
    return R, t, trans_error


def ate_rmse(est_stamps, est_xyz, gt_stamps, gt_xyz,
             max_difference: float = 0.02,
             with_scale: bool = False) -> Dict[str, float]:
    """Associate, align, score — the full evaluate_ate.py pipeline.

    Args:
      est_xyz / gt_xyz: [N, 3] positions.
    Returns dict with rmse/mean/median/std/min/max/pairs.
    """
    matches = associate(est_stamps, gt_stamps, max_difference)
    if len(matches) < 2:
        raise ValueError(f"only {len(matches)} associated pairs")
    ia = np.array([m[0] for m in matches])
    ib = np.array([m[1] for m in matches])
    model = np.asarray(est_xyz)[ia].T
    data = np.asarray(gt_xyz)[ib].T
    # Robustness: a tracker failure can emit non-finite poses; numpy's
    # SVD then raises "did not converge" with no hint of the cause.
    # Score over the finite pairs and REPORT the excluded count — a
    # silent drop would hide the failure the metric exists to expose.
    finite = np.isfinite(model).all(0) & np.isfinite(data).all(0)
    n_bad = int((~finite).sum())
    if finite.sum() < 2:
        raise ValueError(
            f"only {int(finite.sum())} finite pairs ({n_bad} non-finite)")
    _, _, err = horn_align(model[:, finite], data[:, finite],
                           with_scale=with_scale)
    return {
        "rmse": float(np.sqrt((err ** 2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "min": float(err.min()),
        "max": float(err.max()),
        "pairs": len(matches),
        "non_finite_pairs": n_bad,
    }

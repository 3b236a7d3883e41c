"""Statistics of the harness: percentiles, the union of intervals, and the
absolute trajectory error (Horn/Umeyama rigid alignment, as TUM's
``evaluate_ate.py``, or with scale for a monocular trajectory)."""
from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of ``values``, linear between ranks
    (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def union(intervals: np.ndarray) -> np.ndarray:
    """Merge [n, 2] (start, end) intervals into disjoint sorted ones."""
    if len(intervals) == 0:
        return np.zeros((0, 2))
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    stops = ends[np.append(idx[1:] - 1, len(iv) - 1)]
    return np.stack([starts, stops], 1)


def clip(intervals: np.ndarray, lo: float, hi: float) -> np.ndarray:
    iv = np.clip(intervals, lo, hi)
    return iv[iv[:, 1] > iv[:, 0]]


def gaps(intervals: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """The idle stretches of [lo, hi] between disjoint sorted intervals."""
    if len(intervals) == 0:
        return np.array([[lo, hi]])
    starts = np.concatenate([[lo], intervals[:, 1]])
    stops = np.concatenate([intervals[:, 0], [hi]])
    g = np.stack([starts, stops], 1)
    return g[g[:, 1] > g[:, 0]]


def ate_rmse(est_centres: np.ndarray, gt_centres: np.ndarray,
             with_scale: bool = False) -> tuple:
    """(RMSE, scale) of the estimated camera centres after the alignment
    that best maps them onto the ground truth ([n, 3] each, paired by row):
    rigid, or with ``with_scale`` a similarity (Umeyama 1991, the 7-DoF
    alignment of a monocular trajectory, whose map has a scale of its own;
    the scale is 1 without it)."""
    m = np.asarray(est_centres, np.float64).T
    d = np.asarray(gt_centres, np.float64).T
    mz = m - m.mean(1, keepdims=True)
    dz = d - d.mean(1, keepdims=True)
    U, D, Vt = np.linalg.svd((mz @ dz.T).T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / (mz * mz).sum()) if with_scale \
        else 1.0
    t = d.mean(1, keepdims=True) - s * R @ m.mean(1, keepdims=True)
    err = s * R @ m + t - d
    return float(np.sqrt((err * err).sum(0).mean())), s


"""Batched fundamental-matrix estimation: normalized 8-point + RANSAC.

Counterpart of ``coebslam_tpu/ops/fundamental.py``. Two differences are
forced by PyTorch: the 8x8 hypothesis systems go through
``torch.linalg.solve_ex`` (samples drawn with replacement make some of
them singular; ``torch.linalg.solve`` would raise on the CPU and
synchronise on the card, ``solve_ex`` returns inf/nan like the reference),
and the hypotheses' sample indices come from a ``torch.Generator`` or are
given explicitly (``idx``) — a torch generator cannot reproduce
``jax.random`` draws, so tests inject the reference's indices.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..utils import metrics


class FundamentalResult(NamedTuple):
    F: torch.Tensor            # [3, 3]
    inliers: torch.Tensor      # [N] bool
    n_inliers: torch.Tensor    # int64


def _normalize_points(pts, valid):
    """Hartley normalization: zero-mean, mean distance sqrt(2)."""
    w = valid.to(pts.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    mean = (pts * w[:, None]).sum(0) / n
    centered = pts - mean
    scale = math.sqrt(2.0) / torch.clamp(
        (torch.linalg.norm(centered, dim=-1) * w).sum() / n, min=1e-9)
    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    T = torch.stack([torch.stack([scale, zero, -scale * mean[0]]),
                     torch.stack([zero, scale, -scale * mean[1]]),
                     torch.stack([zero, zero, one])])
    return centered * scale, T


def _design_rows(p1, p2):
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        torch.ones_like(x1)], dim=-1)


def _eight_point(p1, p2):
    """F hypotheses [H, 3, 3] from minimal samples p1/p2 [H, 8, 2]
    (gauge f9 = 1, square 8x8 solve)."""
    A = _design_rows(p1, p2)
    f8 = torch.linalg.solve_ex(A[..., :8], -A[..., 8])[0]
    return torch.cat([f8, torch.ones_like(f8[..., :1])], dim=-1).reshape(
        *f8.shape[:-1], 3, 3)


def epipolar_distance(F, p1, p2):
    """Distance of p2 to the epiline F @ p1; F may carry a batch dim."""
    ones = torch.ones((*p1.shape[:-1], 1), dtype=p1.dtype, device=p1.device)
    x1 = torch.cat([p1, ones], dim=-1)
    line = x1 @ F.transpose(-1, -2)
    num = torch.abs(torch.sum(line[..., :2] * p2, dim=-1) + line[..., 2])
    den = torch.linalg.norm(line[..., :2], dim=-1)
    return num / torch.clamp(den, min=1e-9)


#: ``sampler(valid, n_hypotheses, k) -> [n_hypotheses, k]`` RANSAC sample
#: indices among the valid rows, in place of a generator's draws (tests
#: inject the reference's ``jax.random`` draws through it).
RansacSampler = Callable[[torch.Tensor, int, int], torch.Tensor]


def draw(sampler: Optional[RansacSampler], generator: torch.Generator,
         valid, n_hypotheses: int, k: int):
    """[H, k] sample indices from ``sampler`` when given, else from
    ``generator`` (``sample_indices``)."""
    if sampler is not None:
        return sampler(valid, n_hypotheses, k).to(valid.device)
    return sample_indices(valid, n_hypotheses, generator, k=k)


def sample_indices(valid, n_hypotheses: int, generator: torch.Generator,
                   k: int = 8):
    """[H, k] indices drawn uniformly (with replacement) among valid
    correspondences — uniform over all when none is valid, as the
    reference's categorical draw over -1e9 logits is."""
    w = valid.to(torch.float32)
    w = torch.where(w.sum() > 0, w, torch.ones_like(w))
    cdf = torch.cumsum(w, 0)
    u = torch.rand((n_hypotheses, k), generator=generator,
                   device=valid.device) * cdf[-1]
    idx = torch.searchsorted(cdf, u, right=True)
    return torch.clamp(idx, max=valid.shape[0] - 1)


def find_fundamental_ransac(p1, p2, valid, *, idx=None,
                            generator: Optional[torch.Generator] = None,
                            n_hypotheses: int = 256,
                            threshold: float = 1.0) -> FundamentalResult:
    """RANSAC F over correspondences p1 <-> p2 ([N, 2] each).

    Hypotheses use the sample indices ``idx`` [H, 8] when given (or
    ``idx(valid)`` when it is a callable), else ones drawn from
    ``generator``. The best hypothesis is refit on its inliers
    with the SVD null space, projected to rank 2 and de-normalized.
    """
    p1n, T1 = _normalize_points(p1, valid)
    p2n, T2 = _normalize_points(p2, valid)
    if idx is None:
        idx = sample_indices(valid, n_hypotheses, generator)
    elif callable(idx):
        idx = idx(valid)

    F_h = _eight_point(p1n[idx], p2n[idx])                    # [H, 3, 3]
    d = epipolar_distance(F_h, p1n[None], p2n[None])          # [H, N]
    thr_n = threshold * T2[0, 0]
    inl = (d < thr_n) & valid[None, :]
    counts = inl.sum(-1)
    best = torch.argmax(counts)

    sel = inl.index_select(0, best.reshape(1))[0]
    A = _design_rows(p1n, p2n) * sel.to(p1.dtype)[:, None]
    # Only Vh is needed: the reduced SVD gives the same row space without
    # the [N, N] U (signs are irrelevant, distances take abs).
    # On the card, cuSOLVER's gesvd: the default driver tries gesvdj first
    # and reads its convergence flags back to the host (a synchronisation).
    driver = "gesvd" if A.is_cuda else None
    with metrics.host_read("f_refit_svd", 2):   # cuSOLVER's info, twice
        vt = torch.linalg.svd(A, full_matrices=False, driver=driver)[2]
        F = vt[-1].reshape(3, 3)
        u, s, vt2 = torch.linalg.svd(F, driver=driver)
    s = s * (torch.arange(3, device=s.device) < 2).to(s.dtype)   # [1, 1, 0]
    F = (u * s[None, :]) @ vt2

    F_px = T2.T @ F @ T1
    F_px = F_px / torch.clamp(torch.abs(F_px).max(), min=1e-12)
    d_px = epipolar_distance(F_px, p1, p2)
    inliers = (d_px < threshold) & valid
    return FundamentalResult(F=F_px, inliers=inliers, n_inliers=inliers.sum())

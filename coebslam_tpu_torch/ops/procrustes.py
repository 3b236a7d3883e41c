"""Batched closed-form 3D-3D alignment (Horn/Umeyama) + batched RANSAC.

Counterpart of ``coebslam_tpu/ops/procrustes.py``: one primitive serves
the loop closure's Sim3Solver role and RGB-D relocalization (both sides of
a match have 3D coordinates). All hypotheses are solved and scored as one
batch. The hypotheses' sample indices come from a ``torch.Generator`` or
are given explicitly (``idx``): a torch generator cannot reproduce
``jax.random`` draws, so tests inject the reference's indices.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import CameraConfig
from ..geometry import camera as cam_ops
from .fundamental import sample_indices


def _det3(m):
    """Determinant of [..., 3, 3] by cofactors (no LAPACK call)."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def umeyama(src, dst, weights=None, with_scale: bool = False):
    """Weighted least-squares similarity: dst ~= s * R @ src + t.

    Args:
      src, dst: [..., N, 3].
      weights: optional [..., N] nonnegative.
    Returns (s [...], R [..., 3, 3], t [..., 3]).
    """
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    w = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    mu_s = torch.einsum("...n,...ni->...i", w, src)
    mu_d = torch.einsum("...n,...ni->...i", w, dst)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", w, dc, sc)
    # On the card, cuSOLVER's gesvd: the default driver tries gesvdj first
    # and reads its convergence flags back to the host.
    driver = "gesvd" if cov.is_cuda else None
    u, s_vals, vt = torch.linalg.svd(cov, driver=driver)
    det = _det3(u) * _det3(vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = (u * d[..., None, :]) @ vt
    if with_scale:
        var_src = torch.einsum("...n,...ni,...ni->...", w, sc, sc)
        scale = torch.sum(s_vals * d, dim=-1) / torch.clamp(var_src,
                                                            min=1e-12)
    else:
        scale = torch.ones(src.shape[:-2], dtype=src.dtype,
                           device=src.device)
    t = mu_d - scale[..., None] * torch.einsum("...ij,...j->...i", R, mu_s)
    return scale, R, t


class AlignmentResult(NamedTuple):
    scale: torch.Tensor        # scalar
    R: torch.Tensor            # [3, 3]
    t: torch.Tensor            # [3]
    inliers: torch.Tensor      # [N] bool
    n_inliers: torch.Tensor    # int64, at the final (annealed) radius
    n_consensus: torch.Tensor  # int64, best hypothesis count at the wide
                               # RANSAC radius


def ransac_alignment(src, dst, valid, *, idx=None,
                     generator: Optional[torch.Generator] = None,
                     n_hypotheses: int = 256, threshold: float = 0.05,
                     with_scale: bool = False, cam: CameraConfig = None,
                     obs_uv=None, px_threshold: float = 5.0,
                     final_threshold: float = None) -> AlignmentResult:
    """RANSAC similarity/rigid alignment from 3-point samples.

    Hypotheses use the sample indices ``idx`` [H, 3] when given, else ones
    drawn from ``generator`` (uniform among valid rows, with replacement).
    Scoring: 3D distance < ``threshold`` by default; if ``cam``+``obs_uv``
    are given, reprojection error of the transformed src points against
    [N, 2] pixel observations (< ``px_threshold`` px).
    """
    if idx is None:
        idx = sample_indices(valid, n_hypotheses, generator, k=3)
    s_h, R_h, t_h = umeyama(src[idx], dst[idx], with_scale=with_scale)
    if not with_scale:
        s_h = torch.ones_like(s_h)
    reproj = cam is not None and obs_uv is not None

    mapped = (s_h[:, None, None] * torch.einsum("hij,nj->hni", R_h, src)
              + t_h[:, None, :])
    if reproj:
        uv = cam_ops.project(cam, mapped)                  # [H, N, 2]
        err = torch.linalg.norm(uv - obs_uv[None], dim=-1)
        ok = (err < px_threshold) & (mapped[..., 2] > 0.05)
    else:
        err = torch.linalg.norm(mapped - dst[None], dim=-1)
        ok = err < threshold
    ok = ok & valid[None, :]
    counts = ok.sum(-1)
    best = torch.argmax(counts).reshape(1)

    # Refit on the best inlier set, annealing the inlier radius down to
    # ``final_threshold`` (the wide radius finds the consensus set, the
    # returned pose is fit tight).
    ths = [threshold]
    if final_threshold is not None and final_threshold < threshold:
        ths = list(np.geomspace(threshold, final_threshold, 3))
    inl = ok.index_select(0, best)[0]
    for th_i in ths:
        s, R, t = umeyama(src, dst, weights=inl.to(src.dtype),
                          with_scale=with_scale)
        if not with_scale:
            s = torch.ones_like(s)
        mapped = s * (src @ R.T) + t
        if reproj:
            uv = cam_ops.project(cam, mapped)
            err = torch.linalg.norm(uv - obs_uv, dim=-1)
            inl = (err < px_threshold) & (mapped[..., 2] > 0.05) & valid
        else:
            inl = (torch.linalg.norm(mapped - dst, dim=-1) < float(th_i)) \
                & valid
    return AlignmentResult(scale=s, R=R, t=t, inliers=inl,
                           n_inliers=inl.sum(),
                           n_consensus=counts.index_select(0, best)[0])

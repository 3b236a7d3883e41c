"""Epipolar-guided two-keyframe matching + triangulation.

Counterpart of ``coebslam_tpu/ops/triangulation.py``
(LocalMapping::CreateNewMapPoints' inner loop and
ORBmatcher::SearchForTriangulation): candidate keypoints of a keyframe
pair are matched under an epipolar-band penalty on the full Hamming matrix,
triangulated by DLT, and gated by cheirality, parallax, reprojection chi2
and scale consistency, all candidates at once.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CameraConfig, MatcherConfig, OrbConfig
from ..geometry import se3 as se3_mod, so3
from ..geometry.se3 import SE3
from . import matching
from .initializer_ops import intrinsics, triangulate_dlt


def fundamental_from_poses(T1: SE3, T2: SE3, cam: CameraConfig):
    """F12 with x1_px^T F12 x2_px = 0 (ComputeF12): the relative transform
    c2 -> c1 is p1 = R12 p2 + t12."""
    R12 = T1.R @ T2.R.T
    t12 = T1.t - R12 @ T2.t
    E = so3.hat(t12) @ R12
    Kinv = intrinsics(cam, str(R12.device))[1]
    return Kinv.T @ E @ Kinv


class TriangulationResult(NamedTuple):
    idx2: torch.Tensor        # [N1] matched slot in KF2 (-1 none)
    points: torch.Tensor      # [N1, 3] world positions
    good: torch.Tensor        # [N1] bool — survived every gate


def triangulate_pair(uv1, desc1_signed, valid1, level1,
                     uv2, desc2_signed, valid2, level2, ur2,
                     T1: SE3, T2: SE3, cam: CameraConfig, orb: OrbConfig,
                     mcfg: MatcherConfig,
                     chi2_mono: float = 5.991) -> TriangulationResult:
    """Match + triangulate candidate keypoints of KF1 against KF2.

    Inputs are per-keyframe fixed-shape tensors; ``valid*`` already exclude
    keypoints that carry a map point. ``ur2`` is unused, as in the
    reference.
    """
    dev = uv1.device
    f32 = torch.float32
    sf = torch.full((), orb.scale_factor, dtype=f32, device=dev)
    # Epipolar band: distance of x2 to the epiline of x1 below 3.84 sigma.
    F12 = fundamental_from_poses(T1, T2, cam)
    ones1 = torch.ones((uv1.shape[0], 1), dtype=f32, device=dev)
    l2 = torch.cat([uv1, ones1], dim=1) @ F12.T             # lines in image 2
    num = torch.abs(l2[:, None, 0] * uv2[None, :, 0]
                    + l2[:, None, 1] * uv2[None, :, 1] + l2[:, None, 2])
    den = torch.sqrt(l2[:, None, 0] ** 2 + l2[:, None, 1] ** 2 + 1e-12)
    dist = num / den                                        # [N1, N2]
    sigma2 = torch.pow(sf, 2.0 * level2.to(f32))
    band_ok = dist < 3.84 * torch.sqrt(sigma2)[None, :]

    d = matching.hamming_matrix(desc1_signed, desc2_signed)
    d = d + torch.where(band_ok, 0.0, matching.BIG)
    res = matching.match(d, max_distance=mcfg.th_low, ratio=mcfg.nn_ratio_bow,
                         mutual=True, row_valid=valid1, col_valid=valid2)

    # Triangulate the matched pairs in normalized coordinates.
    _, _, K_off, K_f = intrinsics(cam, str(dev))
    j = torch.clamp(res.idx, min=0)
    p1n = (uv1 - K_off) / K_f
    uv2m = uv2[j]
    p2n = (uv2m - K_off) / K_f
    P1 = torch.cat([T1.R, T1.t[:, None]], dim=1)
    P2 = torch.cat([T2.R, T2.t[:, None]], dim=1)
    X = triangulate_dlt(P1, P2, p1n, p2n)                  # world coords

    # Gates (LocalMapping.cc:319-433).
    pc1 = se3_mod.transform_points(T1, X)
    pc2 = se3_mod.transform_points(T2, X)
    cheir = (pc1[:, 2] > 0.02) & (pc2[:, 2] > 0.02)

    C1 = -T1.R.T @ T1.t
    C2 = -T2.R.T @ T2.t
    r1 = X - C1
    r2 = X - C2
    cos_par = torch.sum(r1 * r2, -1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1),
        min=1e-9)
    parallax_ok = cos_par < 0.9998

    def reproj_err(pc, uv_obs):
        z = torch.clamp(pc[:, 2], min=1e-6)
        u = cam.fx * pc[:, 0] / z + cam.cx
        v = cam.fy * pc[:, 1] / z + cam.cy
        return (u - uv_obs[:, 0]) ** 2 + (v - uv_obs[:, 1]) ** 2

    s1 = torch.pow(sf, 2.0 * level1.to(f32))
    lvl2m = level2[j].to(f32)
    s2 = torch.pow(sf, 2.0 * lvl2m)
    chi_ok = (reproj_err(pc1, uv1) < chi2_mono * s1) \
        & (reproj_err(pc2, uv2m) < chi2_mono * s2)

    # Scale consistency: the distance ratio agrees with the octave ratio
    # (ratioFactor = 1.5 * scaleFactor).
    d1 = torch.linalg.norm(r1, dim=-1)
    d2 = torch.linalg.norm(r2, dim=-1)
    ratio_dist = d2 / torch.clamp(d1, min=1e-9)
    ratio_octave = torch.pow(sf, level1.to(f32) - lvl2m)
    rf = 1.5 * orb.scale_factor
    scale_ok = (ratio_dist < ratio_octave * rf) \
        & (ratio_dist > ratio_octave / rf)

    good = res.valid & cheir & parallax_ok & chi_ok & scale_ok
    return TriangulationResult(
        idx2=torch.where(good, res.idx, torch.full_like(res.idx, -1)),
        points=X, good=good)

"""Robust pose-only Gauss-Newton — the per-frame camera solve.

Counterpart of ``coebslam_tpu/optim/pose_gn.py``: one SE3 with mono/stereo
reprojection edges, Huber kernel, 4 rounds x 10 iterations with chi-square
gating between rounds and the robust kernel dropped from round 3. The 6x6
normal systems go through ``torch.linalg.solve_ex``, which neither raises
on a singular system nor synchronises with the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CameraConfig, OptimizerConfig
from ..geometry import se3
from ..geometry.se3 import SE3


class PoseOptResult(NamedTuple):
    pose: SE3
    inliers: torch.Tensor      # [N] bool — final chi2 classification
    n_inliers: torch.Tensor    # int64
    chi2: torch.Tensor         # [N] float32 per-observation chi2


def _residual_jacobian(pose: SE3, points_w, obs, cam: CameraConfig,
                       is_stereo):
    """Residuals e = obs - pred [N, 3] (third row zeroed for mono) and
    Jacobians J [N, 3, 6] of the prediction wrt xi = [omega | upsilon]."""
    p = se3.transform_points(pose, points_w)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    z_safe = torch.where(z < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / z_safe
    iz2 = iz * iz

    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    pred = torch.stack([u, v, ur], dim=-1)
    e = obs - pred
    e = torch.cat([e[:, :2], torch.where(is_stereo, e[:, 2],
                                         torch.zeros_like(x))[:, None]], 1)

    zeros = torch.zeros_like(x)
    du_dp = torch.stack([cam.fx * iz, zeros, -cam.fx * x * iz2], dim=-1)
    dv_dp = torch.stack([zeros, cam.fy * iz, -cam.fy * y * iz2], dim=-1)
    dur_dp = torch.stack([cam.fx * iz, zeros,
                          -cam.fx * x * iz2 + cam.bf * iz2], dim=-1)
    dpred_dp = torch.stack([du_dp, dv_dp, dur_dp], dim=-2)     # [N, 3, 3]

    # dp/dxi for a left perturbation: [-hat(p) | I].
    ones = torch.ones_like(x)
    dp_dxi = torch.stack([
        torch.stack([zeros, z, -y, ones, zeros, zeros], dim=-1),
        torch.stack([-z, zeros, x, zeros, ones, zeros], dim=-1),
        torch.stack([y, -x, zeros, zeros, zeros, ones], dim=-1)], dim=-2)
    J = dpred_dp @ dp_dxi                                      # [N, 3, 6]
    J = torch.cat([J[:, :2], torch.where(is_stereo[:, None], J[:, 2],
                                         torch.zeros_like(J[:, 2]))[:, None]],
                  1)
    return e, J


def optimize_pose(pose0: SE3, points_w, obs, inv_sigma2, valid,
                  cam: CameraConfig, cfg: OptimizerConfig) -> PoseOptResult:
    """Run the 4x10 robust GN schedule.

    Args:
      points_w: [N, 3] map points; obs: [N, 3] (u, v, u_right), u_right < 0
      for mono; inv_sigma2: [N] information; valid: [N] bool.
    """
    is_stereo = obs[..., 2] >= 0.0
    delta_huber = torch.where(
        is_stereo,
        torch.sqrt(torch.full((), cfg.chi2_stereo, device=obs.device)),
        torch.sqrt(torch.full((), cfg.chi2_mono, device=obs.device)))
    chi2_th = torch.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
    eye6 = 1e-6 * torch.eye(6, dtype=obs.dtype, device=obs.device)

    def chi2_of(e):
        return torch.sum(e * e, dim=-1) * inv_sigma2

    pose, active = pose0, valid
    c2 = None
    for rnd in range(cfg.pose_rounds):
        use_huber = rnd < 2                    # dropped from round 3
        for _ in range(cfg.pose_iters_per_round):
            e, J = _residual_jacobian(pose, points_w, obs, cam, is_stereo)
            c2 = chi2_of(e)
            err = torch.sqrt(torch.clamp(c2, min=1e-12))
            if use_huber:
                w_rob = torch.where(err > delta_huber, delta_huber / err,
                                    torch.ones_like(err))
            else:
                w_rob = torch.ones_like(err)
            w = w_rob * inv_sigma2 * active.to(e.dtype)
            H = torch.einsum("nri,n,nrj->ij", J, w, J) + eye6
            b = torch.einsum("nri,n,nr->i", J, w, e)
            dxi = torch.linalg.solve_ex(H, b)[0]
            # Trust-region clip of the step.
            norm = torch.linalg.norm(dxi)
            dxi = dxi * torch.clamp(0.5 / torch.clamp(norm, min=1e-12), max=1.0)
            pose = se3.retract(pose, dxi)
        e, _ = _residual_jacobian(pose, points_w, obs, cam, is_stereo)
        c2 = chi2_of(e)
        active = valid & (c2 <= chi2_th)
    return PoseOptResult(pose=pose, inliers=active, n_inliers=active.sum(),
                         chi2=c2)

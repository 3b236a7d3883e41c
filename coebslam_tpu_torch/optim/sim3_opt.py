"""Sim3 refinement between two keyframes (the reference's
``Optimizer::OptimizeSim3``).

Counterpart of ``coebslam_tpu/optim/sim3_opt.py``: one Sim3 with paired
forward/inverse projection edges (points of KF2 projected into KF1 through
S12, points of KF1 into KF2 through S12^-1), Huber-robust Gauss-Newton
with a chi2 gate between the 5- and 10-iteration phases. The reference
takes the [N, 2, 7] Jacobians from ``jax.jacfwd``; here they are central
differences of the residuals evaluated in float64 (as in
``optim/pose_graph.py``): one batched pass over the 14 steps for both
edge sets, on the card without a host read.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import CameraConfig, OptimizerConfig
from ..geometry import camera as cam_ops
from ..geometry import sim3
from ..geometry.sim3 import Sim3

#: Central-difference step of the Jacobians (float64 evaluation).
_FD_STEP = 1e-5


class Sim3OptResult(NamedTuple):
    S12: Sim3
    inliers: torch.Tensor      # [N] bool (pairs surviving both directions)
    n_inliers: torch.Tensor    # int64


def _residuals(xi, S0: Sim3, p1, p2, obs1, obs2, cam: CameraConfig):
    """Residuals [B, N, 2] of both edge sets at the tangents xi [B, 7]:
    S = exp(xi) * S0, e1 = obs1 - proj(S p2), e2 = obs2 - proj(S^-1 p1)."""
    S = sim3.exp(xi).compose(Sim3(*(x.expand(xi.shape[0], *x.shape)
                                    for x in S0)))

    def apply(T, p):
        return (T.s[:, None, None] * torch.einsum("bij,nj->bni", T.R, p)
                + T.t[:, None, :])

    e1 = obs1 - cam_ops.project(cam, apply(S, p2))
    e2 = obs2 - cam_ops.project(cam, apply(S.inverse(), p1))
    return e1, e2


def optimize_sim3(S12_init: Sim3, pts1_c1, pts2_c2, obs1, obs2, valid,
                  cam: CameraConfig, cfg: OptimizerConfig,
                  fix_scale: bool = True) -> Sim3OptResult:
    """Args:
      pts1_c1: [N, 3] matched points in KF1's camera frame.
      pts2_c2: [N, 3] the same landmarks in KF2's camera frame.
      obs1/obs2: [N, 2] pixel observations in KF1/KF2.
      fix_scale: True for RGB-D/stereo (the reference's bFixScale).
    """
    dev, f32, f64 = pts1_c1.device, pts1_c1.dtype, torch.float64
    delta = math.sqrt(10.0)    # the reference's deltaHuber
    data = (pts1_c1, pts2_c2, obs1, obs2)
    data64 = tuple(x.to(f64) for x in data)
    S0_64 = Sim3(*(x.to(f64) for x in S12_init))
    eye = torch.eye(7, dtype=f64, device=dev) * _FD_STEP
    steps = torch.cat([eye, -eye])                                 # [14, 7]
    free = torch.ones(7, dtype=f32, device=dev)
    if fix_scale:
        free[6] = 0.0
    eye7 = 1e-6 * torch.eye(7, dtype=f32, device=dev)
    scale_pin = torch.zeros((7, 7), dtype=f32, device=dev)
    if fix_scale:
        scale_pin[6, 6] = 1.0

    def residuals(xi):
        return _residuals(xi[None], S12_init, *data, cam)

    def gn_step(xi, active):
        e1, e2 = (e[0] for e in residuals(xi))
        r1, r2 = _residuals(xi.to(f64)[None] + steps, S0_64, *data64, cam)
        J1 = ((r1[:7] - r1[7:]) / (2.0 * _FD_STEP)).permute(1, 2, 0).to(f32)
        J2 = ((r2[:7] - r2[7:]) / (2.0 * _FD_STEP)).permute(1, 2, 0).to(f32)
        J1, J2 = J1 * free, J2 * free

        def accum(e, J):
            c2 = torch.sum(e * e, dim=-1)
            err = torch.sqrt(torch.clamp(c2, min=1e-12))
            w = torch.where(err > delta, delta / err,
                            torch.ones_like(err)) * active
            return (torch.einsum("nri,n,nrj->ij", J, w, J),
                    torch.einsum("nri,n,nr->i", J, w, e))

        H1, b1 = accum(e1, J1)
        H2, b2 = accum(e2, J2)
        H = H1 + H2 + eye7
        if fix_scale:
            H = H * (1.0 - scale_pin) + scale_pin
        # J is d(e)/d(xi) (e = obs - proj), so GN is dxi = -H^-1 J^T W e.
        dxi = -torch.linalg.solve_ex(H, b1 + b2)[0]
        return dxi * free

    xi = torch.zeros(7, dtype=f32, device=dev)
    active = valid.to(f32)
    for _ in range(cfg.sim3_iters_first):
        xi = xi + gn_step(xi, active)
    # chi2 gate at th = 10 (the reference's th2 = 10).
    e1, e2 = (e[0] for e in residuals(xi))
    c1 = torch.sum(e1 * e1, -1)
    c2 = torch.sum(e2 * e2, -1)
    active = (valid & (c1 <= 10.0) & (c2 <= 10.0)).to(f32)
    for _ in range(cfg.sim3_iters_second):
        xi = xi + gn_step(xi, active)

    e1, e2 = (e[0] for e in residuals(xi))
    inl = valid & (torch.sum(e1 * e1, -1) <= 10.0) \
        & (torch.sum(e2 * e2, -1) <= 10.0)
    return Sim3OptResult(S12=sim3.exp(xi).compose(S12_init), inliers=inl,
                         n_inliers=inl.sum())

"""Depth-free PnP: batched EPnP + batched RANSAC.

Counterpart of ``coebslam_tpu/ops/pnp.py`` (the reference's ``PnPsolver``,
EPnP inside RANSAC): all hypotheses are solved as one batch of small dense
problems (3x3 ``eigh`` for the control points, 12x12 ``eigh`` for the null
space, a fixed five-step Gauss-Newton on the betas from three starts,
Umeyama for the pose) and scored against all correspondences in one
[H, N] reprojection pass.

Two differences are forced by PyTorch. The betas' Gauss-Newton takes its
[6, 4] Jacobian in closed form (the residuals |cc_i - cc_j|^2 - rho are
quadratic in the betas: d/db_k = 2 (cc_i - cc_j) . (V_k,i - V_k,j)) where
the reference differentiates with ``jax.jacfwd``; and the RANSAC samples
are given (``idx``), since a torch generator cannot reproduce
``jax.random``. Eigenvectors are defined only
up to sign and, in near-degenerate eigenspaces, up to rotation, so LAPACK,
cuSOLVER and XLA return different null-space bases: what the two packages
share is the pose, its error and the inlier set, not ``V``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CameraConfig
from ..geometry import camera as cam_ops
from .procrustes import umeyama

def _control_points(X, w):
    """Weighted EPnP control points [..., 4, 3]: the centroid and the
    principal axes of the world cloud, each scaled by its spread."""
    wn = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    c0 = torch.einsum("...n,...ni->...i", wn, X)
    Xc = X - c0[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", wn, Xc, Xc)
    eval_, evec = torch.linalg.eigh(cov)           # ascending
    # Guard degenerate (planar/linear) clouds: floor the spread.
    scale = torch.sqrt(torch.clamp(eval_, min=1e-8))
    ctrl = c0[..., None, :] + (evec * scale[..., None, :]).transpose(-1, -2)
    return torch.cat([c0[..., None, :], ctrl], -2)


def _barycentric(X, ctrl):
    """alphas [..., N, 4] with X_i = sum_j alpha_ij ctrl_j and
    sum_j alpha_ij = 1."""
    B = (ctrl[..., 1:, :] - ctrl[..., :1, :]).transpose(-1, -2)  # [.., 3, 3]
    eye = torch.eye(3, dtype=X.dtype, device=X.device)
    beta = torch.linalg.solve_ex(
        B + 1e-9 * eye, (X - ctrl[..., :1, :]).transpose(-1, -2))[0]
    beta = beta.transpose(-1, -2)                            # [.., N, 3]
    return torch.cat([1.0 - beta.sum(-1, keepdim=True), beta], -1)


def _pair_diff(c):
    """[..., 4, 3] points -> [..., 6, 3] differences of the pairs (0, 1),
    (0, 2), (0, 3), (1, 2), (1, 3), (2, 3), by slices (an index list would
    be copied to the card, a host sync)."""
    return torch.cat([c[..., i:i + 1, :] - c[..., i + 1:, :]
                      for i in range(3)], -2)


def _rho(ctrl):
    return torch.sum(_pair_diff(ctrl) ** 2, -1)


def _cam_ctrl(V, betas):
    """Camera-frame control points [..., 4, 3] from the null-space basis
    V [..., 4, 4, 3] and betas [..., 4]."""
    return torch.einsum("...k,...kij->...ij", betas, V)


def _gauss_newton_betas(V, betas0, rho, iters: int = 5):
    """Polish the betas on the 6 inter-control-point distances (the
    reference's ``gauss_newton``), fixed iterations, batched; the
    Jacobian in closed form."""
    Vd = _pair_diff(V)                                  # [..., 4, 6, 3]
    eye = 1e-6 * torch.eye(4, dtype=V.dtype, device=V.device)
    betas = betas0
    for _ in range(iters):
        d = _pair_diff(_cam_ctrl(V, betas))             # [..., 6, 3]
        r = torch.sum(d * d, -1) - rho                  # [..., 6]
        J = 2.0 * torch.einsum("...pi,...kpi->...pk", d, Vd)   # [..., 6, 4]
        Jt = J.transpose(-1, -2)
        delta = torch.linalg.solve_ex(Jt @ J + eye,
                                      (Jt @ r[..., None]))[0][..., 0]
        betas = betas - delta
    return betas


class PnPResult(NamedTuple):
    R: torch.Tensor          # [..., 3, 3] world -> camera
    t: torch.Tensor          # [..., 3]
    err2: torch.Tensor       # [...] weighted mean squared reprojection error


def epnp(X, uv, w, cam: CameraConfig) -> PnPResult:
    """Weighted EPnP for n >= 4 correspondences (rows with w=0 ignored),
    batched over leading dimensions.

    Args:
      X: [..., N, 3] world points. uv: [..., N, 2] pixels. w: [..., N].
    """
    ctrl_w = _control_points(X, w)
    alphas = _barycentric(X, ctrl_w)                     # [..., N, 4]
    rho = _rho(ctrl_w)                                   # [..., 6]

    # M^T M accumulated directly (rows weighted): M rows are
    #   [a_j fx, 0, a_j (cx - u)] and [0, a_j fy, a_j (cy - v)]  j=0..3
    du = cam.cx - uv[..., 0]
    dv = cam.cy - uv[..., 1]
    zeros = torch.zeros_like(du)
    row_u = torch.stack([torch.full_like(du, cam.fx), zeros, du], -1)
    row_v = torch.stack([zeros, torch.full_like(du, cam.fy), dv], -1)
    lead = alphas.shape[:-1]
    Mu = (alphas[..., :, None] * row_u[..., None, :]).reshape(*lead, 12)
    Mv = (alphas[..., :, None] * row_v[..., None, :]).reshape(*lead, 12)
    MtM = (torch.einsum("...ni,...n,...nj->...ij", Mu, w, Mu)
           + torch.einsum("...ni,...n,...nj->...ij", Mv, w, Mv))
    _, vecs = torch.linalg.eigh(MtM)                     # ascending
    V = vecs[..., :, :4].transpose(-1, -2).reshape(*MtM.shape[:-2], 4, 4, 3)

    # The closed-form scale of the dominant null vector (the reference's
    # N=1 case) starts all three beta initialisations.
    d0 = _pair_diff(V[..., 0, :, :])                     # [..., 6, 3]
    num = (torch.linalg.norm(d0, dim=-1) * torch.sqrt(rho)).sum(-1)
    den = torch.sum(d0 * d0, (-1, -2))
    b1 = num / torch.clamp(den, min=1e-12)
    z, b = torch.zeros_like(b1), 0.1 * b1
    betas0 = torch.stack([torch.stack([b1, z, z, z], -1),
                          torch.stack([b1, b, z, z], -1),
                          torch.stack([b1, b, b, b], -1)], -2)   # [..., 3, 4]

    # The three starts as one more batch dimension.
    Vc, rhoc = V[..., None, :, :, :], rho[..., None, :]
    betas = _gauss_newton_betas(Vc, betas0, rhoc)
    cc = _cam_ctrl(Vc, betas)                            # [..., 3, 4, 3]
    pc = alphas[..., None, :, :] @ cc                    # [..., 3, N, 3]
    wc = w[..., None, :].expand(pc.shape[:-1])
    # Resolve the global sign: depths must be positive.
    sign = torch.where(torch.einsum("...n,...n->...", wc, pc[..., 2]) < 0,
                       -1.0, 1.0)
    pc = pc * sign[..., None, None]
    Xc = X[..., None, :, :].expand(pc.shape)
    _, R, t = umeyama(Xc, pc, weights=wc)
    proj = cam_ops.project(cam, torch.einsum("...ij,...nj->...ni", R, Xc)
                           + t[..., None, :])
    err2 = torch.einsum("...n,...n->...", wc,
                        torch.sum((proj - uv[..., None, :, :]) ** 2, -1)) \
        / torch.clamp(wc.sum(-1), min=1e-9)
    best = torch.argmin(err2, dim=-1, keepdim=True)      # [..., 1]
    R = torch.take_along_dim(R, best[..., None, None], dim=-3)[..., 0, :, :]
    t = torch.take_along_dim(t, best[..., None], dim=-2)[..., 0, :]
    err2 = torch.take_along_dim(err2, best, dim=-1)[..., 0]
    return PnPResult(R, t, err2)


class PnPRansacResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor     # [N] bool
    n_inliers: torch.Tensor   # int64


def ransac_epnp(X, uv, valid, cam: CameraConfig, idx, *,
                px_threshold: float = 5.99 ** 0.5 * 2.0) -> PnPRansacResult:
    """RANSAC EPnP: batched minimal solves + one [H, N] scoring pass +
    weighted re-solve on the best consensus set.

    ``idx`` [H, 6] holds each hypothesis' sample among the valid rows
    (``fundamental.sample_indices`` draws them with replacement, as the
    reference does). A sample of 6 trades a slightly larger sample for far
    better EPnP conditioning than the minimal 4.
    """
    h = epnp(X[idx], uv[idx], torch.ones(idx.shape, dtype=X.dtype,
                                         device=X.device), cam)
    R_h, t_h = h.R, h.t
    pc = torch.einsum("hij,nj->hni", R_h, X) + t_h[:, None, :]
    proj = cam_ops.project(cam, pc)
    err = torch.linalg.norm(proj - uv[None], dim=-1)
    ok = (err < px_threshold) & (pc[..., 2] > 0.05) & valid[None, :]
    counts = ok.sum(-1)
    best = torch.argmax(counts).reshape(1)
    best_count = counts.index_select(0, best)[0]

    # Weighted full re-solve on the consensus set.
    w = ok.index_select(0, best)[0].to(X.dtype)
    enough = (best_count >= 4).to(X.dtype)
    r = epnp(X, uv, w + (1.0 - enough) * 1e-3, cam)
    pc = X @ r.R.T + r.t
    proj = cam_ops.project(cam, pc)
    err = torch.linalg.norm(proj - uv, dim=-1)
    inl = (err < px_threshold) & (pc[:, 2] > 0.05) & valid
    # Fall back to the best raw hypothesis if the re-solve regressed.
    use_refit = inl.sum() >= best_count
    R = torch.where(use_refit, r.R, R_h.index_select(0, best)[0])
    t = torch.where(use_refit, r.t, t_h.index_select(0, best)[0])
    inliers = torch.where(use_refit, inl, ok.index_select(0, best)[0])
    return PnPRansacResult(R, t, inliers, inliers.sum())

"""Local bundle adjustment: Schur-complement Gauss-Newton on a window.

Counterpart of ``BAProblem``, ``BAResult``, ``_residuals_jacobians``,
``_inv3x3``, ``_assemble``, ``_solve_cameras``, ``_backsub``,
``_gn_iteration`` and ``optimize_local_ba`` of
``coebslam_tpu/optim/local_ba.py``. The reference lays the assembly out
lane-major ([..., M, P]) and reduces with one-hot matmuls because that is
what the TPU runs fast; here the same values come from ordinary batched
tensors in the natural [P, M, ...] layout. Summation order differs, so the
values agree to float32 rounding, not bit for bit.
``_gn_iteration_chunked`` and ``optimize_global_ba`` are the global BA's
engine (``slam/global_ba.py``). ``reduce_fn(S, b)``, where the solvers take
it, is the distributed-assembly hook of ``parallel/sharded_ba.py``: it sums
each rank's partial reduced camera system over the ranks before the solve.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CameraConfig, OptimizerConfig
from ..geometry import se3
from ..geometry.se3 import SE3


class BAProblem(NamedTuple):
    """Fixed-shape local-BA window (K keyframes, P points, M observations
    per point)."""
    kf_R: torch.Tensor         # [K, 3, 3] world-to-camera
    kf_t: torch.Tensor         # [K, 3]
    kf_fixed: torch.Tensor     # [K] bool
    kf_valid: torch.Tensor     # [K] bool
    pt_pos: torch.Tensor       # [P, 3]
    pt_valid: torch.Tensor     # [P] bool
    obs_kf: torch.Tensor       # [P, M] int64 window-KF index (-1 empty)
    obs_uvr: torch.Tensor      # [P, M, 3] (u, v, u_right); ur < 0 => mono
    obs_w: torch.Tensor        # [P, M] inv_sigma2
    obs_valid: torch.Tensor    # [P, M] bool


class BAResult(NamedTuple):
    kf_R: torch.Tensor
    kf_t: torch.Tensor
    pt_pos: torch.Tensor
    obs_valid: torch.Tensor    # post-gate classification
    chi2: torch.Tensor         # [P, M] final per-observation chi2


def _residuals_jacobians(prob: BAProblem, cam: CameraConfig):
    """e [P,M,3], Jc [P,M,3,6], Jp [P,M,3,3], is_stereo [P,M]."""
    kf_idx = torch.clamp(prob.obs_kf, min=0)
    R = prob.kf_R[kf_idx]                      # [P, M, 3, 3]
    t = prob.kf_t[kf_idx]                      # [P, M, 3]
    X = prob.pt_pos[:, None, :]
    p = torch.einsum("pmij,pmj->pmi", R, X.expand_as(t)) + t
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    z_safe = torch.where(z < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / z_safe
    iz2 = iz * iz

    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    pred = torch.stack([u, v, ur], dim=-1)
    is_stereo = prob.obs_uvr[..., 2] >= 0.0
    zero = torch.zeros_like(x)
    e = prob.obs_uvr - pred
    e = torch.stack([e[..., 0], e[..., 1],
                     torch.where(is_stereo, e[..., 2], zero)], dim=-1)

    dur_x = torch.where(is_stereo, cam.fx * iz, zero)
    dur_z = torch.where(is_stereo, -cam.fx * x * iz2 + cam.bf * iz2, zero)
    dpred = torch.stack([
        torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], dim=-1),
        torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], dim=-1),
        torch.stack([dur_x, zero, dur_z], dim=-1)], dim=-2)   # [P, M, 3, 3]
    one = torch.ones_like(x)
    dp_dxi = torch.stack([
        torch.stack([zero, z, -y, one, zero, zero], dim=-1),
        torch.stack([-z, zero, x, zero, one, zero], dim=-1),
        torch.stack([y, -x, zero, zero, zero, one], dim=-1)], dim=-2)
    Jc = dpred @ dp_dxi                                       # [P, M, 3, 6]
    Jp = dpred @ R                                            # [P, M, 3, 3]
    return e, Jc, Jp, is_stereo


def _inv3x3(H):
    """Closed-form inverse of [..., 3, 3] matrices (adjugate/determinant)."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    g, h, k = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    A = e * k - f * h
    B = c * h - b * k
    C = b * f - c * e
    D = f * g - d * k
    E = a * k - c * g
    F = c * d - a * f
    G = d * h - e * g
    Hc = b * g - a * h
    K = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-18,
                                torch.full_like(det, 1e-18), det)
    rows = torch.stack([torch.stack([A, B, C], -1), torch.stack([D, E, F], -1),
                        torch.stack([G, Hc, K], -1)], -2)
    return rows * inv_det[..., None, None]


def _point_terms(prob: BAProblem, cam: CameraConfig, use_huber: bool,
                 chi2_mono: float, chi2_stereo: float, damping: float):
    """Per-point terms of the Schur complement: the back-substitution's
    (A [P, M, 6, 3], Hpp^-1 [P, 3, 3], bp [P, 3], kf_idx [P, M]), and the
    weighted camera Jacobians, the camera Jacobians and the residuals that
    the assembly reduces."""
    e, Jc, Jp, is_stereo = _residuals_jacobians(prob, cam)
    dev = e.device

    chi2 = torch.sum(e * e, dim=-1) * prob.obs_w                  # [P, M]
    delta = torch.where(
        is_stereo,
        torch.sqrt(torch.full((), chi2_stereo, dtype=torch.float32, device=dev)),
        torch.sqrt(torch.full((), chi2_mono, dtype=torch.float32, device=dev)))
    err = torch.sqrt(torch.clamp(chi2, min=1e-12))
    if use_huber:
        w_rob = torch.where(err > delta, delta / err, torch.ones_like(err))
    else:
        w_rob = torch.ones_like(err)
    w = (w_rob * prob.obs_w * prob.obs_valid.to(e.dtype)
         * prob.pt_valid[:, None].to(e.dtype)
         * (prob.obs_kf >= 0).to(e.dtype))                       # [P, M]

    wJp = Jp * w[..., None, None]
    Hpp = torch.einsum("pmri,pmrj->pij", wJp, Jp)                 # [P, 3, 3]
    bp = torch.einsum("pmrs,pmr->ps", wJp, e)                     # [P, 3]
    diag = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    Hpp = Hpp + torch.diag_embed(1e-3 * diag + damping)
    Hi = _inv3x3(Hpp)                                             # [P, 3, 3]

    wJc = Jc * w[..., None, None]
    A = torch.einsum("pmri,pmrj->pmij", wJc, Jp)                  # [P, M, 6, 3]
    kf_idx = torch.clamp(prob.obs_kf, min=0)
    return (A, Hi, bp, kf_idx), (wJc, Jc, e)


def _assemble(prob: BAProblem, cam: CameraConfig, use_huber: bool,
              chi2_mono: float, chi2_stereo: float, damping: float):
    """Point-marginalized reduced camera system: S [K, K, 6, 6], b [K, 6],
    and the per-observation terms needed for back-substitution."""
    K = prob.kf_R.shape[0]
    terms, (wJc, Jc, e) = _point_terms(prob, cam, use_huber, chi2_mono,
                                       chi2_stereo, damping)
    A, Hi, bp, kf_idx = terms
    dev = e.device
    AHinv = A @ Hi[:, None]                                       # [P, M, 6, 3]
    Hcc = torch.einsum("pmri,pmrj->pmij", wJc, Jc)                # [P, M, 6, 6]
    bc = torch.einsum("pmri,pmr->pmi", wJc, e)                    # [P, M, 6]

    flat = kf_idx.reshape(-1)
    S_diag = torch.zeros((K, 6, 6), dtype=e.dtype, device=dev).index_add_(
        0, flat, Hcc.reshape(-1, 6, 6))
    b = torch.zeros((K, 6), dtype=e.dtype, device=dev).index_add_(
        0, flat, bc.reshape(-1, 6))

    # Schur cross terms couple every pair of observations of one point:
    # S[k, l] -= sum_p (sum_{m in k} AHinv_m)(sum_{n in l} A_n)^T.
    oh = (kf_idx[..., None] == torch.arange(K, device=dev)).to(e.dtype)
    T = torch.einsum("pmk,pmis->pkis", oh, AHinv)                 # [P, K, 6, 3]
    U = torch.einsum("pmk,pmis->pkis", oh, A)
    S = -torch.einsum("pkis,pljs->klij", T, U)                    # [K, K, 6, 6]
    ar = torch.arange(K, device=dev)
    S[ar, ar] += S_diag
    b = b - torch.einsum("pkis,ps->ki", T, bp)
    return S, b, terms


def _solve_cameras(S, b, kf_fixed, kf_valid, damping: float):
    """Dense solve of the masked 6K x 6K reduced camera system -> dxi."""
    K = S.shape[0]
    free = (~kf_fixed) & kf_valid
    free_f = free.to(S.dtype)
    S = S * free_f[:, None, None, None] * free_f[None, :, None, None]
    eye = torch.eye(6, dtype=S.dtype, device=S.device)
    ar = torch.arange(K, device=S.device)
    S = S.clone()
    S[ar, ar] += eye * torch.where(free, damping, 1.0)[:, None, None]
    b = b * free_f[:, None]
    S_dense = S.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    dxi = torch.linalg.solve_ex(S_dense, b.reshape(K * 6))[0].reshape(K, 6)
    norm = torch.linalg.norm(dxi, dim=-1, keepdim=True)
    dxi = dxi * torch.clamp(0.5 / torch.clamp(norm, min=1e-12), max=1.0)
    return dxi * free_f[:, None]


def _backsub(terms, dxi, pt_valid, pt_pos):
    """Point back-substitution: dp = Hpp^-1 (bp - sum_m A^T dxi_kf)."""
    A, Hi, bp, kf_idx = terms
    Atd = torch.einsum("pmij,pmi->pj", A, dxi[kf_idx])
    dp = torch.einsum("psj,pj->ps", Hi, bp - Atd)
    dp_norm = torch.linalg.norm(dp, dim=-1, keepdim=True)
    dp = dp * torch.clamp(0.5 / torch.clamp(dp_norm, min=1e-12), max=1.0)
    dp = dp * pt_valid[:, None].to(dp.dtype)
    return pt_pos + dp


def _gn_iteration(prob: BAProblem, cam: CameraConfig, use_huber: bool,
                  chi2_mono: float, chi2_stereo: float, damping: float,
                  reduce_fn=None) -> BAProblem:
    """One Schur-complement GN step; returns updated poses/points.

    ``reduce_fn(S, b) -> (S, b)``: with the point axis split over ranks,
    each rank assembles its partial reduced camera system and the hook sums
    them (an all-reduce); the dense solve then runs on every rank alike."""
    S, b, terms = _assemble(prob, cam, use_huber, chi2_mono, chi2_stereo,
                            damping)
    if reduce_fn is not None:
        S, b = reduce_fn(S, b)
    dxi = _solve_cameras(S, b, prob.kf_fixed, prob.kf_valid, damping)
    new_pts = _backsub(terms, dxi, prob.pt_valid, prob.pt_pos)
    new_pose = se3.retract(SE3(prob.kf_R, prob.kf_t), dxi)
    return prob._replace(kf_R=new_pose.R, kf_t=new_pose.t, pt_pos=new_pts)


_POINT_FIELDS = ("pt_pos", "pt_valid", "obs_kf", "obs_uvr", "obs_w",
                 "obs_valid")


def _gn_iteration_chunked(prob: BAProblem, cam: CameraConfig,
                          use_huber: bool, chi2_mono: float,
                          chi2_stereo: float, damping: float,
                          n_blocks: int, reduce_fn=None) -> BAProblem:
    """One GN step over the point axis in ``n_blocks`` blocks: pass 1 sums
    the blocks' reduced camera systems (the Schur terms are separable by
    point, so the block sums are exact), pass 2 recomputes each block's
    point terms and back-substitutes its points. The reference's two
    ``lax.scan``s are a loop over the blocks here. ``reduce_fn`` (see
    ``_gn_iteration``) sums the block sums over the ranks; pass 2 stays
    local."""
    K = prob.kf_R.shape[0]
    P = prob.obs_kf.shape[0]
    assert P % n_blocks == 0, (P, n_blocks)
    PB = P // n_blocks
    blocks = [prob._replace(**{f: getattr(prob, f)[i * PB:(i + 1) * PB]
                               for f in _POINT_FIELDS})
              for i in range(n_blocks)]
    dev = prob.kf_R.device
    S = torch.zeros((K, K, 6, 6), device=dev)
    b = torch.zeros((K, 6), device=dev)
    for blk in blocks:
        Sb, bb, _ = _assemble(blk, cam, use_huber, chi2_mono, chi2_stereo,
                              damping)
        S = S + Sb
        b = b + bb
    if reduce_fn is not None:
        S, b = reduce_fn(S, b)
    dxi = _solve_cameras(S, b, prob.kf_fixed, prob.kf_valid, damping)
    new_pts = torch.cat([
        _backsub(_point_terms(blk, cam, use_huber, chi2_mono, chi2_stereo,
                              damping)[0], dxi, blk.pt_valid, blk.pt_pos)
        for blk in blocks])
    new_pose = se3.retract(SE3(prob.kf_R, prob.kf_t), dxi)
    return prob._replace(kf_R=new_pose.R, kf_t=new_pose.t, pt_pos=new_pts)


def optimize_global_ba(prob: BAProblem, cam: CameraConfig,
                       cfg: OptimizerConfig, n_blocks: int = 8,
                       reduce_fn=None) -> BAResult:
    """Full-map BA: ``global_ba_iters`` Huber GN iterations over the point
    blocks, then the final outlier gate. ``reduce_fn``: see
    ``_gn_iteration``."""
    for _ in range(cfg.global_ba_iters):
        prob = _gn_iteration_chunked(prob, cam, True, cfg.chi2_mono,
                                     cfg.chi2_stereo, damping=1e-5,
                                     n_blocks=n_blocks, reduce_fn=reduce_fn)
    final_valid, chi2 = _gate(prob, cam, cfg.chi2_mono, cfg.chi2_stereo)
    return BAResult(kf_R=prob.kf_R, kf_t=prob.kf_t, pt_pos=prob.pt_pos,
                    obs_valid=final_valid, chi2=chi2)


def _gate(prob: BAProblem, cam: CameraConfig, chi2_m: float, chi2_s: float):
    e, _, _, is_stereo = _residuals_jacobians(prob, cam)
    chi2 = torch.sum(e * e, dim=-1) * prob.obs_w
    th = torch.where(is_stereo, chi2_s, chi2_m)
    return prob.obs_valid & (chi2 <= th), chi2


def optimize_local_ba(prob: BAProblem, cam: CameraConfig,
                      cfg: OptimizerConfig, reduce_fn=None) -> BAResult:
    """5 iterations, outlier gate, 10 iterations, final gate.
    ``reduce_fn``: see ``_gn_iteration``."""
    chi2_m, chi2_s = cfg.chi2_mono, cfg.chi2_stereo
    for _ in range(cfg.local_ba_iters_first):
        prob = _gn_iteration(prob, cam, True, chi2_m, chi2_s, damping=1e-5,
                             reduce_fn=reduce_fn)
    prob = prob._replace(obs_valid=_gate(prob, cam, chi2_m, chi2_s)[0])
    for _ in range(cfg.local_ba_iters_second):
        prob = _gn_iteration(prob, cam, True, chi2_m, chi2_s, damping=1e-5,
                             reduce_fn=reduce_fn)
    final_valid, chi2 = _gate(prob, cam, chi2_m, chi2_s)
    return BAResult(kf_R=prob.kf_R, kf_t=prob.kf_t, pt_pos=prob.pt_pos,
                    obs_valid=final_valid, chi2=chi2)

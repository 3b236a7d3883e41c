"""Two-view monocular initialisation: batched H/F RANSAC + motion recovery.

Counterpart of the device half of ``coebslam_tpu/ops/initializer_ops.py``
(Initializer.cc): both models' hypothesis batches are scored at once with
the reference's truncated symmetric-transfer scores, ``RH = SH / (SH + SF)
> 0.40`` picks the homography, and motion comes from Faugeras' 8-way
homography decomposition or the 4-way essential decomposition, arbitrated
by triangulation support (CheckRT).

Differences forced by PyTorch: hypothesis samples come from a
``torch.Generator`` or are given (``idx_h``, ``idx_f``), since a torch
generator cannot reproduce ``jax.random`` draws; SVDs use cuSOLVER's
``gesvd`` on the card (the default driver reads convergence flags back to
the host); inverses go through ``inv_ex`` or the closed form, which do not
check for errors on the host. The decompositions return stacked tensors,
and their hypotheses may come in another order than the reference's when
LAPACK and cuSOLVER pick other SVD signs: the set is the same.

The homography DLT is built in pixel coordinates, as in the reference, and
its [8, 9] system is ill-conditioned in float32: two SVD libraries give
null vectors that differ by a median 0.1-0.6 % per hypothesis, so H
matches the reference's only to that accuracy (and a near-tie in scores
may pick another hypothesis); everything downstream of the models matches
to rounding.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..config import CameraConfig
from . import fundamental as fmod

TH_F = 3.841      # chi2(1) 95% — F distance score threshold
TH_H = 5.991      # chi2(2) — H transfer score threshold
GAMMA = 5.991     # score offset (Initializer.cc CheckFundamental/Homography)


def _svd(A, full_matrices=True):
    driver = "gesvd" if A.is_cuda else None
    return torch.linalg.svd(A, full_matrices=full_matrices, driver=driver)


def _det3(M):
    """Closed-form determinant of [..., 3, 3] matrices."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


@functools.lru_cache(maxsize=None)
def intrinsics(cam: CameraConfig, device: str):
    """(K, K^-1, (cx, cy), (fx, fy)) on ``device``, made once."""
    K = torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy],
                      [0.0, 0.0, 1.0]], dtype=torch.float32)
    return (K.to(device), torch.linalg.inv(K).to(device),
            torch.tensor([cam.cx, cam.cy], dtype=torch.float32).to(device),
            torch.tensor([cam.fx, cam.fy], dtype=torch.float32).to(device))


@functools.lru_cache(maxsize=None)
def _decomposition_constants(device: str):
    """The essential decomposition's W and the homography decomposition's
    sign patterns (x1, x3, sin) of its four hypotheses, made once."""
    f = lambda v: torch.tensor(v, dtype=torch.float32).to(device)
    return (f([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]),
            f([1.0, 1.0, -1.0, -1.0]), f([1.0, -1.0, 1.0, -1.0]),
            f([1.0, -1.0, -1.0, 1.0]))


# --------------------------------------------------------------------- #
# homography estimation
# --------------------------------------------------------------------- #

def _dlt_homography(p1, p2):
    """H [..., 3, 3] from correspondences [..., K, 2] by DLT: the null
    space of the [2K, 9] system (the last row of Vh)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                 # [..., 2K, 9]
    vt = _svd(A, full_matrices=True)[2]
    return vt[..., -1, :].reshape(*A.shape[:-2], 3, 3)


def _h_transfer_error(H, p1, p2):
    """Symmetric transfer squared errors ([..., N] each direction) of
    homographies H [..., 3, 3]."""
    ones = torch.ones((*p1.shape[:-1], 1), dtype=p1.dtype, device=p1.device)
    x1h = torch.cat([p1, ones], dim=-1)
    x2h = torch.cat([p2, ones], dim=-1)

    def dehom(x):
        w = x[..., 2:]
        return x[..., :2] / torch.where(torch.abs(w) < 1e-9,
                                        torch.full_like(w, 1e-9), w)

    Hx1 = dehom(x1h @ H.transpose(-1, -2))
    Hinv = torch.linalg.inv_ex(H)[0]
    Hx2 = dehom(x2h @ Hinv.transpose(-1, -2))
    e12 = torch.sum((Hx1 - p2) ** 2, dim=-1)
    e21 = torch.sum((Hx2 - p1) ** 2, dim=-1)
    return e21, e12


class TwoViewModels(NamedTuple):
    H: torch.Tensor
    F: torch.Tensor
    score_h: torch.Tensor
    score_f: torch.Tensor
    inliers_h: torch.Tensor
    inliers_f: torch.Tensor


def pick(x, i):
    """``x[i]`` for a 0-d device index ``i`` without reading it back."""
    return x.index_select(0, i.reshape(1))[0]


def fit_models(p1, p2, valid, idx_h=None, idx_f=None, *,
               generator: Optional[torch.Generator] = None,
               n_hypotheses: int = 200, sigma: float = 1.0) -> TwoViewModels:
    """Fit H and F with batched RANSAC and the reference's truncated scores
    (score += gamma - chi2 for chi2 < gamma, both directions).

    ``idx_h`` [H, 4] and ``idx_f`` [H, 8] are the hypotheses' sample
    indices; those not given are drawn from ``generator`` (H first, then F).
    """
    inv_s2 = 1.0 / (sigma * sigma)
    if idx_h is None:
        idx_h = fmod.sample_indices(valid, n_hypotheses, generator, k=4)
    if idx_f is None:
        idx_f = fmod.sample_indices(valid, n_hypotheses, generator, k=8)
    vf = valid.to(p1.dtype)
    zero = torch.zeros((), dtype=p1.dtype, device=p1.device)

    # ---- homography (4-point samples)
    H_h = _dlt_homography(p1[idx_h], p2[idx_h])               # [H, 3, 3]
    e21, e12 = _h_transfer_error(H_h, p1[None], p2[None])      # [H, N]
    c21, c12 = e21 * inv_s2, e12 * inv_s2
    inl_h = (c21 < TH_H) & (c12 < TH_H) & valid
    s_h = torch.where(c21 < TH_H, GAMMA - c21, zero) \
        + torch.where(c12 < TH_H, GAMMA - c12, zero)
    scores_h = torch.sum(s_h * vf, dim=-1)
    best_h = torch.argmax(scores_h)

    # ---- fundamental (8-point samples)
    F_h = fmod._eight_point(p1[idx_f], p2[idx_f])              # [H, 3, 3]
    d12 = fmod.epipolar_distance(F_h, p1[None], p2[None]) ** 2 * inv_s2
    d21 = fmod.epipolar_distance(F_h.transpose(-1, -2), p2[None],
                                 p1[None]) ** 2 * inv_s2
    inl_f = (d12 < TH_F) & (d21 < TH_F) & valid
    s_f = torch.where(d12 < TH_F, GAMMA - d12, zero) \
        + torch.where(d21 < TH_F, GAMMA - d21, zero)
    scores_f = torch.sum(s_f * vf, dim=-1)
    best_f = torch.argmax(scores_f)

    return TwoViewModels(
        H=pick(H_h, best_h), F=pick(F_h, best_f),
        score_h=pick(scores_h, best_h), score_f=pick(scores_f, best_f),
        inliers_h=pick(inl_h, best_h), inliers_f=pick(inl_f, best_f))


# --------------------------------------------------------------------- #
# triangulation + hypothesis checking
# --------------------------------------------------------------------- #

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
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30,
                                torch.full_like(det, 1e-30), det)
    rows = torch.stack([torch.stack([A, B, C], -1), torch.stack([D, E, F], -1),
                        torch.stack([G, Hc, K], -1)], -2)
    return rows * inv_det[..., None, None]


def triangulate_dlt(P1, P2, p1, p2):
    """Linear triangulation of [..., N, 2] normalized coordinates through
    [..., 3, 4] projection matrices -> [..., N, 3].

    Solved inhomogeneously (X4 = 1) through the 3x3 normal equations with a
    closed-form inverse and a 1e-9 Tikhonov floor, as the reference does."""
    P1 = P1[..., None, :, :]
    P2 = P2[..., None, :, :]
    rows = torch.stack([
        p1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        p1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        p2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        p2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ], dim=-2)                                       # [..., N, 4, 4]
    A = rows[..., :3]
    b = -rows[..., 3]
    AtA = torch.einsum("...ri,...rj->...ij", A, A)   # [..., N, 3, 3]
    Atb = torch.einsum("...ri,...r->...i", A, b)     # [..., N, 3]
    AtA = AtA + 1e-9 * torch.eye(3, dtype=AtA.dtype, device=AtA.device)
    return torch.einsum("...ij,...j->...i", _inv3x3(AtA), Atb)


def check_rt(R, t, p1, p2, valid, sigma: float = 1.0):
    """Cheirality + reprojection + parallax filter of (R [..., 3, 3], t
    [..., 3]) hypotheses on normalized points p1/p2 [N, 2] (CheckRT).

    Returns (good [..., N], X [..., N, 3], reprojection error [..., N],
    parallax cosine [..., N]).
    """
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    P1 = torch.cat([eye, torch.zeros_like(t)[..., None]], dim=-1)
    P2 = torch.cat([R, t[..., None]], dim=-1)
    X = triangulate_dlt(P1, P2, p1, p2)

    z1 = X[..., 2]
    X2 = X @ R.transpose(-1, -2) + t[..., None, :]
    z2 = X2[..., 2]

    C2 = -torch.einsum("...ji,...j->...i", R, t)
    r1 = X
    r2 = X - C2[..., None, :]
    cos_par = torch.sum(r1 * r2, -1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1),
        min=1e-9)

    def proj_err(Xc, z, p):
        zz = z[..., None]
        zz = torch.where(torch.abs(zz) < 1e-9, torch.full_like(zz, 1e-9), zz)
        return torch.sum((Xc[..., :2] / zz - p) ** 2, -1)

    e1 = proj_err(X, z1, p1)
    e2 = proj_err(X2, z2, p2)
    good = valid & (z1 > 0) & (z2 > 0) & (cos_par < 0.99998)
    return good, X, e1 + e2, cos_par


def decompose_essential(E):
    """E -> 4 (R, t) hypotheses, stacked: R [4, 3, 3], t [4, 3], in the
    order (R1, t), (R1, -t), (R2, t), (R2, -t) (DecomposeE)."""
    u, _, vt = _svd(E)
    u = u * torch.sign(_det3(u))
    vt = vt * torch.sign(_det3(vt))
    W = _decomposition_constants(str(E.device))[0]
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-9)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def decompose_homography(H):
    """Faugeras SVD decomposition of a normalized-coordinate homography into
    8 (R, t, n) hypotheses, stacked: R [8, 3, 3], t [8, 3], n [8, 3]
    (ReconstructH; d' > 0 branch first, then d' < 0)."""
    U, S, Vt = _svd(H)
    d1, d2, d3 = S[0], S[1], S[2]
    s = _det3(U) * _det3(Vt)
    V = Vt.T

    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / torch.clamp(
        d1 * d1 - d3 * d3, min=1e-12), min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / torch.clamp(
        d1 * d1 - d3 * d3, min=1e-12), min=0.0))
    _, pm, mp, spm = _decomposition_constants(str(H.device))
    x1 = aux1 * pm                                   # [4]
    x3 = aux3 * mp
    zero = torch.zeros_like(x1)
    one = torch.ones_like(x1)

    def mat3(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    # d' > 0 branch.
    den_p = torch.clamp((d1 + d3) * d2, min=1e-12)
    aux_st = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2)
                                    * (d2 * d2 - d3 * d3), min=0.0)) / den_p
    ct = ((d2 * d2 + d1 * d3) / den_p).expand(4)
    st = aux_st * spm
    Rp = mat3([[ct, zero, -st], [zero, one, zero], [st, zero, ct]])
    R_a = s * U @ Rp @ Vt
    t_a = (torch.stack([x1, zero, -x3], -1) * (d1 - d3)) @ U.T
    n_a = torch.stack([x1, zero, x3], -1) @ V.T

    # d' < 0 branch.
    den_m = torch.clamp((d1 - d3) * d2, min=1e-12)
    aux_sp = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2)
                                    * (d2 * d2 - d3 * d3), min=0.0)) / den_m
    cp = ((d1 * d3 - d2 * d2) / den_m).expand(4)
    sp = aux_sp * spm
    Rp = mat3([[cp, zero, sp], [zero, -one, zero], [sp, zero, -cp]])
    R_b = s * U @ Rp @ Vt
    t_b = (torch.stack([x1, zero, x3], -1) * (d1 + d3)) @ U.T
    n_b = n_a

    R = torch.cat([R_a, R_b])
    t = torch.cat([t_a, t_b])
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-9)
    return R, t, torch.cat([n_a, n_b])


class ReconstructionResult(NamedTuple):
    ok: torch.Tensor              # bool 0-d
    R: torch.Tensor               # [3, 3]
    t: torch.Tensor               # [3] (unit scale)
    points: torch.Tensor          # [N, 3]
    good: torch.Tensor            # [N] bool triangulated
    used_homography: torch.Tensor  # bool 0-d


def _pixels_to_normalized_h(H_px, cam: CameraConfig):
    """A pixel-coordinate homography in normalized coordinates:
    Hn = K^-1 H K."""
    K, Kinv = intrinsics(cam, str(H_px.device))[:2]
    return Kinv @ H_px @ K


def reconstruct(p1_px, p2_px, valid, cam: CameraConfig, idx_h=None,
                idx_f=None, *, generator=None, n_hypotheses: int = 200,
                sigma: float = 1.0,
                min_triangulated: int = 50) -> ReconstructionResult:
    """Two-view initialisation on the host's route (Initializer.cc):
    ``fit_models``, one read of the RH choice (RH > 0.40), then only the
    chosen model's hypotheses are checked and the first with the most good
    points wins. ``used_homography`` is a Python bool here."""
    models = fit_models(p1_px, p2_px, valid, idx_h, idx_f,
                        generator=generator, n_hypotheses=n_hypotheses,
                        sigma=sigma)
    K, _, c, f = intrinsics(cam, str(p1_px.device))
    p1 = (p1_px - c) / f
    p2 = (p2_px - c) / f
    thr_n2 = (4.0 * sigma / cam.fx) ** 2
    rh = models.score_h / torch.clamp(models.score_h + models.score_f,
                                      min=1e-9)
    use_h = bool(rh > 0.40)
    if use_h:
        Rs, ts, _ = decompose_homography(
            _pixels_to_normalized_h(models.H, cam))
        inl = models.inliers_h
    else:
        Rs, ts = decompose_essential(K.T @ models.F @ K)
        inl = models.inliers_f
    good, X, err, _ = check_rt(Rs, ts, p1, p2, inl)
    good = good & (err < thr_n2)
    ns = good.sum(-1)
    b = int(torch.argmax(ns))
    return ReconstructionResult(ok=ns[b] >= min_triangulated, R=Rs[b],
                                t=ts[b], points=X[b], good=good[b],
                                used_homography=use_h)


def reconstruct_graph(p1_px, p2_px, valid, cam: CameraConfig, idx_h=None,
                      idx_f=None, *, generator=None, n_hypotheses: int = 200,
                      sigma: float = 1.0,
                      min_triangulated: int = 50) -> ReconstructionResult:
    """Two-view initialisation with no host read: ``fit_models`` then
    ``recover_motion``."""
    models = fit_models(p1_px, p2_px, valid, idx_h, idx_f,
                        generator=generator, n_hypotheses=n_hypotheses,
                        sigma=sigma)
    return recover_motion(models, p1_px, p2_px, cam, sigma=sigma,
                          min_triangulated=min_triangulated)


def recover_motion(models: TwoViewModels, p1_px, p2_px, cam: CameraConfig,
                   *, sigma: float = 1.0,
                   min_triangulated: int = 50) -> ReconstructionResult:
    """Motion from fitted models: both model paths (8 homography
    hypotheses, 4 essential ones padded to 8) are checked, the RH rule (RH
    > 0.40, fixed as in the reference) picks between them with ``where``,
    and the hypothesis with the most good points wins (the first on a
    tie)."""
    K, _, c, f = intrinsics(cam, str(p1_px.device))
    p1 = (p1_px - c) / f
    p2 = (p2_px - c) / f
    sigma_n = sigma / cam.fx
    thr_n2 = (4.0 * sigma_n) ** 2
    rh = models.score_h / torch.clamp(models.score_h + models.score_f,
                                      min=1e-9)
    use_h = rh > 0.40

    R_h, t_h, _ = decompose_homography(_pixels_to_normalized_h(models.H, cam))
    E = K.T @ models.F @ K
    R_f, t_f = decompose_essential(E)
    Rs = torch.where(use_h, R_h, torch.cat([R_f, R_f]))
    ts = torch.where(use_h, t_h, torch.cat([t_f, t_f]))
    inl = torch.where(use_h, models.inliers_h, models.inliers_f)

    good, X, err, _ = check_rt(Rs, ts, p1, p2, inl, sigma=sigma_n)
    good = good & (err < thr_n2)
    ns = good.sum(-1)
    b = torch.argmax(ns)
    return ReconstructionResult(
        ok=pick(ns, b) >= min_triangulated, R=pick(Rs, b), t=pick(ts, b),
        points=pick(X, b), good=pick(good, b), used_homography=use_h)

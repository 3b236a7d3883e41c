"""SO(3) rotation-group operations, batched over leading dimensions.

Counterpart of ``coebslam_tpu/geometry/so3.py``. The Taylor-branch
thresholds are sized for float32 exactly as there: ``1 - cos t`` loses all
precision below t ~ 3e-4, so ``exp`` switches to the series at t < 1e-2.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w):
    """so(3) hat operator: [..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(W):
    """Inverse of hat: [..., 3, 3] -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp(w):
    """Rodrigues exponential so(3) -> SO(3): [..., 3] -> [..., 3, 3]."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS ** 2))
    small = theta2 < 1e-4                      # theta < 1e-2
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def log(R):
    """Logarithm map SO(3) -> so(3): [..., 3, 3] -> [..., 3]."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-6, 1.0 - 1e-6)
    theta = torch.arccos(cos_theta)
    sin_theta = torch.sin(theta)
    tiny = torch.abs(sin_theta) < _EPS
    sin_safe = torch.where(tiny, torch.ones_like(sin_theta), sin_theta)
    factor = torch.where(tiny, 0.5 + theta * theta / 12.0,
                         theta / (2.0 * sin_safe))
    antisym = vee(R - R.transpose(-1, -2))
    w = factor[..., None] * antisym

    # Near theta = pi: recover the axis from the symmetric part.
    near_pi = theta > 3.0
    one_minus_cos = torch.clamp(1.0 - cos_theta, min=_EPS)
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    n_abs = torch.sqrt(torch.clamp(
        (diag - cos_theta[..., None]) / one_minus_cos[..., None], min=0.0))
    sym = 0.5 * (R + R.transpose(-1, -2))
    k = torch.argmax(n_abs, dim=-1)
    row_k = torch.take_along_dim(
        sym, k[..., None, None].expand(*k.shape, 1, 3), dim=-2)[..., 0, :]
    signs = torch.where(row_k >= 0.0, 1.0, -1.0)
    axis = n_abs * signs
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True),
                              min=_EPS)
    dot = torch.sum(axis * antisym, dim=-1, keepdim=True)
    axis = axis * torch.where(dot < 0.0, -1.0, 1.0)
    w_pi = theta[..., None] * axis
    return torch.where(near_pi[..., None], w_pi, w)


def left_jacobian(w):
    """Left Jacobian J_l of SO(3): [..., 3] -> [..., 3, 3]."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS ** 2))
    small = theta2 < _EPS
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    W = hat(w)
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def left_jacobian_inv(w):
    """Inverse left Jacobian of SO(3)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS ** 2))
    small = theta2 < _EPS
    half = theta * 0.5
    cot = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS))
        / torch.clamp(theta2, min=_EPS ** 2))
    W = hat(w)
    return _eye_like(W) - 0.5 * W + cot[..., None, None] * (W @ W)


def orthonormalize(R, iterations: int = 2):
    """Newton polar iteration R <- 1.5 R - 0.5 R R^T R back onto SO(3)."""
    for _ in range(iterations):
        R = 1.5 * R - 0.5 * R @ R.transpose(-1, -2) @ R
    return R


def normalize_matrix(R):
    """The nearest rotation to R [..., 3, 3] by SVD projection."""
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(u @ vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    return (u * d[..., None, :]) @ vt


def quat_to_matrix(q):
    """Unit quaternion (w, x, y, z) -> rotation matrix: [..., 4] ->
    [..., 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def quat_terms(R):
    """The sums and differences of entries of R [..., 3, 3] that
    ``matrix_to_quat`` reads, in R's dtype: the four pivots (trace and the
    three diagonal excesses), the four radicands, and the six off-diagonal
    combinations."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    return dict(
        pivots=(tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11),
        radicands=(tr + 1.0, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                   1.0 - m00 - m11 + m22),
        d21=m21 - m12, d02=m02 - m20, d10=m10 - m01,
        s01=m01 + m10, s02=m02 + m20, s12=m12 + m21)


def quat_from_terms(t):
    """Unit quaternion (w, x, y, z), w >= 0, from ``quat_terms``: of the
    four candidate square roots the one with the largest pivot is taken,
    without a data-dependent branch."""
    def sqrt(x):
        # Correctly rounded: the CPU's vectorised float32 sqrt may be off by
        # one bit, which a trajectory writer's text would show.
        return torch.sqrt(x.double()).to(x.dtype)

    s0, s1, s2, s3 = [sqrt(torch.clamp(r, min=_EPS)) * 2
                      for r in t["radicands"]]
    d21, d02, d10 = t["d21"], t["d02"], t["d10"]
    s01, s02, s12 = t["s01"], t["s02"], t["s12"]
    q0 = torch.stack([0.25 * s0, d21 / s0, d02 / s0, d10 / s0], dim=-1)
    q1 = torch.stack([d21 / s1, 0.25 * s1, s01 / s1, s02 / s1], dim=-1)
    q2 = torch.stack([d02 / s2, s01 / s2, 0.25 * s2, s12 / s2], dim=-1)
    q3 = torch.stack([d10 / s3, s02 / s3, s12 / s3, 0.25 * s3], dim=-1)
    idx = torch.argmax(torch.stack(t["pivots"], dim=-1), dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)     # [..., 4 candidates, 4]
    q = torch.take_along_dim(
        qs, idx[..., None, None].expand(*idx.shape, 1, 4), dim=-2)[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    # The norm's sum of squares is accumulated in order with a fused
    # multiply-add, as XLA computes it on the CPU, so the quaternion (and
    # the text a trajectory writer prints from it) matches to the bit.
    acc = q[..., 0] * q[..., 0]
    for k in range(1, 4):
        acc = (acc.double() + q[..., k].double() ** 2).to(q.dtype)
    return q / sqrt(acc)[..., None]


def matrix_to_quat(R):
    """Rotation matrix -> unit quaternion (w, x, y, z) with w >= 0:
    [..., 3, 3] -> [..., 4]."""
    return quat_from_terms(quat_terms(R))

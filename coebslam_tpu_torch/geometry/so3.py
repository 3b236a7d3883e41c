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

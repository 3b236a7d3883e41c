"""Pinhole camera model: projection, unprojection, undistortion, frustum.

Counterpart of ``coebslam_tpu/geometry/camera.py``.
"""
from __future__ import annotations

import torch

from ..config import CameraConfig


def intrinsic_matrix(cam: CameraConfig, dtype=torch.float32, device=None):
    """The 3x3 pinhole matrix K of ``cam``."""
    return torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy],
                         [0.0, 0.0, 1.0]], dtype=dtype, device=device)


def project(cam: CameraConfig, pts_cam):
    """Camera-frame points [..., 3] -> pixels [..., 2]."""
    z = pts_cam[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = cam.fx * pts_cam[..., 0] / z_safe + cam.cx
    v = cam.fy * pts_cam[..., 1] / z_safe + cam.cy
    return torch.stack([u, v], dim=-1)


def project_stereo(cam: CameraConfig, pts_cam):
    """(u, v, u_right) with the virtual right camera u_r = u - bf / z."""
    uv = project(cam, pts_cam)
    z = pts_cam[..., 2]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    ur = uv[..., 0] - cam.bf / z
    return torch.cat([uv, ur[..., None]], dim=-1)


def unproject(cam: CameraConfig, uv, depth):
    """Pixels [..., 2] with depth [...] -> camera-frame points [..., 3]."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def distort_normalized(cam: CameraConfig, xy):
    """Radial-tangential (plumb-bob) model on normalized coordinates."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2 + cam.k3 * r2 * r2 * r2
    x_d = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    y_d = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([x_d, y_d], dim=-1)


def undistort_points(cam: CameraConfig, uv, iterations: int = 8):
    """Fixed-point undistortion of pixels [..., 2] (identity when k=p=0)."""
    if cam.k1 == cam.k2 == cam.p1 == cam.p2 == cam.k3 == 0.0:
        return uv
    x0 = (uv[..., 0] - cam.cx) / cam.fx
    y0 = (uv[..., 1] - cam.cy) / cam.fy
    xy = torch.stack([x0, y0], dim=-1)
    guess = xy
    for _ in range(iterations):
        guess = xy - (distort_normalized(cam, guess) - guess)
    return torch.stack([guess[..., 0] * cam.fx + cam.cx,
                        guess[..., 1] * cam.fy + cam.cy], dim=-1)


def in_frustum(cam: CameraConfig, pts_cam, margin=0.0):
    """Points in front of the camera and inside the image (+ margin)."""
    z_ok = pts_cam[..., 2] > 1e-6
    uv = project(cam, pts_cam)
    u_ok = (uv[..., 0] >= -margin) & (uv[..., 0] < cam.width + margin)
    v_ok = (uv[..., 1] >= -margin) & (uv[..., 1] < cam.height + margin)
    return z_ok & u_ok & v_ok

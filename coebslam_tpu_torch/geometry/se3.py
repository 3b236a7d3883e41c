"""SE(3) rigid transforms as (R [..., 3, 3], t [..., 3]) pairs (Tcw).

Counterpart of ``coebslam_tpu/geometry/se3.py``; tangent vectors are
``[omega | upsilon]`` (rotation first) and ``retract`` is the
left-multiplicative update exp(xi) * T, re-projected onto SO(3).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import so3


class SE3(NamedTuple):
    """Rigid transform: rotation [..., 3, 3], translation [..., 3]."""

    R: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "SE3":
        R = torch.eye(3, dtype=dtype, device=device).expand(
            *batch_shape, 3, 3).clone()
        t = torch.zeros(*batch_shape, 3, dtype=dtype, device=device)
        return SE3(R, t)

    @staticmethod
    def from_matrix(T) -> "SE3":
        """From [..., 4, 4] (or [..., 3, 4]) matrices."""
        return SE3(T[..., :3, :3], T[..., :3, 3])

    def as_matrix(self):
        """[..., 4, 4] homogeneous matrices."""
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=self.t.dtype,
                              device=self.t.device).expand(
            *self.t.shape[:-1], 4)
        top = torch.cat([self.R, self.t[..., None]], dim=-1)
        return torch.cat([top, bottom[..., None, :]], dim=-2)

    def inverse(self) -> "SE3":
        Rt = self.R.transpose(-1, -2)
        return SE3(Rt, -torch.einsum("...ij,...j->...i", Rt, self.t))

    def compose(self, other: "SE3") -> "SE3":
        """self @ other (apply ``other`` first)."""
        return SE3(self.R @ other.R,
                   torch.einsum("...ij,...j->...i", self.R, other.t) + self.t)

    def apply(self, points):
        """Transform points [..., N, 3] (or one point [3]) by this pose."""
        if points.ndim >= 2:
            return torch.einsum("...ij,...nj->...ni", self.R, points) \
                + self.t[..., None, :]
        return self.R @ points + self.t

    def normalize(self) -> "SE3":
        """The rotation projected back onto SO(3) by SVD."""
        return SE3(so3.normalize_matrix(self.R), self.t)


def exp(xi) -> SE3:
    """se(3) exponential of ``xi = [omega | upsilon]``."""
    omega = xi[..., :3]
    upsilon = xi[..., 3:]
    R = so3.exp(omega)
    V = so3.left_jacobian(omega)
    return SE3(R, torch.einsum("...ij,...j->...i", V, upsilon))


def log(T: SE3):
    """SE3 -> se(3) tangent ``[omega | upsilon]``."""
    omega = so3.log(T.R)
    Vinv = so3.left_jacobian_inv(omega)
    upsilon = torch.einsum("...ij,...j->...i", Vinv, T.t)
    return torch.cat([omega, upsilon], dim=-1)


def retract(T: SE3, xi) -> SE3:
    """exp(xi) * T, with the rotation re-projected onto SO(3)."""
    out = exp(xi).compose(T)
    return SE3(so3.orthonormalize(out.R), out.t)


def transform_points(T: SE3, pts):
    """Apply T to points [..., 3] with full broadcasting."""
    return torch.einsum("...ij,...j->...i", T.R, pts) + T.t


def relative(T_a: SE3, T_b: SE3) -> SE3:
    """T_a * T_b^-1: the transform mapping frame b to frame a."""
    return T_a.compose(T_b.inverse())

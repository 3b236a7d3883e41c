"""Sim(3) similarity-transform operations, batched-first.

Counterpart of ``coebslam_tpu/geometry/sim3.py``. A Sim3 is ``(s, R, t)``:
``x' = s * R @ x + t``; the loop-closing pose graph runs over them. The
Taylor-branch thresholds are sized for float32 exactly as there, and
``log`` solves with ``torch.linalg.solve_ex`` (a singular ``W`` gives
inf/nan like the reference, where ``solve`` would raise on the CPU and
synchronise on the card).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import so3

_EPS = 1e-7


class Sim3(NamedTuple):
    s: torch.Tensor            # [...] scale
    R: torch.Tensor            # [..., 3, 3]
    t: torch.Tensor            # [..., 3]

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "Sim3":
        eye = torch.eye(3, dtype=dtype, device=device)
        return Sim3(torch.ones(batch_shape, dtype=dtype, device=device),
                    eye.expand(*batch_shape, 3, 3).clone(),
                    torch.zeros((*batch_shape, 3), dtype=dtype, device=device))

    @staticmethod
    def from_se3(R, t, s=None) -> "Sim3":
        if s is None:
            s = torch.ones(t.shape[:-1], dtype=t.dtype, device=t.device)
        return Sim3(s, R, t)

    def inverse(self) -> "Sim3":
        Rt = self.R.transpose(-1, -2)
        s_inv = 1.0 / self.s
        return Sim3(s_inv, Rt,
                    -s_inv[..., None] * torch.einsum("...ij,...j->...i", Rt,
                                                     self.t))

    def compose(self, other: "Sim3") -> "Sim3":
        return Sim3(self.s * other.s, self.R @ other.R,
                    self.s[..., None] * torch.einsum("...ij,...j->...i",
                                                     self.R, other.t) + self.t)

    def apply(self, pts):
        """Transform points [..., 3]."""
        return (self.s[..., None]
                * torch.einsum("...ij,...j->...i", self.R, pts) + self.t)

    def to_se3_matrix(self):
        """The SE3 matrix ``[R | t/s]`` (the reference's conversion after
        essential-graph optimization)."""
        top = torch.cat([self.R, (self.t / self.s[..., None])[..., None]],
                        dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=self.t.dtype,
                              device=self.t.device).expand(
                                  *self.t.shape[:-1], 4)
        return torch.cat([top, bottom[..., None, :]], dim=-2)


def _calc_w_coeffs(omega, sigma):
    """Coefficients (cI, cW, cW2) with W = cI*I + cW*hat(w) + cW2*hat(w)^2.

    Standard Sim3 closed form (Strasdat, appendix; g2o's sim3.h). The
    branch thresholds are sized for float32, not epsilon-small: the closed
    forms difference like (theta - sin theta)/theta^3, which loses all f32
    precision below theta ~ 1e-2, and the Taylor branches carry enough
    terms to be exact to f32 at the crossover.
    """
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    s = torch.exp(sigma)
    sigma2 = sigma * sigma
    small_s = torch.abs(sigma) < 1e-3
    small_t = theta < 1e-2

    one = torch.ones_like(sigma)
    safe_sigma = torch.where(small_s, one, sigma)
    safe_sigma2 = torch.where(small_s, one, sigma2)
    safe_theta = torch.where(small_t, one, theta)
    safe_theta2 = torch.where(small_t, one, theta2)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)

    # cI = (s - 1)/sigma  ->  1 + sigma/2 as sigma -> 0.
    cI = torch.where(small_s, 1.0 + sigma / 2.0 + sigma2 / 6.0,
                     (s - 1.0) / safe_sigma)

    # sigma ~ 0 branch:
    cW_s0 = torch.where(small_t, 0.5 - theta2 / 24.0,
                        (1.0 - cos_t) / safe_theta2)
    cW2_s0 = torch.where(small_t, 1.0 / 6.0 - theta2 / 120.0,
                         (theta - sin_t) / (safe_theta2 * safe_theta))

    # general sigma branch:
    a = s * sin_t
    b = s * cos_t
    c = theta2 + sigma2
    safe_c = torch.where(c < _EPS * _EPS, one, c)
    cW_gen_t = (a * sigma + (1.0 - b) * theta) / (safe_theta * safe_c)
    cW2_gen_t = (cI - ((b - 1.0) * sigma + a * theta) / safe_c) / safe_theta2
    # theta ~ 0, sigma general:
    cW_gen_t0 = ((sigma - 1.0) * s + 1.0) / safe_sigma2
    cW2_gen_t0 = (s * (0.5 * sigma2 - sigma + 1.0) - 1.0) \
        / (safe_sigma2 * safe_sigma)
    cW_gen = torch.where(small_t, cW_gen_t0, cW_gen_t)
    cW2_gen = torch.where(small_t, cW2_gen_t0, cW2_gen_t)

    cW = torch.where(small_s, cW_s0, cW_gen)
    cW2 = torch.where(small_s, cW2_s0, cW2_gen)
    return cI, cW, cW2


def _w_matrix(omega, sigma):
    cI, cW, cW2 = _calc_w_coeffs(omega, sigma)
    W = so3.hat(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(W.shape)
    return (cI[..., None, None] * eye + cW[..., None, None] * W
            + cW2[..., None, None] * (W @ W))


def exp(xi) -> Sim3:
    """sim(3) exponential. ``xi = [omega(3) | upsilon(3) | sigma(1)]``:
    scale s = exp(sigma); t = W(omega, sigma) @ upsilon."""
    omega = xi[..., :3]
    upsilon = xi[..., 3:6]
    sigma = xi[..., 6]
    R = so3.exp(omega)
    t = torch.einsum("...ij,...j->...i", _w_matrix(omega, sigma), upsilon)
    return Sim3(torch.exp(sigma), R, t)


def log(S: Sim3):
    """Sim3 -> sim(3) tangent ``[omega | upsilon | sigma]``; inverts the
    translation coupling with a 3x3 solve against the ``W`` of ``exp``."""
    omega = so3.log(S.R)
    sigma = torch.log(S.s)
    W = _w_matrix(omega, sigma)
    upsilon = torch.linalg.solve_ex(W, S.t[..., None])[0][..., 0]
    return torch.cat([omega, upsilon, sigma[..., None]], dim=-1)

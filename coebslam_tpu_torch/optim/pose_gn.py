"""Robust pose-only Gauss-Newton — the per-frame camera solve.

Counterpart of ``coebslam_tpu/optim/pose_gn.py``: one SE3 with mono/stereo
reprojection edges, Huber kernel, 4 rounds x 10 iterations with chi-square
gating between rounds and the robust kernel dropped from round 3. The 6x6
normal systems go through ``torch.linalg.solve_ex``, which neither raises
on a singular system nor synchronises with the host.

On CPU tensors the schedule runs eagerly. On CUDA tensors its ~6,800 small
kernels are captured once as one CUDA graph and replayed on every later
call with the same shapes, dtypes and configs (``_Graph``): the same
kernels in the same order, so the result is bit-equal to the eager run's.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from ..config import CameraConfig, OptimizerConfig
from ..geometry import se3
from ..geometry.se3 import SE3
from ..utils import metrics

#: Eager runs before a capture (they load the kernels and make the cuBLAS
#: and cuSOLVER handles outside the graph).
WARMUP_RUNS = 3


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
    """Run the 4x10 robust GN schedule: eagerly on CPU tensors, as a
    replay of the captured schedule on CUDA tensors.

    Args:
      points_w: [N, 3] map points; obs: [N, 3] (u, v, u_right), u_right < 0
      for mono; inv_sigma2: [N] information; valid: [N] bool.
    """
    inputs = (pose0.R, pose0.t, points_w, obs, inv_sigma2, valid)
    if obs.device.type != "cuda":
        return _solve(*inputs, cam, cfg)
    key = (obs.device, tuple(x.shape for x in inputs),
           tuple(x.dtype for x in inputs), cam, cfg)
    with _lock:
        graph = _graphs.get(key)
        if graph is None:
            graph = _graphs[key] = _Graph(inputs, cam, cfg)
        return graph.replay(inputs)


_graphs: dict = {}          # (device, shapes, dtypes, cam, cfg) -> _Graph
_lock = threading.Lock()
_pool = None                # the memory pool all graphs of the process share


class _Graph:
    """``_solve`` captured once as a CUDA graph over static input buffers
    (copies of the first call's inputs) and replayed: ``replay`` copies a
    call's inputs into them, replays, and returns clones of the static
    outputs, which the next replay overwrites."""

    def __init__(self, inputs, cam: CameraConfig, cfg: OptimizerConfig):
        global _pool
        if _pool is None:
            _pool = torch.cuda.graph_pool_handle()
        dev = inputs[0].device
        with torch.cuda.device(dev):
            self.inputs = [x.clone() for x in inputs]
            for _ in range(WARMUP_RUNS):
                _solve(*self.inputs, cam, cfg)
            # cuBLAS keeps a workspace per stream (32 MiB on an H100).
            # Cleared before and after the capture, the capture stream's
            # is made inside the graph's pool, and the current stream's is
            # made again where it was, so no second one stays allocated.
            torch._C._cuda_clearCublasWorkspaces()
            self.graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(self.graph, pool=_pool,
                                      stream=torch.cuda.Stream()):
                    self.out = _solve(*self.inputs, cam, cfg)
            finally:
                torch._C._cuda_clearCublasWorkspaces()
        metrics.count("pose_gn_captures")

    def replay(self, inputs) -> PoseOptResult:
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        self.graph.replay()                 # on its own device
        o = self.out
        metrics.count("pose_gn_replays")
        return PoseOptResult(pose=SE3(o.pose.R.clone(), o.pose.t.clone()),
                             inliers=o.inliers.clone(),
                             n_inliers=o.n_inliers.clone(),
                             chi2=o.chi2.clone())


def _solve(R0, t0, points_w, obs, inv_sigma2, valid, cam: CameraConfig,
           cfg: OptimizerConfig) -> PoseOptResult:
    """The schedule, eagerly: what runs on the CPU and what is captured."""
    is_stereo = obs[..., 2] >= 0.0
    delta_huber = torch.where(
        is_stereo,
        torch.sqrt(torch.full((), cfg.chi2_stereo, device=obs.device)),
        torch.sqrt(torch.full((), cfg.chi2_mono, device=obs.device)))
    chi2_th = torch.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
    eye6 = 1e-6 * torch.eye(6, dtype=obs.dtype, device=obs.device)

    def chi2_of(e):
        return torch.sum(e * e, dim=-1) * inv_sigma2

    pose, active = SE3(R0, t0), valid
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

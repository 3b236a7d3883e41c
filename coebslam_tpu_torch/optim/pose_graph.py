"""Essential-graph optimization: Gauss-Newton over Sim3 keyframe poses.

Counterpart of ``coebslam_tpu/optim/pose_graph.py``: nodes are keyframe
Sim3 poses, edges relative-pose constraints (sequential chain and loop
edges); fixed nodes hold the gauge. Per-edge 7x7 Jacobian blocks of the
Sim3 log-residual are scatter-added into a dense [7K, 7K] normal system
solved with ``torch.linalg.solve_ex``. The reference takes the blocks
from ``jax.jacfwd``; here they are central differences of the residual in
float64 (``_edge_jacobians``), because torch's forward mode runs every op
with a constant operand through Python reference decompositions: on the
H100 that cost 60 ms per iteration, and 13.7 s on its first call.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import OptimizerConfig
from ..geometry import sim3
from ..geometry.sim3 import Sim3


class PoseGraphProblem(NamedTuple):
    # Nodes.
    s: torch.Tensor             # [K]
    R: torch.Tensor             # [K, 3, 3]
    t: torch.Tensor             # [K, 3]
    fixed: torch.Tensor         # [K] bool
    valid: torch.Tensor         # [K] bool
    # Edges: measured relative Sim3  S_ij = S_i * S_j^-1  (i observed from j).
    edge_i: torch.Tensor        # [E] int64
    edge_j: torch.Tensor        # [E] int64
    edge_s: torch.Tensor        # [E]
    edge_R: torch.Tensor        # [E, 3, 3]
    edge_t: torch.Tensor        # [E, 3]
    edge_valid: torch.Tensor    # [E] bool
    edge_weight: torch.Tensor   # [E] float32


def _edge_residual(xi_i, xi_j, Si: Sim3, Sj: Sim3, Smeas: Sim3):
    """r = log( S_meas^-1 * (exp(xi_i) Si) * (exp(xi_j) Sj)^-1 )  [7]."""
    Si_new = sim3.exp(xi_i).compose(Si)
    Sj_new = sim3.exp(xi_j).compose(Sj)
    rel = Si_new.compose(Sj_new.inverse())
    return sim3.log(Smeas.inverse().compose(rel))


#: Central-difference step of the Jacobians (float64 evaluation: the
#: truncation error ~h^2 and the rounding ~1e-16/h are both ~1e-10).
_FD_STEP = 1e-5


def _edge_jacobians(s_i, R_i, t_i, s_j, R_j, t_j, s_m, R_m, t_m):
    """Residuals [E, 7] and their Jacobians [E, 7, 7] with respect to the
    left increments xi_i and xi_j at zero, by central differences of the
    residual evaluated in float64: one batched pass over the 28 steps
    (+-h along each of the 14 coordinates) and the point itself, for all
    edges. Exact to ~1e-9, far below the float32 rounding of the
    reference's forward-mode Jacobians."""
    E = s_i.shape[0]
    dev, f32, f64 = R_i.device, R_i.dtype, torch.float64
    eye = torch.eye(14, dtype=f64, device=dev) * _FD_STEP
    steps = torch.cat([eye, -eye, torch.zeros((1, 14), dtype=f64,
                                              device=dev)])
    xi = steps[:, None, :].expand(29, E, 14)
    ex = lambda *a: Sim3(*[x.to(f64).expand(29, *x.shape) for x in a])
    r = _edge_residual(xi[..., :7], xi[..., 7:], ex(s_i, R_i, t_i),
                       ex(s_j, R_j, t_j), ex(s_m, R_m, t_m))   # [29, E, 7]
    J = ((r[:14] - r[14:28]) / (2.0 * _FD_STEP)).permute(1, 2, 0).to(f32)
    return J[..., :7], J[..., 7:], r[28].to(f32)


def optimize_pose_graph(prob: PoseGraphProblem, cfg: OptimizerConfig,
                        n_iters: int = None, fix_scale: bool = False,
                        reduce_fn=None) -> PoseGraphProblem:
    """Run GN with per-iteration relinearization. Returns updated nodes.

    ``fix_scale``: constrain every node's scale to its current value
    (RGB-D/stereo: the reference's bFixScale essential graph).
    ``reduce_fn(H, b) -> (H, b)``: with the edge axis split over ranks,
    each rank scatter-adds its edges' blocks into a partial [K, K, 7, 7]
    system and the hook sums them (an all-reduce) before the free mask,
    the damping and the fixed-scale rows; the dense solve then runs on
    every rank alike.
    """
    K = prob.s.shape[0]
    iters = cfg.essential_graph_iters if n_iters is None else n_iters
    dev, f32 = prob.R.device, prob.R.dtype
    ii, jj = prob.edge_i, prob.edge_j
    w = prob.edge_weight * prob.edge_valid.to(f32)
    free = (~prob.fixed) & prob.valid
    f = free.to(f32)
    diag = torch.arange(K, device=dev)
    ones = torch.ones(K, dtype=f32, device=dev)
    damp = torch.eye(7, dtype=f32, device=dev) * torch.where(
        free, cfg.essential_graph_lambda_init + 1e-6, 1.0)[:, None, None]
    Sm = (prob.edge_s, prob.edge_R, prob.edge_t)

    s, R, t = prob.s, prob.R, prob.t
    for _ in range(iters):
        Ji, Jj, r = _edge_jacobians(s[ii], R[ii], t[ii], s[jj], R[jj],
                                    t[jj], *Sm)
        H = torch.zeros((K, K, 7, 7), dtype=f32, device=dev)
        H.index_put_((ii, ii), torch.einsum("eri,e,erj->eij", Ji, w, Ji),
                     accumulate=True)
        H.index_put_((jj, jj), torch.einsum("eri,e,erj->eij", Jj, w, Jj),
                     accumulate=True)
        H.index_put_((ii, jj), torch.einsum("eri,e,erj->eij", Ji, w, Jj),
                     accumulate=True)
        H.index_put_((jj, ii), torch.einsum("eri,e,erj->eij", Jj, w, Ji),
                     accumulate=True)
        b = torch.zeros((K, 7), dtype=f32, device=dev)
        b.index_add_(0, ii, -torch.einsum("eri,e,er->ei", Ji, w, r))
        b.index_add_(0, jj, -torch.einsum("eri,e,er->ei", Jj, w, r))
        if reduce_fn is not None:
            H, b = reduce_fn(H, b)

        H = H * f[:, None, None, None] * f[None, :, None, None]
        H[diag, diag] += damp
        b = b * f[:, None]
        if fix_scale:
            H[:, :, 6, :] = 0.0
            H[:, :, :, 6] = 0.0
            H[diag, diag, 6, 6] = ones     # a Python scalar would sync
            b[:, 6] = 0.0
        Hd = H.permute(0, 2, 1, 3).reshape(K * 7, K * 7)
        dxi = torch.linalg.solve_ex(Hd, b.reshape(K * 7))[0].reshape(K, 7)
        norm = torch.linalg.norm(dxi, dim=-1, keepdim=True)
        dxi = dxi * torch.clamp(1.0 / torch.clamp(norm, min=1e-12), max=1.0)
        dxi = dxi * f[:, None]

        S_new = sim3.exp(dxi).compose(Sim3(s, R, t))
        s, R, t = S_new.s, S_new.R, S_new.t
    return prob._replace(s=s, R=R, t=t)

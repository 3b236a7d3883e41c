"""Distributed bundle adjustment and pose graph over a mesh of ranks.

Counterpart of ``coebslam_tpu/parallel/sharded_ba.py``. Every rank calls a
solver with the whole problem. It keeps its contiguous shard of the point
(or edge) axis, by its coordinate along ``axis``, and runs the single-rank
solver of ``optim/`` with a ``reduce_fn`` that sums the partial reduced
camera system (or pose-graph normal system) over the axis's ranks: two
all-reduces per GN iteration, ``S`` (K * K * 36 floats; 49 for the pose
graph) and ``b`` (K * 6; 7), however many points each rank holds. The
dense solve then runs on every rank with the same bits, so every rank ends
with the same poses. Point back-substitution stays local. Each rank
returns the whole result: keyframes as solved, point arrays gathered in
shard order (JAX's ``out_specs``).

With ``gloo`` and CUDA tensors (several ranks sharing one card, where
NCCL refuses) the collectives go through host copies: gloo's all-gather
takes CPU tensors only.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import CameraConfig, OptimizerConfig
from ..optim import local_ba, pose_graph
from ..optim.local_ba import BAProblem, BAResult
from .mesh import POINT_AXIS, Axis, axis_groups

#: All-reduces issued by ``reduce_fn`` in this process, and their bytes
#: (the counters a caller reads to show the solver's communication).
ALL_REDUCES = 0
ALL_REDUCE_BYTES = 0

_BA_POINT_FIELDS = ("pt_pos", "pt_valid", "obs_kf", "obs_uvr", "obs_w",
                    "obs_valid")
_PG_EDGE_FIELDS = ("edge_i", "edge_j", "edge_s", "edge_R", "edge_t",
                   "edge_valid", "edge_weight")


def _through_host(t, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(t, group):
    """The sum of ``t`` over ``group``'s ranks (every rank gets the same
    bits), counted in ``ALL_REDUCES`` / ``ALL_REDUCE_BYTES``."""
    global ALL_REDUCES, ALL_REDUCE_BYTES
    ALL_REDUCES += 1
    ALL_REDUCE_BYTES += t.numel() * t.element_size()
    if _through_host(t, group):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        return h.to(t.device)
    t = t.contiguous()
    dist.all_reduce(t, group=group)
    return t


def all_gather_cat(t, group, size: int):
    """The ranks' ``t`` concatenated along dim 0 in group-rank order (the
    list form of ``all_gather``; bool goes as uint8)."""
    if size == 1:
        return t
    dtype = t.dtype
    x = t.to(torch.uint8) if dtype == torch.bool else t.contiguous()
    if _through_host(x, group):
        x = x.cpu()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts).to(device=t.device, dtype=dtype)


def _reducer(group):
    return lambda S, b: (all_reduce_sum(S, group), all_reduce_sum(b, group))


def _shard(tup, fields, n: int, index: int):
    """``tup`` with the leading axis of ``fields`` cut to shard ``index``
    of ``n`` (equal contiguous shards; the length must divide)."""
    length = getattr(tup, fields[0]).shape[0]
    if length % n != 0:
        raise ValueError(f"axis of length {length} does not divide into "
                         f"{n} shards: pad it")
    step = length // n
    return tup._replace(**{f: getattr(tup, f)[index * step:
                                               (index + 1) * step]
                           for f in fields})


def _gather_result(res: BAResult, group, size: int) -> BAResult:
    return res._replace(**{f: all_gather_cat(getattr(res, f), group, size)
                           for f in ("pt_pos", "obs_valid", "chi2")})


def optimize_sharded(prob: BAProblem, cam: CameraConfig,
                     cfg: OptimizerConfig, mesh,
                     axis: Axis = POINT_AXIS) -> BAResult:
    """The local-BA schedule (``optimize_local_ba``) with the point axis
    sharded over ``axis``; P must divide by the axis's size."""
    group, size, index = axis_groups(mesh, axis)
    shard = _shard(prob, _BA_POINT_FIELDS, size, index)
    res = local_ba.optimize_local_ba(shard, cam, cfg,
                                     reduce_fn=_reducer(group))
    return _gather_result(res, group, size)


def optimize_global_sharded(prob: BAProblem, cam: CameraConfig,
                            cfg: OptimizerConfig, mesh,
                            axis: Axis = POINT_AXIS,
                            n_blocks_per_device: int = 2) -> BAResult:
    """Global BA (``optimize_global_ba``) with the point axis sharded over
    ``axis``: each rank streams its shard through the chunked Schur
    assembly in ``n_blocks_per_device`` blocks, one all-reduce of S and b
    per iteration merges them."""
    group, size, index = axis_groups(mesh, axis)
    shard = _shard(prob, _BA_POINT_FIELDS, size, index)
    res = local_ba.optimize_global_ba(shard, cam, cfg,
                                      n_blocks=n_blocks_per_device,
                                      reduce_fn=_reducer(group))
    return _gather_result(res, group, size)


def optimize_pose_graph_sharded(prob, cfg: OptimizerConfig, mesh,
                                axis: Axis = POINT_AXIS,
                                fix_scale: bool = False):
    """The essential-graph solve with the EDGE axis sharded over ``axis``:
    each rank scatter-adds its edges' 7x7 blocks, one all-reduce of H and b
    per iteration merges them. The edges come back as given (the solve
    does not change them); E must divide by the axis's size."""
    group, size, index = axis_groups(mesh, axis)
    shard = _shard(prob, _PG_EDGE_FIELDS, size, index)
    out = pose_graph.optimize_pose_graph(shard, cfg, fix_scale=fix_scale,
                                         reduce_fn=_reducer(group))
    return prob._replace(s=out.s, R=out.R, t=out.t)


_SOLVERS = {"local": optimize_sharded, "global": optimize_global_sharded,
            "pose_graph": optimize_pose_graph_sharded}


def rank_solve(kind: str, prob, cfg: OptimizerConfig, cam=None,
               hybrid: bool = False, dcn_size=None,
               axis: Axis = POINT_AXIS, options=None) -> dict:
    """A rank's body for ``launch``: one sharded solve of ``kind`` ("local",
    "global" or "pose_graph", with the solver's keyword ``options``) of
    ``prob`` (moved to this rank's device) over a 1-D mesh of every rank
    (``make_mesh()``), or over ``make_hybrid_mesh(dcn_size)`` when
    ``hybrid``. Returns, on the CPU, the result, every rank's solved poses
    stacked (``rank_R`` and ``rank_t``, [n_ranks, ...]: the ranks must
    agree bit for bit), the mesh's shape and dimension names, the backend,
    this rank's all-reduces and their bytes, and the solve's seconds (the
    card drained)."""
    import time
    from . import multihost
    from .launch import rank_device
    from .mesh import make_mesh

    dev = rank_device()
    mesh = (multihost.make_hybrid_mesh(dcn_size) if hybrid
            else make_mesh())
    prob = type(prob)(*[x.to(dev) for x in prob])
    args = (prob, cfg) if kind == "pose_graph" else (prob, cam, cfg)
    n0, b0 = ALL_REDUCES, ALL_REDUCE_BYTES
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = _SOLVERS[kind](*args, mesh, axis=axis, **(options or {}))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    R, t = (res.R, res.t) if kind == "pose_graph" else (res.kf_R, res.kf_t)
    n = dist.get_world_size()
    rank_R, rank_t = [all_gather_cat(x[None], dist.group.WORLD, n).cpu()
                      for x in (R, t)]
    return {"result": type(res)(*[x.cpu() for x in res]),
            "rank_R": rank_R, "rank_t": rank_t, "mesh": tuple(mesh.shape),
            "mesh_dims": tuple(mesh.mesh_dim_names),
            "backend": dist.get_backend(), "all_reduces": ALL_REDUCES - n0,
            "all_reduce_bytes": ALL_REDUCE_BYTES - b0, "seconds": secs}


def run_sharded(kind: str, prob, cfg: OptimizerConfig, n_ranks: int,
                cam=None, device=None, hybrid: bool = False,
                dcn_size=None, axis: Axis = POINT_AXIS,
                **options) -> dict:
    """``rank_solve`` on ``n_ranks`` ranks started from this process, on
    ``device``'s type (default CUDA); ``prob`` goes to the ranks on the
    CPU. Returns rank 0's dict."""
    from .launch import launch
    prob = type(prob)(*[x.cpu() for x in prob])
    return launch(rank_solve, n_ranks, kind, prob, cfg, cam, hybrid,
                  dcn_size, axis, options, device=device)

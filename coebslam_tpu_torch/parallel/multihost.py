"""Multi-node glue: joining the process group, 2-D (dcn, ici) meshes, and
the bridge from a host map arena to a segment-ordered BA problem.

Counterpart of ``coebslam_tpu/parallel/multihost.py``. Communication is
split by fabric as there:

  * ``ici`` (inner, fast): point shards of the Schur assembly, one
    all-reduce of the reduced camera system per GN iteration
    (``sharded_ba``). On GPUs this is NVLink within a node.
  * ``dcn`` (outer, slow): trajectory segments, one node each; only the
    summed normal systems cross it.

With one process every function degrades to the 1-rank case, which is how
a driver can call them unconditionally.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .launch import COLLECTIVE_TIMEOUT_S, rank_device

ICI_AXIS = "ici"     # fast intra-node axis (point shards, all-reduce heavy)
DCN_AXIS = "dcn"     # slow cross-node axis (segments, rare collectives)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the process group; a no-op for a single process.

    The counterpart of ``jax.distributed.initialize``: the arguments, or a
    launcher's environment (``torchrun`` sets ``WORLD_SIZE``, ``RANK`` and
    ``MASTER_ADDR``), say where the group meets; NCCL where CUDA exists,
    else gloo."""
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes in (None, 1) and coordinator_address is None \
            and env_world == 1:
        return
    dist.init_process_group(
        "nccl" if torch.cuda.is_available() else "gloo",
        init_method=coordinator_address or "env://",
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
        timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def hybrid_shape(n_ranks: int, dcn_size: int) -> tuple:
    """(dcn, ici) of ``n_ranks`` ranks asked for ``dcn_size`` segments:
    dcn clipped to [1, n_ranks] and lowered until it divides n_ranks (the
    JAX package's rule for ragged layouts)."""
    n = max(1, min(dcn_size, n_ranks))
    while n_ranks % n != 0:
        n -= 1
    return n, n_ranks // n


def make_hybrid_mesh(dcn_size: Optional[int] = None) -> DeviceMesh:
    """2-D (dcn, ici) mesh over every rank, row-major (rank = dcn * ici_size
    + ici). ``dcn_size`` defaults to the node count: the ranks of one node
    form the ici axis, so the per-iteration all-reduces never cross nodes.
    With one node the dcn axis has size 1 and every solver behaves as on
    the 1-D mesh. The node count is ranks over ranks per node
    (``LOCAL_WORLD_SIZE``, which ``torchrun`` sets; one node without it,
    as under ``launch``). Every rank calls it (it creates process
    groups)."""
    world = dist.get_world_size()
    if dcn_size is None:
        dcn_size = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return DeviceMesh(rank_device().type,
                      torch.arange(world).reshape(hybrid_shape(world,
                                                               dcn_size)),
                      mesh_dim_names=(DCN_AXIS, ICI_AXIS))


def segment_of_keyframe(kf_id: int, n_segments: int,
                        max_keyframes: int) -> int:
    """Trajectory segment of a keyframe: contiguous blocks, so temporally
    local covisibility stays inside a segment."""
    seg = kf_id * n_segments // max(max_keyframes, 1)
    return min(seg, n_segments - 1)


def arena_to_ba_problem(m, cfg, max_obs: int = 16, n_segments: int = 1,
                        pad_points_to: int = 1, device=None):
    """A host ``MapArena`` (e.g. the handoff's, ``slam/handoff.to_arena``)
    as a ``local_ba.BAProblem`` on ``device`` (default CUDA) with its points
    ordered by trajectory segment (the segment of a point is that of its
    first live observer), padded with invalid rows to a multiple of
    ``pad_points_to``; the first keyframe is fixed. A shard of the point
    axis over (dcn, ici) then holds one segment's points per dcn group.

    Returns (problem, kfs, pts, segment_of_point)."""
    from ..optim.local_ba import BAProblem
    from ..utils.device import resolve_device

    device = resolve_device(device, "arena_to_ba_problem")
    kfs = np.asarray(m.valid_keyframes())
    pts = np.asarray(m.valid_points())
    n_k, n_p = len(kfs), len(pts)
    win_of_kf = np.full(m.kf_R.shape[0] + 1, -1, np.int32)
    win_of_kf[kfs] = np.arange(n_k)

    okf = m.pt_obs_kf[pts]                     # [n_p, MAX_OBS]
    live = okf >= 0
    first_kf = okf[np.arange(n_p), np.argmax(live, axis=1)]
    seg_of_kf = np.asarray([segment_of_keyframe(int(w), n_segments, n_k)
                            for w in win_of_kf[kfs]])
    seg_of_pt = seg_of_kf[np.clip(win_of_kf[first_kf], 0, n_k - 1)]
    order = np.argsort(seg_of_pt, kind="stable")
    pts = pts[order]
    seg_of_pt = seg_of_pt[order]

    okf = m.pt_obs_kf[pts]
    oslot = m.pt_obs_slot[pts]
    live = okf >= 0
    sel_order = np.argsort(~live, axis=1, kind="stable")[:, :max_obs]
    sel = np.take_along_axis(live, sel_order, 1)
    gkf = np.take_along_axis(okf, sel_order, 1)
    gslot = np.take_along_axis(oslot, sel_order, 1)
    gkf_c = np.clip(gkf, 0, None)
    gslot_c = np.clip(gslot, 0, None)
    uv = m.kf_uv[gkf_c, gslot_c]               # [n_p, M, 2]
    ur = m.kf_ur[gkf_c, gslot_c]
    lvl = m.kf_level[gkf_c, gslot_c].astype(np.float32)
    sf2 = float(cfg.orb.scale_factor) ** 2
    obs_kf = np.where(sel, win_of_kf[gkf_c], -1).astype(np.int64)

    P = -(-n_p // pad_points_to) * pad_points_to
    pad = P - n_p

    def padp(a, fill=0):
        return np.concatenate(
            [a, np.full((pad,) + a.shape[1:], fill, a.dtype)]) if pad else a

    kf_fixed = np.zeros(n_k, bool)
    kf_fixed[0] = True
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    prob = BAProblem(
        kf_R=up(m.kf_R[kfs]), kf_t=up(m.kf_t[kfs]),
        kf_fixed=up(kf_fixed), kf_valid=up(np.ones(n_k, bool)),
        pt_pos=up(padp(m.pt_pos[pts])),
        pt_valid=up(padp(np.ones(n_p, bool), False)),
        obs_kf=up(padp(obs_kf, -1)),
        obs_uvr=up(padp(np.concatenate([uv, ur[..., None]], axis=-1))),
        obs_w=up(padp((1.0 / sf2 ** lvl).astype(np.float32))),
        obs_valid=up(padp(sel & (obs_kf >= 0), False)))
    return prob, kfs, pts, seg_of_pt

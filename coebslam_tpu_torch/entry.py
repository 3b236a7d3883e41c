"""The driver's entry points: the per-frame forward step, and a dry run of
every multi-device path.

Counterpart of the repository root's ``__graft_entry__.py``.

``entry(device=None)``  -- ``(fn, example_args)``: the fused front-end
    (``frame.process_rgbd``: pyramid, FAST, grid selection, BRIEF, depth)
    and ``tracking.track_step`` (project, match, pose Gauss-Newton) at
    ``SystemConfig()``'s 640x480, on random input made exactly as the JAX
    module makes it.
``dryrun_multichip(n, device=None)`` -- starts ``n`` ranks and runs, with
    the JAX module's asserts and sizes: (a) the sharded local BA, (b) a
    frame-parallel front-end (one frame per rank), (c) the sharded global
    BA, (d) the sharded pose graph, and (e) the hybrid (dcn, ici) mesh on a
    real ~100-keyframe map arena (``multihost.arena_to_ba_problem``): its
    segment-sharded global BA must equal the 1-D mesh's within 2e-3, and a
    pose graph over its keyframes runs with edges sharded on dcn.
"""
from __future__ import annotations

import numpy as np
import torch

from .utils.device import resolve_device


def _tracking_step_fn(cfg):
    """The fused front-end + track step as a function of plain tensors."""
    from .geometry.se3 import SE3
    from .slam import frame as frame_mod
    from .slam.tracking import track_step

    def step(gray, depth, pose_R, pose_t, pts_w, pt_desc_signed, pt_valid,
             pt_angle, pt_normal, pt_min_dist, pt_max_dist):
        fd = frame_mod.process_rgbd(gray, depth, cfg.camera, cfg.orb)
        radius = torch.full((), 15.0, device=gray.device)
        res = track_step(fd, SE3(pose_R, pose_t), pts_w, pt_desc_signed,
                         pt_valid, pt_angle, pt_normal, pt_min_dist,
                         pt_max_dist, radius, cfg)
        return res.pose.R, res.pose.t, res.n_inliers

    return step


def entry(device=None):
    """Returns (fn, example_args) on ``device`` (default CUDA)."""
    from .config import SystemConfig

    dev = resolve_device(device, "entry")
    cfg = SystemConfig()
    h, w = cfg.camera.height, cfg.camera.width
    rng = np.random.RandomState(0)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    gray = up(rng.rand(h, w).astype(np.float32) * 255.0)
    depth = up(1.0 + 3.0 * rng.rand(h, w).astype(np.float32))
    m = 1024
    pts_w = up((rng.randn(m, 3).astype(np.float32)
                + np.asarray([0, 0, 3.0], np.float32)).astype(np.float32))
    # The +-1 descriptors: bfloat16 in the JAX module, float32 in the
    # port's matching product; both hold +-1 exactly.
    signed = up(rng.choice([-1.0, 1.0], size=(m, 256)).astype(np.float32))
    f32 = dict(dtype=torch.float32, device=dev)
    args = (
        gray, depth,
        torch.eye(3, **f32), torch.zeros(3, **f32),
        pts_w, signed,
        torch.ones(m, dtype=torch.bool, device=dev),
        torch.zeros(m, **f32),
        up(np.tile([0.0, 0.0, -1.0], (m, 1)).astype(np.float32)),
        torch.full((m,), 0.5, **f32),
        torch.full((m,), 8.0, **f32),
    )
    return _tracking_step_fn(cfg), args


# --------------------------------------------------------------------- #
# the multi-device dry run
# --------------------------------------------------------------------- #

def _small_configs():
    from .config import CameraConfig, OrbConfig, SystemConfig
    cam = CameraConfig(width=64, height=48, fx=50.0, fy=50.0, cx=32.0,
                       cy=24.0, bf=5.0)
    return cam, SystemConfig(camera=cam,
                             orb=OrbConfig(max_keypoints=128, n_levels=2,
                                           n_features=100))


def _local_problem(cam, n_devices: int, dev):
    """(a)'s problem: K 4, P 16 per rank, M 4, seeded as the JAX one."""
    from .geometry import camera as cam_ops, se3
    from .optim.local_ba import BAProblem

    rng = np.random.RandomState(0)
    K, P, M = 4, 16 * n_devices, 4
    pts = rng.randn(P, 3).astype(np.float32) + np.array([0, 0, 3],
                                                         np.float32)
    xi = 0.05 * rng.randn(K, 6).astype(np.float32)
    poses = se3.exp(torch.from_numpy(xi).to(dev))
    obs_kf = torch.from_numpy(np.tile(np.arange(M) % K, (P, 1))).to(dev)
    pc = se3.transform_points(se3.SE3(poses.R[obs_kf], poses.t[obs_kf]),
                              torch.from_numpy(pts).to(dev)[:, None, :])
    prob = BAProblem(
        kf_R=poses.R, kf_t=poses.t,
        kf_fixed=torch.arange(K, device=dev) == 0,
        kf_valid=torch.ones(K, dtype=torch.bool, device=dev),
        pt_pos=torch.from_numpy(pts).to(dev) + 0.01,
        pt_valid=torch.ones(P, dtype=torch.bool, device=dev),
        obs_kf=obs_kf, obs_uvr=cam_ops.project_stereo(cam, pc),
        obs_w=torch.ones((P, M), device=dev),
        obs_valid=torch.ones((P, M), dtype=torch.bool, device=dev))
    return prob, rng


def _chain_graph(n_devices: int, dev):
    """(d)'s pose graph: 8 nodes, 2 edges per rank along a chain."""
    from .optim import pose_graph as pg
    Kp, E = 8, 2 * n_devices
    ei = np.asarray([(k % (Kp - 1)) + 1 for k in range(E)], np.int64)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return pg.PoseGraphProblem(
        s=torch.ones(Kp, device=dev),
        R=torch.eye(3, device=dev).repeat(Kp, 1, 1),
        t=up(np.outer(np.arange(Kp), [0.45, 0, 0]).astype(np.float32)),
        fixed=torch.arange(Kp, device=dev) == 0,
        valid=torch.ones(Kp, dtype=torch.bool, device=dev),
        edge_i=up(ei), edge_j=up(ei - 1), edge_s=torch.ones(E, device=dev),
        edge_R=torch.eye(3, device=dev).repeat(E, 1, 1),
        edge_t=up(np.tile(np.asarray([0.5, 0, 0], np.float32), (E, 1))),
        edge_valid=torch.ones(E, dtype=torch.bool, device=dev),
        edge_weight=torch.ones(E, device=dev))


#: (e)'s real-map arena: keypoints per keyframe, points spawned per
#: keyframe, keyframes.
ARENA_KP, ARENA_SPAWN, ARENA_KF = 384, 160, 100


def build_arena(cam):
    """(e)'s map: a ~100-keyframe / ~16k-point ``MapArena`` (the shape of
    what a replica session hands off) on a loop, each keyframe observing
    its own new points, its predecessor's and some of the one before (the
    temporally local covisibility that segment sharding assumes); then
    every keyframe but the first and every point perturbed by 1 cm. The
    JAX module's recipe (``RandomState(7)``)."""
    from .config import MapConfig, OrbConfig, SystemConfig
    from .slam.map import MapArena

    N_KP, SP, K_M = ARENA_KP, ARENA_SPAWN, ARENA_KF
    cfg_m = SystemConfig(camera=cam,
                         orb=OrbConfig(max_keypoints=N_KP, n_levels=2,
                                       n_features=300),
                         map=MapConfig(max_keyframes=128, max_points=32768))
    m = MapArena(cfg_m)
    rng = np.random.RandomState(7)

    def pose_of(k):
        a = 2 * np.pi * k / K_M
        c = np.array([0.8 * np.sin(a), 0.1 * np.sin(2 * a),
                      -1.0 + 0.3 * np.cos(a)], np.float32)
        return np.eye(3, dtype=np.float32), -c

    spawn_ids, spawn_pos = [], []
    for k in range(K_M):
        R, t = pose_of(k)
        pc = np.stack([rng.uniform(-1.2, 1.2, SP), rng.uniform(-0.8, 0.8, SP),
                       rng.uniform(2.0, 5.0, SP)], 1).astype(np.float32)
        pw = (pc - t) @ R
        ids = m.add_points(pw, rng.randint(0, 255, (SP, 32)).astype(
            np.uint8), first_kf=-1, angles=np.zeros(SP, np.float32))
        spawn_ids.append(np.asarray(ids))
        spawn_pos.append(pw)
        uv = np.zeros((N_KP, 2), np.float32)
        depth = np.zeros(N_KP, np.float32)
        valid = np.zeros(N_KP, bool)
        point_ids = np.full(N_KP, -1, np.int32)

        def observe(sl, pos_w, ids_obs):
            pc_o = pos_w @ R.T + t
            z = pc_o[:, 2]
            u = cam.fx * pc_o[:, 0] / z + cam.cx
            v = cam.fy * pc_o[:, 1] / z + cam.cy
            ok = (z > 0.1) & (u >= 0) & (u < cam.width) & (v >= 0) \
                & (v < cam.height) & (ids_obs >= 0)
            uv[sl] = np.stack([u, v], 1)
            depth[sl] = z
            valid[sl] = ok
            point_ids[sl] = np.where(ok, ids_obs, -1)

        observe(slice(0, SP), pw, spawn_ids[-1])
        if k >= 1:
            observe(slice(SP, 2 * SP), spawn_pos[-2], spawn_ids[-2])
        if k >= 2:
            rest = N_KP - 2 * SP
            observe(slice(2 * SP, N_KP), spawn_pos[-3][:rest],
                    spawn_ids[-3][:rest])
        ur = np.where(depth > 0, uv[:, 0] - cam.bf / np.maximum(depth, .1),
                      -1.0).astype(np.float32)
        m.add_keyframe(R, t, k / 30.0, uv, np.zeros(N_KP, np.int32),
                       np.zeros(N_KP, np.float32),
                       np.zeros((N_KP, 32), np.uint8), depth, ur, valid,
                       point_ids)

    kfs = m.valid_keyframes()
    for k in kfs[1:]:
        m.kf_t[k] += 0.01 * rng.randn(3).astype(np.float32)
    live = m.valid_points()
    m.pt_pos[live] += 0.01 * rng.randn(len(live), 3).astype(np.float32)
    return m, cfg_m


def loop_graph(m, n_dev: int, dev):
    """(e)'s pose graph over arena ``m``'s keyframes, on ``dev``: the chain
    and one loop edge (last to first), each measured from the current
    poses, padded by repeating chain edges to a multiple of ``n_dev``.
    Returns (problem, nodes, edges)."""
    from .optim import pose_graph as pg
    kfs = m.valid_keyframes()
    K = len(kfs)
    E = -(-K // n_dev) * n_dev
    ei = np.clip(np.arange(E) + 1, 1, K - 1).astype(np.int64)
    ej = ei - 1
    ei[-1], ej[-1] = K - 1, 0
    Rg = np.asarray(m.kf_R[kfs])
    tg = np.asarray(m.kf_t[kfs])
    Rm = np.einsum("eij,ekj->eik", Rg[ei], Rg[ej])
    tm = tg[ei] - np.einsum("eij,ej->ei", Rm, tg[ej])
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return pg.PoseGraphProblem(
        s=torch.ones(K, device=dev), R=up(Rg), t=up(tg),
        fixed=torch.arange(K, device=dev) == 0,
        valid=torch.ones(K, dtype=torch.bool, device=dev),
        edge_i=up(ei), edge_j=up(ej), edge_s=torch.ones(E, device=dev),
        edge_R=up(Rm), edge_t=up(tm),
        edge_valid=torch.ones(E, dtype=torch.bool, device=dev),
        edge_weight=torch.ones(E, device=dev)), K, E


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def dryrun_rank(n_devices: int) -> dict:
    """One rank of ``dryrun_multichip`` (run by ``parallel.launch``)."""
    import time
    import torch.distributed as dist
    from .ops import fast_cuda
    from .parallel import multihost, sharded_ba
    from .parallel.launch import rank_device
    from .parallel.mesh import POINT_AXIS, axis_groups, make_mesh
    from .slam import frame as frame_mod

    dev = rank_device()
    world = dist.get_world_size()
    _check(world >= n_devices, f"need {n_devices} ranks, have {world}")
    mesh = make_mesh(n_devices)
    cam, cfg = _small_configs()
    secs, reduces, reduce_bytes = {}, {}, {}

    def timed(name, fn):
        n0, b0 = sharded_ba.ALL_REDUCES, sharded_ba.ALL_REDUCE_BYTES
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        reduces[name] = sharded_ba.ALL_REDUCES - n0
        reduce_bytes[name] = sharded_ba.ALL_REDUCE_BYTES - b0
        return out

    # (a) the sharded local BA: points sharded, all-reduce per iteration
    prob, rng = _local_problem(cam, n_devices, dev)
    res = timed("a", lambda: sharded_ba.optimize_sharded(
        prob, cam, cfg.optimizer, mesh))
    _check(bool(torch.isfinite(res.kf_t).all()), "(a) kf_t not finite")

    # (b) the frame-parallel front-end: one frame per rank (the JAX module
    # shards a batch of n frames over the mesh)
    gray = rng.rand(n_devices, cam.height, cam.width).astype(np.float32) \
        * 255
    depth = 1.0 + rng.rand(n_devices, cam.height, cam.width).astype(
        np.float32)
    group, size, index = axis_groups(mesh, POINT_AXIS)
    launches0 = fast_cuda.LAUNCHES
    fd = timed("b", lambda: frame_mod.process_rgbd(
        torch.from_numpy(gray[index]).to(dev),
        torch.from_numpy(depth[index]).to(dev), cam, cfg.orb))
    count = fd.feats.valid.sum().reshape(1)
    counts = sharded_ba.all_gather_cat(count, group, size).cpu()
    launches = torch.tensor([fast_cuda.LAUNCHES - launches0],
                            dtype=torch.int64, device=dev)
    launches = int(sharded_ba.all_reduce_sum(launches, group))
    _check(counts.shape == (n_devices,), f"(b) counts {counts.shape}")

    # (c) the sharded global BA of the same problem, 2 blocks per rank
    res_g = timed("c", lambda: sharded_ba.optimize_global_sharded(
        prob, cam, cfg.optimizer, mesh, n_blocks_per_device=2))
    _check(bool(torch.isfinite(res_g.kf_t).all()), "(c) kf_t not finite")

    # (d) the sharded pose graph: edge shards, all-reduced normal system
    res_pg = timed("d", lambda: sharded_ba.optimize_pose_graph_sharded(
        _chain_graph(n_devices, dev), cfg.optimizer, mesh, fix_scale=True))
    _check(bool(torch.isfinite(res_pg.t).all()), "(d) t not finite")

    # (e) the hybrid (dcn, ici) mesh on a real map arena: segment-sharded
    # global BA against the 1-D mesh's, and a dcn-sharded pose graph
    m, cfg_m = build_arena(cam)
    hmesh = multihost.make_hybrid_mesh(dcn_size=2)
    n_dev = hmesh.mesh.numel()
    prob_m, kfs_m, pts_used, seg = multihost.arena_to_ba_problem(
        m, cfg_m, max_obs=8, n_segments=2, pad_points_to=n_dev,
        device=dev)
    res_h = timed("e_hybrid", lambda: sharded_ba.optimize_global_sharded(
        prob_m, cam, cfg_m.optimizer, hmesh,
        axis=(multihost.DCN_AXIS, multihost.ICI_AXIS),
        n_blocks_per_device=2))
    res_flat = timed("e_flat", lambda: sharded_ba.optimize_global_sharded(
        prob_m, cam, cfg_m.optimizer, mesh, n_blocks_per_device=2))
    gap = float((res_h.kf_t - res_flat.kf_t).abs().max())
    _check(gap <= 2e-3, f"(e) segment-sharded GBA differs from the 1-D "
           f"mesh's by {gap}")
    pg2, K_g, E_g = loop_graph(m, n_dev, dev)
    res_pg2 = timed("e_pose_graph",
                    lambda: sharded_ba.optimize_pose_graph_sharded(
                        pg2, cfg_m.optimizer, hmesh,
                        axis=multihost.DCN_AXIS, fix_scale=True))
    _check(bool(torch.isfinite(res_pg2.t).all()),
           "(e) pose graph t not finite")
    return {"n_devices": n_devices, "counts": counts.tolist(),
            "frontend_launches": launches,
            "hybrid_mesh": tuple(hmesh.shape), "n_kf": len(kfs_m),
            "n_points": len(pts_used),
            "segments": [int((seg == s).sum()) for s in range(2)],
            "gba_gap": gap, "pose_graph": (K_g, E_g),
            "backend": dist.get_backend(), "seconds": secs,
            "all_reduces": reduces, "all_reduce_bytes": reduce_bytes}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Start ``n_devices`` ranks on ``device``'s type (default CUDA), run
    ``dryrun_rank`` on each, print the JAX module's summary line and
    return rank 0's dict."""
    from .parallel.launch import launch
    out = launch(dryrun_rank, n_devices, n_devices, device=device)
    print(f"dryrun_multichip({n_devices}): sharded local BA + batched "
          f"frontend + sharded GLOBAL BA + sharded pose graph OK; "
          f"kf_t finite, per-frame counts {out['counts']}; "
          f"HYBRID mesh {out['hybrid_mesh']} (dcn,ici): real-map bridge "
          f"{out['n_kf']} KFs / {out['n_points']} pts, segments "
          f"{out['segments']}, segment-sharded GBA == 1-D GBA (atol 2e-3), "
          f"dcn-sharded pose graph {out['pose_graph'][0]} nodes / "
          f"{out['pose_graph'][1]} edges OK", flush=True)
    return out

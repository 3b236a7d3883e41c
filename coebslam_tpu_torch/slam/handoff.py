"""Handoff of a finished realtime session to a host map arena, and its
offline refinement.

Counterpart of ``coebslam_tpu/slam/handoff.py`` (numpy, copied). After
``RealtimeSlam.finish()`` the session's arenas are rebuilt into a host
``MapArena`` (``to_arena``), global bundle adjustment refines every
keyframe and point (``refine``), and the full trajectory is re-based on
the refined keyframes (``refined_trajectory``).

Reconstruction: per-keypoint pyramid levels come from the stored
information weights (w = 1/sf^(2L)), depth from the virtual-right
coordinate (z = bf / (u - ur); ur == -1 marks no depth), and the
keypoints' descriptors from the session's keyframe descriptor set.
"""
from __future__ import annotations

import numpy as np

from ..config import SystemConfig
from .map import MapArena


def to_arena(res: dict, cfg: SystemConfig, stamps=None):
    """Build a MapArena from a ``RealtimeSlam.finish()`` result.

    Returns (arena, kf_ids) with ``kf_ids[i]`` the arena id of the i-th
    (lid-ordered) realtime keyframe.
    """
    lim = res["limits"]
    S = lim.spawn_per_kf
    P = lim.max_kf * S
    cam, orb = cfg.camera, cfg.orb
    m = MapArena(cfg)

    lids = np.asarray(res["kf_lid"])
    pt_valid = np.asarray(res["pt_valid"])
    pt_pos = np.asarray(res["pt_pos"])
    pt_desc = np.asarray(res["pt_desc"])
    pt_angle = np.asarray(res["pt_angle"])

    # ---- live landmarks: logical pid -> arena id
    phys_of = lambda pid: pid % P
    live_pids = []
    for lid in lids:
        base = int(lid) * S
        ok = pt_valid[(base + np.arange(S)) % P]
        live_pids.extend((base + np.nonzero(ok)[0]).tolist())
    live_pids = np.asarray(live_pids, np.int64)
    arena_of = {}
    if len(live_pids):
        ph = phys_of(live_pids)
        ids = m.add_points(pt_pos[ph], pt_desc[ph], first_kf=-1,
                           angles=pt_angle[ph])
        for lp, aid in zip(live_pids, ids):
            if aid >= 0:
                arena_of[int(lp)] = int(aid)

    # ---- keyframes (lid order == temporal order)
    if stamps is None:
        stamps = np.asarray(res["stamps"])
    dropped = res.get("frames_dropped", 0)
    frames = np.asarray(res["kf_frame"])
    obs = np.asarray(res["kf_obs"])          # [n, N, 3]
    w = np.asarray(res["kf_w"])
    kpv = np.asarray(res["kf_kp_valid"])
    pids = np.asarray(res["kf_pid"])
    ln_sf2 = 2.0 * np.log(orb.scale_factor)
    kf_ids = []
    for i, lid in enumerate(lids):
        u, ur = obs[i, :, 0], obs[i, :, 2]
        disp = u - ur
        has_d = (np.abs(ur + 1.0) > 1e-4) & (disp > 0.1)
        depth = np.where(has_d, cam.bf / np.maximum(disp, 0.1), 0.0)
        level = np.clip(np.round(-np.log(np.maximum(w[i], 1e-9)) / ln_sf2),
                        0, orb.n_levels - 1).astype(np.int32)
        row = pids[i]
        alive = (row >= 0) & np.isin(row // S, lids) \
            & pt_valid[phys_of(np.clip(row, 0, None))]
        point_ids = np.asarray(
            [arena_of.get(int(p), -1) if a else -1
             for p, a in zip(row, alive)], np.int32)
        desc = np.asarray(res["kf_desc"][i], np.uint8).copy()
        angle = np.zeros(len(row), np.float32)
        sel = point_ids >= 0
        if sel.any():
            angle[sel] = pt_angle[phys_of(row[sel])]
        fi = int(frames[i]) - dropped
        if 0 <= fi < len(stamps):
            stamp = float(stamps[fi])
        else:
            # A keyframe older than the surviving trajectory ring: extrapolate
            # in the timebase of the surviving stamps.
            stamp = float(stamps[0]) + fi / cam.fps
        k = m.add_keyframe(
            np.asarray(res["kf_R"][i]), np.asarray(res["kf_t"][i]), stamp,
            obs[i, :, :2], level, angle, desc, depth,
            np.where(has_d, ur, -1.0), kpv[i], point_ids)
        kf_ids.append(k)
    if arena_of:
        m.update_point_stats(np.fromiter(arena_of.values(), np.int64))
    return m, kf_ids


def refine(res: dict, cfg: SystemConfig, stamps=None, device=None):
    """Handoff + global bundle adjustment on ``device`` (default CUDA).
    Returns (arena, kf_ids, n_optimized)."""
    from .global_ba import GlobalBA
    m, kf_ids = to_arena(res, cfg, stamps=stamps)
    n = GlobalBA(cfg, device=device).run(m)
    return m, kf_ids, n


def refined_trajectory(res: dict, arena, kf_ids):
    """Re-base the full realtime trajectory on the refined keyframe poses:
    each frame keeps its pose relative to the latest keyframe at or before
    it (the reference's trajectory writer).

    Returns [F, 3, 4] corrected (R|t) world-to-camera poses aligned with
    ``res["stamps"]``.
    """
    R_f = np.asarray(res["R"])
    t_f = np.asarray(res["t"])
    n = len(R_f)
    dropped = res.get("frames_dropped", 0)
    kf_frames = np.asarray(res["kf_frame"]) - dropped   # trajectory index
    out = np.zeros((n, 3, 4), np.float32)
    j = np.searchsorted(kf_frames, np.arange(n), side="right") - 1
    j = np.clip(j, 0, len(kf_ids) - 1)
    # The old anchor is the keyframe's own trajectory row, not its final
    # pose: the windowed BA keeps refining recent keyframes after their
    # frames were written, so a frame's pose agrees with its keyframe's
    # pose as of that time, which the trajectory row holds. Anchoring on
    # the final pose bakes the later refinements into the relative pose
    # (on the JAX package's 240-frame replica: 2.96 cm against 0.90 cm
    # with track-time anchors, 2.14 cm unrefined).
    kf_tr = np.clip(kf_frames, 0, n - 1)
    kf_R_old = R_f[kf_tr]
    kf_t_old = t_f[kf_tr]
    kf_R_new = arena.kf_R[np.asarray(kf_ids)]
    kf_t_new = arena.kf_t[np.asarray(kf_ids)]
    for i in range(n):
        k = j[i]
        # T_rel = T_f o (T_k^old)^-1 ;  T_f' = T_rel o T_k^new
        Rr = R_f[i] @ kf_R_old[k].T
        tr = t_f[i] - Rr @ kf_t_old[k]
        out[i, :, :3] = Rr @ kf_R_new[k]
        out[i, :, 3] = Rr @ kf_t_new[k] + tr
    return out

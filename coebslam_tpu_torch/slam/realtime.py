"""Realtime RGB-D, stereo and monocular SLAM: the per-frame pipeline on
the card.

Counterpart of ``coebslam_tpu/slam/realtime.py``: ``rt_step`` runs, per
frame, ORB extraction (FAST through the CUDA kernel; a stereo frame
extracts left and right and makes depth from row-band disparity), the COEB
dynamic front-end, the monocular two-view initialisation while no map
exists, four-stage tracking, the keyframe policy, keyframe creation with
point spawning (from depth, or by epipolar matching and triangulation
against the previous keyframe for mono) and the windowed Schur BA, the
adaptive feature budget and the trajectory ring write. All state lives in
device tensors (``RTState``); ``finish()`` is the session's readback.

The reference is one jitted program with ``lax.cond`` around keyframe
creation. Eager PyTorch branches on the host, so ``rt_step`` reads one
device bool per frame (``need_kf``): one host synchronisation per frame.
Keyframe and point arenas are rings addressed by logical ids exactly as in
the reference (logical keyframe ``lid`` lives at row ``lid % max_kf``,
logical point ``lid * S + slot`` at ``pid % (max_kf * S)``); the
loop-closure reuse window and the bank re-seed window are laid out as there
and are opened by the maintenance program (``slam/maintenance.py``), which
``RealtimeSlam`` dispatches every few frames when given a vocabulary.
Updates are out of place, like the reference's. The monocular
initialisation's two nested ``lax.cond``s are host branches too: before the
map exists, a frame reads whether a reference frame is held and, after an
attempt, whether it succeeded; once initialised, mono reads no more than
RGB-D does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..geometry import so3
from ..geometry.se3 import SE3
from ..ops import brief, initializer_ops, matching, triangulation
from ..optim import local_ba
from ..utils.device import resolve_device
from . import dynamic as dynamic_mod
from . import frame as frame_mod
from .tracking import (DevTrackState, _V_INL, _V_OK, _V_TRACKED_CLOSE,
                       _V_UNTRACKED_CLOSE, fused_step)


class RTLimits(NamedTuple):
    """Static capacities of one realtime session."""
    max_kf: int = 64          # keyframe ring rows
    spawn_per_kf: int = 256   # point-chunk size S; logical pid = lid*S + slot
    ba_window: int = 12       # keyframes jointly adjusted per insertion
    local_window: int = 12    # keyframe chunks visible to tracking
    max_frames: int = 4096    # trajectory ring capacity
    reuse_chunks: int = 2     # extra chunks re-exposed after a loop closure
    bank_cap: int = 1024
    bank_words: int = 64
    bank_landmarks: int = 128
    seed_slots: int = 256     # arena rows reserved for bank re-seeding


class RTState(NamedTuple):
    """Everything the pipeline needs, resident on the device. Field order
    and meaning follow the reference's RTState."""
    track: DevTrackState
    dyn: dynamic_mod.DynState
    kf_R: torch.Tensor              # [K, 3, 3]
    kf_t: torch.Tensor              # [K, 3]
    kf_lid: torch.Tensor            # [K] logical tenant id (-1 empty)
    kf_obs: torch.Tensor            # [K, N, 3]
    kf_desc: torch.Tensor           # [K, N, 32] uint8
    kf_w: torch.Tensor              # [K, N]
    kf_kp_valid: torch.Tensor       # [K, N] bool
    kf_pid: torch.Tensor            # [K, N] logical point id (-1)
    kf_frame: torch.Tensor          # [K]
    n_kf: torch.Tensor              # logical keyframe count
    pt_pos: torch.Tensor            # [K*S + seed, 3]
    pt_desc: torch.Tensor           # [K*S + seed, 32] uint8
    pt_valid: torch.Tensor          # [K*S + seed] bool
    pt_angle: torch.Tensor
    pt_normal: torch.Tensor         # [K*S + seed, 3]
    pt_mind: torch.Tensor
    pt_maxd: torch.Tensor
    traj: torch.Tensor              # [F, 14] (ok, R.flat, t, owner_lid)
    frame_idx: torch.Tensor
    frames_since_kf: torch.Tensor
    peak_inliers: torch.Tensor
    budget: torch.Tensor
    consec_ok: torch.Tensor
    strong_frames: torch.Tensor
    n_lost: torch.Tensor
    fr_desc: torch.Tensor           # [N, 32] newest frame stash
    fr_uv: torch.Tensor
    fr_depth: torch.Tensor
    fr_valid: torch.Tensor
    mr_desc: torch.Tensor           # mono-init stash (unused by RGB-D)
    mr_uv: torch.Tensor
    mr_angle: torch.Tensor
    mr_w: torch.Tensor
    mr_valid: torch.Tensor
    mr_ok: torch.Tensor
    reuse_lid: torch.Tensor
    reuse_ttl: torch.Tensor
    seed_ttl: torch.Tensor
    n_ba_culled: torch.Tensor
    n_assoc: torch.Tensor


def init_state(cfg: SystemConfig, lim: RTLimits, device) -> RTState:
    N = cfg.orb.max_keypoints
    K, S, F = lim.max_kf, lim.spawn_per_kf, lim.max_frames
    P = K * S + lim.seed_slots
    f32, i64, u8, b = torch.float32, torch.int64, torch.uint8, torch.bool
    dev = torch.device(device)

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=dev)

    def scalar(v, dt=i64):
        return torch.tensor(v, dtype=dt, device=dev)

    eye = torch.eye(3, dtype=f32, device=dev)
    track = DevTrackState(
        R=eye.clone(), t=full((3,), 0.0, f32), vR=eye.clone(),
        vt=full((3,), 0.0, f32), has_vel=scalar(False, b),
        ok=scalar(False, b), pids=full((N,), -1, i64))
    return RTState(
        track=track, dyn=dynamic_mod.init_dyn_state(cfg, dev),
        kf_R=eye.expand(K, 3, 3).clone(), kf_t=full((K, 3), 0.0, f32),
        kf_lid=full((K,), -1, i64), kf_obs=full((K, N, 3), 0.0, f32),
        kf_desc=full((K, N, 32), 0, u8), kf_w=full((K, N), 1.0, f32),
        kf_kp_valid=full((K, N), False, b), kf_pid=full((K, N), -1, i64),
        kf_frame=full((K,), -1, i64), n_kf=scalar(0),
        pt_pos=full((P, 3), 0.0, f32), pt_desc=full((P, 32), 0, u8),
        pt_valid=full((P,), False, b), pt_angle=full((P,), 0.0, f32),
        pt_normal=full((P, 3), 0.0, f32), pt_mind=full((P,), 1e-2, f32),
        pt_maxd=full((P,), 1e3, f32),
        traj=full((F, 14), 0.0, f32), frame_idx=scalar(0),
        frames_since_kf=scalar(0), peak_inliers=scalar(0),
        budget=scalar(cfg.orb.n_features), consec_ok=scalar(0),
        strong_frames=scalar(0), n_lost=scalar(0),
        fr_desc=full((N, 32), 0, u8), fr_uv=full((N, 2), 0.0, f32),
        fr_depth=full((N,), 0.0, f32), fr_valid=full((N,), False, b),
        mr_desc=full((N, 32), 0, u8), mr_uv=full((N, 2), 0.0, f32),
        mr_angle=full((N,), 0.0, f32), mr_w=full((N,), 1.0, f32),
        mr_valid=full((N,), False, b), mr_ok=scalar(False, b),
        reuse_lid=scalar(-1), reuse_ttl=scalar(0), seed_ttl=scalar(0),
        n_ba_culled=scalar(0), n_assoc=scalar(0))


def _to_tensor(x, device):
    a = np.array(x)                       # a writable, contiguous copy
    t = torch.from_numpy(a)
    if a.dtype in (np.int32, np.uint32, np.int64):
        t = t.to(torch.int64)
    return t.to(device)


def state_from_numpy(d, device) -> RTState:
    """Turn the JAX package's RTState (leaves as numpy, e.g.
    ``jax.tree.map(np.asarray, st)``) into this package's RTState."""
    conv = lambda x: _to_tensor(x, device)
    return RTState(
        track=DevTrackState(*[conv(x) for x in d.track]),
        dyn=dynamic_mod.DynState(*[conv(x) for x in d.dyn]),
        **{k: conv(getattr(d, k)) for k in RTState._fields[2:]})


# --------------------------------------------------------------------- #
# logical <-> physical id arithmetic
# --------------------------------------------------------------------- #

#: Logical-pid base of the seed range (bank re-seed staging rows).
SEED_BASE = 1 << 28


def pid_phys(pids, lim: RTLimits):
    """Physical arena row of a logical point id (callers mask validity)."""
    PT = lim.max_kf * lim.spawn_per_kf
    seed_row = PT + torch.clamp(pids - SEED_BASE, 0, lim.seed_slots - 1)
    return torch.where(pids >= SEED_BASE, seed_row,
                       torch.clamp(pids, min=0) % PT)


def pid_alive(pids, kf_lid, lim: RTLimits, seed_ok=False):
    """A logical pid is alive while its owner chunk's ring row still holds
    the owning keyframe; seed-range pids are alive iff ``seed_ok``."""
    owner = torch.clamp(pids, min=0) // lim.spawn_per_kf
    ring = (pids >= 0) & (kf_lid[owner % lim.max_kf] == owner)
    seed = seed_ok if isinstance(seed_ok, torch.Tensor) else torch.full(
        (), seed_ok, dtype=torch.bool, device=pids.device)
    return torch.where(pids >= SEED_BASE, seed, ring)


def _rotate(a, k):
    """Circular left-rotation of ``a`` along dim 0 by a device offset k."""
    n = a.shape[0]
    return a[(torch.arange(n, device=a.device) + k) % n]


def _unrotate_update(a, chunk, k):
    """Write ``chunk`` at circular offset ``k`` of ``a`` (wrap-safe)."""
    n = a.shape[0]
    rows = (torch.arange(chunk.shape[0], device=a.device) + k) % n
    return a.index_copy(0, rows, chunk.to(a.dtype))


def _unproject_world(cam, uv, depth, R_cw, t_cw):
    z = depth
    x = (uv[:, 0] - cam.cx) / cam.fx * z
    y = (uv[:, 1] - cam.cy) / cam.fy * z
    pc = torch.stack([x, y, z], dim=-1)
    return (pc - t_cw) @ R_cw        # R_cw^T (pc - t) rowwise


def _set_rows(arr, start, chunk):
    """``arr[start : start + len(chunk)] = chunk`` out of place, with a
    device-side start (in bounds by construction)."""
    rows = start + torch.arange(chunk.shape[0], device=arr.device)
    return arr.index_copy(0, rows, chunk.to(arr.dtype))


# --------------------------------------------------------------------- #
# monocular two-view initialisation
# --------------------------------------------------------------------- #


class InitAttempt(NamedTuple):
    """One two-view initialisation attempt, left on the device."""
    ok: torch.Tensor               # keyframes 0 and 1 were built
    used_homography: torch.Tensor
    n_good: torch.Tensor           # correspondences triangulated
    n_points: torch.Tensor         # landmarks made of them (at most S)


def nanmedian(z):
    """Median of the non-NaN values of ``z``, interpolated as
    ``jnp.nanmedian`` does (the mean of the middle two for an even count;
    ``torch.nanmedian`` returns the lower one); NaN when all are NaN."""
    zs = torch.sort(z).values                       # NaNs sort last
    cnt = (~torch.isnan(z)).sum().to(z.dtype)
    q = 0.5 * (cnt - 1.0)
    lo, hi = torch.floor(q), torch.ceil(q)
    w_hi = q - lo
    w_lo = 1.0 - w_hi
    top = torch.clamp(cnt - 1.0, min=0.0)
    lo = torch.minimum(torch.clamp(lo, min=0.0), top).to(torch.int64)
    hi = torch.minimum(torch.clamp(hi, min=0.0), top).to(torch.int64)
    pick = initializer_ops.pick
    return pick(zs, lo) * w_lo + pick(zs, hi) * w_hi


def _mono_init(st: RTState, fd, cfg: SystemConfig, lim: RTLimits, *,
               generator=None, init_idx=None):
    """Monocular initialisation (Tracking::MonocularInitialization with the
    two-view initializer): hold a reference frame; once one is held, match
    the current frame against it in a wide window and run
    ``initializer_ops.reconstruct_graph``. On success build keyframes 0
    (the reference, at identity) and 1 (the current frame, at the recovered
    pose) with the triangulated points as chunk 0, scaled so that the
    median scene depth is 1. A failed attempt holds the current frame as
    the new reference.

    ``init_idx`` = (idx_h [H, 4], idx_f [H, 8]) gives the RANSAC samples
    (else they come from ``generator``). Returns (state, InitAttempt or
    None, whether keyframes 0 and 1 were built). Reads ``mr_ok`` and,
    after an attempt, its success to the host.
    """
    cam = cfg.camera
    S = lim.spawn_per_kf
    feats = fd.feats
    dev = feats.uv.device
    f32 = torch.float32
    N = st.mr_valid.shape[0]

    def stash(s):
        return s._replace(mr_desc=feats.desc, mr_uv=feats.uv,
                          mr_angle=feats.angle, mr_w=fd.inv_sigma2,
                          mr_valid=feats.valid,
                          mr_ok=feats.valid.sum() > 100)

    if not bool(st.mr_ok):                 # host read (before the map only)
        return stash(st), None, False
    s = st
    sd_r = brief.to_signed(brief.unpack_bits(s.mr_desc))
    d = matching.hamming_matrix(sd_r, feats.signed_desc())
    d = d + matching.window_penalty(s.mr_uv, feats.uv,
                                    cfg.matcher.radius_init)
    res = matching.match(d, max_distance=cfg.matcher.th_low,
                         ratio=cfg.matcher.nn_ratio_init, mutual=True,
                         row_valid=s.mr_valid, col_valid=feats.valid)
    n_m = res.valid.sum()
    uv2 = feats.uv[torch.clamp(res.idx, min=0)]
    idx_h, idx_f = init_idx if init_idx is not None else (None, None)
    rec = initializer_ops.reconstruct_graph(
        s.mr_uv, uv2, res.valid, cam, idx_h, idx_f, generator=generator,
        n_hypotheses=cfg.ransac.init_iterations, sigma=cfg.ransac.init_sigma)
    good = rec.good & res.valid
    ok = rec.ok & (n_m >= 100) & torch.isfinite(rec.R).all() \
        & torch.isfinite(rec.t).all()
    rank = torch.cumsum(good.to(torch.int64), 0) - 1
    take = good & (rank < S)
    attempt = InitAttempt(ok, rec.used_homography, good.sum(), take.sum())
    if not bool(ok):                       # host read (before the map only)
        return stash(s), attempt, False

    z = torch.where(good, rec.points[:, 2],
                    torch.full_like(rec.points[:, 2], float("nan")))
    med = nanmedian(z)
    med = torch.where(torch.isfinite(med) & (med > 1e-6), med,
                      torch.ones_like(med))
    X = rec.points / med
    t2 = rec.t / med
    R2 = so3.orthonormalize(rec.R)

    # ---- chunk 0: the triangulated landmarks, in reference-keypoint order
    oh = (rank[None, :] == torch.arange(S, device=dev)[:, None]) \
        & take[None, :]
    src = torch.argmax(oh.to(torch.uint8), dim=1)
    vc = oh.any(dim=1)
    zf = torch.zeros((), device=dev)
    pos_c = torch.where(vc[:, None], X[src], zf)
    desc_c = torch.where(vc[:, None], s.mr_desc[src],
                         torch.zeros((), dtype=torch.uint8, device=dev))
    ang_c = torch.where(vc, s.mr_angle[src], zf)
    sf = torch.full((), cfg.orb.scale_factor, dtype=f32, device=dev)
    lvl_c = torch.where(
        vc, -torch.log(torch.clamp(s.mr_w[src], min=1e-9))
        / (2.0 * torch.log(sf)), zf)
    dist = torch.clamp(torch.linalg.norm(pos_c, dim=-1), min=1e-6)
    normal_c = pos_c / dist[:, None]
    maxd = torch.where(vc, dist * torch.pow(sf, lvl_c), zf)
    mind = torch.where(vc, maxd / cfg.orb.scale_factor
                       ** (cfg.orb.n_levels - 1), torch.full_like(maxd, 1e3))

    def chunk0(arr, chunk):
        return torch.cat([chunk.to(arr.dtype), arr[S:]])

    pid_ref = torch.where(take, rank, torch.full_like(rank, -1))   # lid 0
    # Current keypoint j <- the reference keypoint n with res.idx[n] = j.
    ohj = (res.idx[None, :] == torch.arange(N, device=dev)[:, None]) \
        & (take & (res.idx >= 0))[None, :]
    n_of = torch.argmax(ohj.to(torch.uint8), dim=1)
    pid_cur = torch.where(ohj.any(dim=1), pid_ref[n_of],
                          torch.full_like(pid_ref, -1))

    # ---- keyframe rows 0 (the reference at identity) and 1 (current)
    rows = torch.arange(2, device=dev)

    def two(arr, a, b):
        return arr.index_copy(0, rows, torch.stack([a, b]).to(arr.dtype))

    eye = torch.eye(3, dtype=f32, device=dev)
    obs0 = torch.cat([s.mr_uv, torch.full((N, 1), -1.0, device=dev)], dim=1)
    fi = s.frame_idx
    return s._replace(
        pt_pos=chunk0(s.pt_pos, pos_c), pt_desc=chunk0(s.pt_desc, desc_c),
        pt_valid=chunk0(s.pt_valid, vc), pt_angle=chunk0(s.pt_angle, ang_c),
        pt_normal=chunk0(s.pt_normal, normal_c),
        pt_mind=chunk0(s.pt_mind, mind), pt_maxd=chunk0(s.pt_maxd, maxd),
        kf_R=two(s.kf_R, eye, R2), kf_t=two(s.kf_t, torch.zeros_like(t2), t2),
        kf_lid=two(s.kf_lid, rows[0], rows[1]),
        kf_obs=two(s.kf_obs, obs0, fd.obs),
        kf_desc=two(s.kf_desc, s.mr_desc, feats.desc),
        kf_w=two(s.kf_w, s.mr_w, fd.inv_sigma2),
        kf_kp_valid=two(s.kf_kp_valid, s.mr_valid, feats.valid),
        kf_pid=two(s.kf_pid, pid_ref, pid_cur),
        kf_frame=two(s.kf_frame, torch.clamp(fi - 1, min=0), fi),
        n_kf=torch.full_like(s.n_kf, 2),
        frames_since_kf=torch.zeros_like(s.frames_since_kf),
        peak_inliers=(pid_cur >= 0).sum(),
        track=s.track._replace(
            R=R2, t=t2, vR=eye, vt=torch.zeros_like(t2),
            has_vel=torch.zeros_like(s.track.has_vel),
            ok=torch.ones_like(s.track.ok), pids=pid_cur),
        mr_ok=torch.zeros_like(s.mr_ok)), attempt, True


# --------------------------------------------------------------------- #
# keyframe creation + windowed BA
# --------------------------------------------------------------------- #


def _create_keyframe(st: RTState, fd, spawn_ok, pose: SE3, local_ids,
                     local_alive, cfg: SystemConfig, lim: RTLimits) -> RTState:
    """Insert the current frame as keyframe ``lid = n_kf`` (ring row
    ``lid % K``): associate unmatched keypoints to live window landmarks
    (Fuse's track-extension case), spawn unassociated keypoints into the
    keyframe's point chunk (close-depth ones for RGB-D and stereo, ones
    triangulated against the previous keyframe for mono), write the ring
    row, then run the windowed BA."""
    cam = cfg.camera
    K, S = lim.max_kf, lim.spawn_per_kf
    feats = fd.feats
    dev = feats.uv.device
    k_log = st.n_kf
    k_phys = k_log % K

    # ---- fuse-by-association
    lw_phys = pid_phys(local_ids, lim)
    pt_live = local_alive & st.pt_valid[lw_phys]
    pos_w = st.pt_pos[lw_phys]
    pc = pos_w @ pose.R.T + pose.t
    z = torch.clamp(pc[:, 2], min=1e-6)
    pu = cam.fx * pc[:, 0] / z + cam.cx
    pv = cam.fy * pc[:, 1] / z + cam.cy
    vis = pt_live & (pc[:, 2] > 0.05) & (pu >= 0) & (pu < cam.width) \
        & (pv >= 0) & (pv < cam.height)
    sd_kp = feats.signed_desc()
    sd_pt = brief.to_signed(brief.unpack_bits(st.pt_desc[lw_phys]))
    ham = matching.hamming_matrix(sd_kp, sd_pt)                   # [N, L]
    near = (torch.abs(pu[None, :] - feats.uv[:, :1]) <= 2.5) \
        & (torch.abs(pv[None, :] - feats.uv[:, 1:2]) <= 2.5) & vis[None, :]
    ham = torch.where(near, ham, torch.full_like(ham, 1e9))
    jbest = torch.argmin(ham, dim=1)
    dbest = torch.amin(ham, dim=1)
    ibest = torch.argmin(ham, dim=0)
    mutual = ibest[jbest] == torch.arange(ham.shape[0], device=dev)
    assoc = (st.track.pids < 0) & feats.valid & mutual \
        & (dbest <= cfg.matcher.th_low)
    pids0 = torch.where(assoc, local_ids[jbest], st.track.pids)

    # ---- spawn. RGB-D/stereo: close-depth unmatched keypoints unproject
    # directly. Monocular: epipolar match + DLT triangulation against the
    # previous keyframe (CreateNewMapPoints).
    kf_pid_base = st.kf_pid
    if cfg.sensor == "monocular":
        prev_row = ((k_log - 1) % K).reshape(1)
        prev = lambda arr: arr.index_select(0, prev_row)[0]
        T_prev = SE3(prev(st.kf_R), prev(st.kf_t))
        prev_pid = prev(st.kf_pid)
        prev_free = prev(st.kf_kp_valid) & (prev_pid < 0)
        ln_sf = torch.log(torch.full((), cfg.orb.scale_factor, device=dev))
        prev_lvl = -torch.log(torch.clamp(prev(st.kf_w), min=1e-9)) \
            / (2.0 * ln_sf)
        sd_prev = brief.to_signed(brief.unpack_bits(prev(st.kf_desc)))
        prev_obs = prev(st.kf_obs)
        tri = triangulation.triangulate_pair(
            feats.uv, sd_kp, feats.valid & (pids0 < 0) & spawn_ok,
            feats.level, prev_obs[:, :2], sd_prev, prev_free, prev_lvl,
            prev_obs[:, 2], pose, T_prev, cam, cfg.orb, cfg.matcher)
        spawn = tri.good & torch.isfinite(tri.points).all(dim=-1)
        pts_w = tri.points
    else:
        spawn = (feats.valid & (pids0 < 0) & (fd.depth > 0)
                 & (fd.depth < cam.depth_threshold) & spawn_ok)
        pts_w = _unproject_world(cam, feats.uv, fd.depth, pose.R, pose.t)
    rank = torch.cumsum(spawn.to(torch.int64), 0) - 1
    take = spawn & (rank < S)
    # Exact N->S compaction: slot s's source is the keypoint of rank s.
    oh = (rank[None, :] == torch.arange(S, device=dev)[:, None]) & take[None, :]
    src = torch.argmax(oh.to(torch.uint8), dim=1)
    valid_c = oh.any(dim=1)

    if cfg.sensor == "monocular":
        # The second observation: the previous keyframe's matched keypoint
        # gets the new landmark's id, so the windowed BA constrains it from
        # both views at once.
        n_kp = feats.uv.shape[0]
        ohm = (tri.idx2[None, :] == torch.arange(n_kp, device=dev)[:, None]) \
            & take[None, :]
        n_of_m = torch.argmax(ohm.to(torch.uint8), dim=1)
        prev_pids = torch.where(ohm.any(dim=1), k_log * S + rank[n_of_m],
                                prev_pid)
        kf_pid_base = st.kf_pid.index_copy(0, prev_row, prev_pids[None])
    zf = torch.zeros((), device=dev)
    pos_c = torch.where(valid_c[:, None], pts_w[src], zf)
    desc_c = torch.where(valid_c[:, None], feats.desc[src],
                         torch.zeros((), dtype=torch.uint8, device=dev))
    angle_c = torch.where(valid_c, feats.angle[src], zf)
    level_c = torch.where(valid_c, feats.level[src].to(torch.float32), zf)

    # Normal + scale-invariance band (single-view initialization).
    center = -torch.einsum("ji,j->i", pose.R, pose.t)
    vec = pos_c - center
    dist = torch.clamp(torch.linalg.norm(vec, dim=-1), min=1e-6)
    normal_c = vec / dist[:, None]
    sf = torch.full((), cfg.orb.scale_factor, dtype=torch.float32, device=dev)
    maxd = dist * torch.pow(sf, level_c)
    mind = maxd / cfg.orb.scale_factor ** (cfg.orb.n_levels - 1)
    maxd = torch.where(valid_c, maxd, zf)
    mind = torch.where(valid_c, mind, torch.full_like(mind, 1e3))

    base = k_phys * S
    pid_frame = torch.where(take, k_log * S + rank, pids0)

    def row(arr, v):
        return arr.index_copy(0, k_phys.reshape(1), v[None].to(arr.dtype))

    st = st._replace(
        kf_R=row(st.kf_R, pose.R), kf_t=row(st.kf_t, pose.t),
        kf_lid=row(st.kf_lid, k_log), kf_obs=row(st.kf_obs, fd.obs),
        kf_desc=row(st.kf_desc, feats.desc),
        kf_w=row(st.kf_w, fd.inv_sigma2),
        kf_kp_valid=row(st.kf_kp_valid, feats.valid),
        kf_pid=row(kf_pid_base, pid_frame),
        kf_frame=row(st.kf_frame, st.frame_idx), n_kf=k_log + 1,
        pt_pos=_set_rows(st.pt_pos, base, pos_c),
        pt_desc=_set_rows(st.pt_desc, base, desc_c),
        pt_valid=_set_rows(st.pt_valid, base, valid_c),
        pt_angle=_set_rows(st.pt_angle, base, angle_c),
        pt_normal=_set_rows(st.pt_normal, base, normal_c),
        pt_mind=_set_rows(st.pt_mind, base, mind),
        pt_maxd=_set_rows(st.pt_maxd, base, maxd),
        track=st.track._replace(pids=pid_frame),
        frames_since_kf=torch.zeros_like(st.frames_since_kf),
        peak_inliers=torch.zeros_like(st.peak_inliers),
        n_assoc=st.n_assoc + assoc.sum())
    return _windowed_ba(st, cfg, lim)


def _windowed_ba(st: RTState, cfg: SystemConfig, lim: RTLimits) -> RTState:
    """Local BA over the last ``ba_window`` keyframes and their point
    chunks; window points whose every observation fails the chi^2 gate are
    culled."""
    W, S, K = lim.ba_window, lim.spawn_per_kf, lim.max_kf
    P = W * S
    PT = K * S
    dev = st.kf_R.device
    k_new = st.n_kf - 1
    start_kf = torch.clamp(k_new - W + 1, min=0)
    base_log = start_kf * S
    base_phys = (start_kf % K) * S

    wks = start_kf + torch.arange(W, device=dev)
    wvalid = wks <= k_new
    wks_c = torch.minimum(wks, k_new)
    rows_c = wks_c % K

    kf_R_w = st.kf_R[rows_c]
    kf_t_w = st.kf_t[rows_c]
    # Anchor: the oldest window KF is fixed (plus KF 0 always — gauge).
    # Monocular fixes two: with one fixed camera the map scale is a free
    # direction and the Schur solve goes singular.
    n_anchor = 2 if cfg.sensor == "monocular" else 1
    kf_fixed = (torch.arange(W, device=dev) < n_anchor) | ~wvalid \
        | (wks_c <= n_anchor - 1)

    win_phys = (base_phys + torch.arange(P, device=dev)) % PT
    pt_pos_w = st.pt_pos[win_phys]
    pt_valid_w = st.pt_valid[win_phys]

    pid_rows = st.kf_pid[rows_c]                          # [W, N]
    kpv_rows = st.kf_kp_valid[rows_c] & wvalid[:, None]
    obs_rows = st.kf_obs[rows_c]                          # [W, N, 3]
    w_rows = st.kf_w[rows_c]
    win_ids = base_log + torch.arange(P, device=dev)

    # For each (window slot w, window point p): the first keypoint of KF w
    # observing p.
    hit = (pid_rows[:, :, None] == win_ids[None, None, :]) \
        & kpv_rows[:, :, None]                            # [W, N, P]
    kp = torch.argmax(hit.to(torch.uint8), dim=1)         # [W, P]
    seen = hit.any(dim=1)
    obs_g = torch.gather(obs_rows, 1, kp[..., None].expand(W, P, 3))
    w_g = torch.gather(w_rows, 1, kp)
    zf = torch.zeros((), device=dev)
    u = torch.where(seen, obs_g[..., 0], zf)
    v = torch.where(seen, obs_g[..., 1], zf)
    ur = torch.where(seen, obs_g[..., 2], torch.full_like(zf, -1.0))
    ow = torch.where(seen, w_g, torch.ones_like(w_g))
    obs_uvr = torch.stack([u, v, ur], dim=-1).transpose(0, 1)   # [P, W, 3]
    obs_w = ow.T
    obs_valid = seen.T & pt_valid_w[:, None]
    obs_kf = torch.where(obs_valid, torch.arange(W, device=dev)[None, :],
                         torch.full_like(obs_valid, -1, dtype=torch.int64))

    prob = local_ba.BAProblem(
        kf_R=kf_R_w, kf_t=kf_t_w, kf_fixed=kf_fixed, kf_valid=wvalid,
        pt_pos=pt_pos_w, pt_valid=pt_valid_w & obs_valid.any(dim=1),
        obs_kf=obs_kf, obs_uvr=obs_uvr, obs_w=obs_w, obs_valid=obs_valid)
    res = local_ba.optimize_local_ba(prob, cfg.camera, cfg.optimizer)

    # Writeback; a degenerate solve must not write NaN into the arenas.
    finite = torch.isfinite(res.kf_R).flatten(1).all(1) \
        & torch.isfinite(res.kf_t).all(1)
    keep = kf_fixed | ~finite
    Rw = torch.where(keep[:, None, None], kf_R_w, res.kf_R)
    tw = torch.where(keep[:, None], kf_t_w, res.kf_t)
    # Rows repeat while the window is not yet full (wks clamped to k_new).
    # The reference writes the W rows in order, so the LAST window slot that
    # maps to a ring row decides it: an unfilled slot then writes the
    # newest keyframe's pre-BA pose back (the live pose still adopts the
    # refined one, below). Mirrored, not fixed.
    on_row = rows_c[None, :] == torch.arange(K, device=dev)[:, None]  # [K, W]
    w_last = W - 1 - torch.argmax(on_row.flip(1).to(torch.uint8), dim=1)
    has = on_row.any(dim=1)
    kf_R = torch.where(has[:, None, None], Rw[w_last], st.kf_R)
    kf_t = torch.where(has[:, None], tw[w_last], st.kf_t)

    new_pos = torch.where(pt_valid_w[:, None]
                          & torch.isfinite(res.pt_pos).all(-1, keepdim=True),
                          res.pt_pos, pt_pos_w)
    pt_pos = torch.cat([_unrotate_update(st.pt_pos[:PT], new_pos, base_phys),
                        st.pt_pos[PT:]])

    had = obs_valid.any(dim=1)
    kept = res.obs_valid.any(dim=1)
    cull = had & ~kept & pt_valid_w
    new_valid_w = pt_valid_w & ~cull
    pt_valid = torch.cat([_unrotate_update(st.pt_valid[:PT], new_valid_w,
                                           base_phys), st.pt_valid[PT:]])

    # The live pose adopts the newest KF's refinement.
    iw_new = torch.clamp(k_new - start_kf, max=W - 1).reshape(1)
    newR = Rw.index_select(0, iw_new)[0]
    newt = tw.index_select(0, iw_new)[0]
    return st._replace(kf_R=kf_R, kf_t=kf_t, pt_pos=pt_pos,
                       pt_valid=pt_valid,
                       track=st.track._replace(R=newR, t=newt),
                       n_ba_culled=st.n_ba_culled + cull.sum())


# --------------------------------------------------------------------- #
# the per-frame step
# --------------------------------------------------------------------- #


def rt_step(gray, depth, boxes, st: RTState, cfg: SystemConfig,
            lim: RTLimits, *, generator: Optional[torch.Generator] = None,
            ransac_idx=None, init_idx=None) -> RTState:
    """One frame end to end.

    Args:
      gray: [H, W] grey image (uint8 or float) on the device; the left
        image for stereo.
      depth: [H, W] depth, raw integer units (divided by depth_map_factor)
        or float metres; for stereo the right image; for mono zeros.
      boxes: [B, 4] float32 padded detector boxes (xmin < 0 = absent).
      generator / ransac_idx: RANSAC sample source for the dynamic check.
      init_idx: (idx_h, idx_f) samples of a monocular initialisation
        attempt (else drawn from ``generator``).
    Reads one device bool (the keyframe decision) to the host; mono reads
    up to three more before its map exists.
    """
    return _rt_step(gray, depth, boxes, st, cfg, lim, generator=generator,
                    ransac_idx=ransac_idx, init_idx=init_idx)[0]


def _rt_step(gray, depth, boxes, st: RTState, cfg: SystemConfig,
             lim: RTLimits, *, generator=None, ransac_idx=None,
             init_idx=None, n_kf: Optional[int] = None):
    """``rt_step`` that also returns the keyframes the frame made (the host
    reads that decided them) and the mono initialisation attempt, if any.
    ``n_kf`` is the host's keyframe count (read from the state when not
    given); mono initialises while it is 0."""
    cam = cfg.camera
    t_cfg = cfg.tracking
    K, S = lim.max_kf, lim.spawn_per_kf
    PT = K * S
    dev = st.kf_R.device
    f32 = torch.float32
    mono = cfg.sensor == "monocular"

    g = gray.to(f32)
    if cfg.sensor == "stereo":
        fd = frame_mod.process_stereo(g, depth.to(f32), cam, cfg.orb,
                                      n_features=st.budget,
                                      dynamic_mask=st.dyn.sticky > 0,
                                      area_mode=st.dyn.area_flag)
    else:
        if depth.dtype.is_floating_point:
            d = depth.to(f32)
        else:
            d = depth.to(f32) / cam.depth_map_factor
        fd = frame_mod.process_rgbd(g, d, cam, cfg.orb, n_features=st.budget,
                                    dynamic_mask=st.dyn.sticky > 0,
                                    area_mode=st.dyn.area_flag)
    fd, spawn_ok, dyn2, _info = dynamic_mod.dynamic_step(
        fd, g, st.dyn, boxes, cfg, generator=generator, idx=ransac_idx)

    n_new = 0
    attempt = None
    if mono and (int(st.n_kf) if n_kf is None else n_kf) == 0:
        # Two-view initialisation replaces the depth bootstrap.
        st, attempt, built = _mono_init(st, fd, cfg, lim,
                                        generator=generator,
                                        init_idx=init_idx)
        n_new = 2 if built else 0

    # Tracking local map = the last `local_window` keyframe chunks + the
    # loop-closure reuse window + the bank re-seed window.
    Lw = lim.local_window * S
    k_new = torch.clamp(st.n_kf - 1, min=0)
    lstart = torch.clamp(k_new - lim.local_window + 1, min=0) * S
    temporal_ids = lstart + torch.arange(Lw, device=dev)
    temporal_valid = temporal_ids < st.n_kf * S

    Rw = lim.reuse_chunks * S
    reuse_ids = torch.clamp(st.reuse_lid, min=0) * S + torch.arange(Rw, device=dev)
    reuse_on = (st.reuse_lid >= 0) & (st.reuse_ttl > 0)
    reuse_valid = reuse_on & (reuse_ids < st.n_kf * S) \
        & pid_alive(reuse_ids, st.kf_lid, lim)

    seed_ids = SEED_BASE + torch.arange(lim.seed_slots, device=dev)
    seed_valid = (st.seed_ttl > 0).expand(lim.seed_slots)

    local_ids = torch.cat([temporal_ids, reuse_ids, seed_ids])
    local_alive = torch.cat([temporal_valid, reuse_valid, seed_valid])
    local_phys = pid_phys(local_ids, lim)

    pt_sd = brief.to_signed(brief.unpack_bits(st.pt_desc))
    arena = (st.pt_pos, pt_sd, st.pt_valid, st.pt_angle, st.pt_normal,
             st.pt_mind, st.pt_maxd)
    gate = 1.0 + st.n_lost.to(f32)

    # fused_step indexes the arena with PHYSICAL rows.
    pids_log = st.track.pids
    alive_in = pid_alive(pids_log, st.kf_lid, lim, seed_ok=st.seed_ttl > 0)
    track_in = st.track._replace(
        pids=torch.where(alive_in, pid_phys(pids_log, lim),
                         torch.full_like(pids_log, -1)))
    out = fused_step(fd, track_in, local_phys, local_alive, arena, gate, cfg)

    # Physical -> logical through the chunk's current tenant.
    phys = out.state.pids
    owner = st.kf_lid[torch.clamp(phys, min=0) // S % K]
    ring_log = owner * S + torch.clamp(phys, min=0) % S
    logical = torch.where(phys >= PT, SEED_BASE + phys - PT,
                          torch.where(phys >= 0, ring_log,
                                      torch.full_like(phys, -1)))
    track2 = out.state._replace(pids=logical)

    vec = out.scalars.vec
    ok = vec[_V_OK] > 0.5
    n_inl = vec[_V_INL].to(torch.int64)
    tracked_close = vec[_V_TRACKED_CLOSE]
    untracked_close = vec[_V_UNTRACKED_CLOSE]

    first = st.n_kf == 0
    if mono:
        # No depth bootstrap: the map appears only through _mono_init, and
        # until then no frame is tracked. On the initialising frame, when
        # the tracking gates fail, the initialised pose is kept.
        boot = torch.zeros_like(first)
        mono_inited = (st.n_kf == 2) & (st.frames_since_kf == 0) \
            & st.track.ok
    else:
        boot = first & (fd.feats.valid.sum() >= 500)
        mono_inited = torch.zeros_like(first)
    use_init = mono_inited & ~ok
    eye = torch.eye(3, dtype=f32, device=dev)
    pose = SE3(torch.where(first, eye,
                           torch.where(use_init, st.track.R, track2.R)),
               torch.where(first, torch.zeros(3, device=dev),
                           torch.where(use_init, st.track.t, track2.t)))
    ok = ok | boot | mono_inited
    track = track2._replace(R=pose.R, t=pose.t, ok=ok)

    # ---- keyframe policy (NeedNewKeyFrame; the mapper is inline).
    peak = torch.maximum(st.peak_inliers, n_inl)
    fsk = st.frames_since_kf + 1
    need_close = (tracked_close < 100) & (untracked_close > 70)
    ratio = t_cfg.kf_ref_ratio_mono if mono else t_cfg.kf_ref_ratio_stereo
    c1a = fsk >= t_cfg.max_frames_between_kf
    c1b = fsk >= t_cfg.min_frames_between_kf
    c2 = (n_inl < (ratio * peak.to(f32))) | need_close
    need_kf = ok & (n_inl > t_cfg.min_inliers_kf) & (c1a | (c1b & c2))
    need_kf = (need_kf & ~mono_inited) | boot

    st = st._replace(track=track, dyn=dyn2, peak_inliers=peak,
                     frames_since_kf=fsk,
                     fr_desc=fd.feats.desc, fr_uv=fd.feats.uv,
                     fr_depth=fd.depth, fr_valid=fd.feats.valid,
                     reuse_ttl=torch.clamp(st.reuse_ttl - 1, min=0),
                     seed_ttl=torch.clamp(st.seed_ttl - 1, min=0))
    made_kf = bool(need_kf)                # the frame's one host sync
    if made_kf:
        st = _create_keyframe(st, fd, spawn_ok, pose, local_ids,
                              local_alive, cfg, lim)

    # ---- COEB adaptive feature budget.
    if t_cfg.adaptive_budget:
        weak = ~ok | (n_inl <= t_cfg.weak_inlier_threshold)
        strong = st.strong_frames + (n_inl > t_cfg.strong_inlier_threshold).to(
            torch.int64)
        consec = torch.where(ok, st.consec_ok + 1, torch.zeros_like(st.consec_ok))
        decay = (consec >= t_cfg.decay_success_window) \
            | (strong >= t_cfg.decay_strong_window)
        floor = min(t_cfg.budget_floor, cfg.orb.n_features)
        budget = torch.where(
            weak, torch.clamp(st.budget + t_cfg.budget_step,
                              max=t_cfg.budget_cap),
            torch.where(decay, torch.clamp(st.budget - t_cfg.budget_step,
                                           min=floor), st.budget))
        zero = torch.zeros_like(consec)
        st = st._replace(budget=budget,
                         consec_ok=torch.where(decay, zero, consec),
                         strong_frames=torch.where(weak | decay, zero, strong))
    st = st._replace(n_lost=torch.where(ok, torch.zeros_like(st.n_lost),
                                        st.n_lost + 1))

    # ---- trajectory ring.
    row = torch.cat([ok.to(f32)[None], st.track.R.reshape(9), st.track.t,
                     (st.n_kf - 1).to(f32)[None]])
    fi = st.frame_idx % lim.max_frames
    traj = st.traj.index_copy(0, fi.reshape(1), row[None])
    return (st._replace(traj=traj, frame_idx=st.frame_idx + 1),
            n_new + made_kf, attempt)


# --------------------------------------------------------------------- #
# host loop
# --------------------------------------------------------------------- #


class RealtimeSlam:
    """Host loop around ``rt_step`` (and the optional maintenance program):
    ``track()`` uploads one frame and runs its step; ``finish()`` reads the
    session back.

    ``device`` defaults to CUDA and there is no CPU fallback: the session
    raises when CUDA is absent unless the caller asks for the CPU.
    ``vocabulary`` (``slam.vocabulary.Vocabulary``) enables the maintenance
    program (BoW loop closing, the place bank and relocalization), run
    after every ``maintain_every``-th frame. ``detector``
    (``models.detector.YoloDetector``) runs on the uploaded frame every
    ``detect_every`` frames, and its boxes, left on the device, feed the
    dynamic step until the next detection; boxes the caller passes win.
    ``cfg.sensor`` picks the entry: ``track`` (RGB-D), ``track_stereo`` or
    ``track_mono``.
    """

    def __init__(self, cfg: SystemConfig, lim: Optional[RTLimits] = None,
                 device=None, vocabulary=None, maintain_every: int = 8,
                 detector=None, detect_every: int = 10):
        device = resolve_device(device, "RealtimeSlam")
        if cfg.sensor not in ("rgbd", "stereo", "monocular"):
            raise ValueError(f"unknown sensor {cfg.sensor!r}")
        self.cfg = cfg
        self.lim = lim or RTLimits()
        self.device = device
        self.maintain_every = max(int(maintain_every), 1)
        self.detector = detector
        self.detect_every = max(int(detect_every), 1)
        self._det_boxes = None
        self.state = init_state(cfg, self.lim, device)
        self.stamps = []
        self._seed = 0
        self._gen = torch.Generator(device=device)
        self._no_boxes = torch.full((cfg.dynamic.max_boxes, 4), -1.0,
                                    device=device)
        # Host counts of keyframes made and BoW-processed: the maintenance
        # program's loop bounds, known without a read.
        self._n_kf = 0
        self._bow_next = 0
        # Mono: the initialisation attempts (frame, InitAttempt on the
        # device) and the zero depth image, made once.
        self.init_attempts = []
        self._zero_depth = None
        self.maint = None
        self.mstate = None
        if vocabulary is not None:
            from . import maintenance
            self.maint = maintenance.Maintainer(cfg, self.lim, vocabulary,
                                                device=device)
            self.mstate = self.maint.init_state()

    def _upload(self, x):
        """Host array -> device tensor. On the card the copy goes through
        pinned memory and does not wait for the queued device work."""
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            return x.to(self.device)
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _boxes(self, boxes):
        if boxes is None:
            return self._no_boxes
        if isinstance(boxes, torch.Tensor) and boxes.shape[0] \
                == self.cfg.dynamic.max_boxes:
            return self._upload(boxes).to(torch.float32)
        nb = self.cfg.dynamic.max_boxes
        arr = np.full((nb, 4), -1.0, np.float32)
        bb = np.asarray(boxes.cpu() if isinstance(boxes, torch.Tensor)
                        else boxes, np.float32).reshape(-1, 4)
        arr[:min(len(bb), nb)] = bb[:nb]
        return self._upload(arr)

    def track(self, gray, depth, stamp: float, boxes=None) -> None:
        """Run one RGB-D frame. gray/depth: [H, W] numpy arrays or
        tensors."""
        self._step(self._upload(gray), self._upload(depth), stamp, boxes)

    def track_stereo(self, gray_left, gray_right, stamp: float,
                     boxes=None) -> None:
        """Run one rectified stereo pair (``cfg.sensor == "stereo"``):
        depth comes from row-band disparity on the device."""
        if self.cfg.sensor != "stereo":
            raise ValueError("track_stereo needs cfg.sensor='stereo'")
        self._step(self._upload(gray_left), self._upload(gray_right), stamp,
                   boxes)

    def track_mono(self, gray, stamp: float, boxes=None) -> None:
        """Run one monocular frame (``cfg.sensor == "monocular"``): two-view
        initialisation until the map exists, then triangulated spawning;
        the map's scale is set by a median scene depth of 1 at
        initialisation."""
        if self.cfg.sensor != "monocular":
            raise ValueError("track_mono needs cfg.sensor='monocular'")
        if self._zero_depth is None:
            self._zero_depth = torch.zeros(
                (self.cfg.camera.height, self.cfg.camera.width),
                dtype=torch.int32, device=self.device)
        self._step(self._upload(gray), self._zero_depth, stamp, boxes)

    def _step(self, g, d, stamp, boxes):
        if self.detector is not None \
                and len(self.stamps) % self.detect_every == 0:
            self._det_boxes = self.detector.detect_device(g)
        if boxes is None:
            boxes = self._det_boxes
        self._gen.manual_seed(self._seed)
        self.state, n_new, attempt = _rt_step(
            g, d, self._boxes(boxes), self.state, self.cfg, self.lim,
            generator=self._gen, n_kf=self._n_kf)
        if attempt is not None:
            self.init_attempts.append((len(self.stamps), attempt))
        self._n_kf += n_new
        self.stamps.append(stamp)
        self._seed += 1
        if self.maint is not None \
                and len(self.stamps) % self.maintain_every == 0:
            self.state, self.mstate = self.maint.step(
                self.state, self.mstate, self._seed, n_kf=self._n_kf,
                bow_next=self._bow_next)
            self._bow_next = self._n_kf     # a dispatch processes them all

    def block(self) -> None:
        """Wait for all queued device work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def finish(self) -> dict:
        """The readback: trajectory, keyframes and the point map as numpy,
        with saturation/health counters."""
        st = self.state
        F = self.lim.max_frames
        total = len(self.stamps)
        n_dropped = max(0, total - F)
        np_ = lambda x: x.detach().cpu().numpy()
        traj = np_(st.traj)
        if total <= F:
            traj = traj[:total]
        else:
            traj = np.roll(traj, -(total % F), axis=0)
        n_kf = int(st.n_kf)
        kf_lid = np_(st.kf_lid)
        live = kf_lid >= 0
        rows = np.nonzero(live)[0][np.argsort(kf_lid[live])]
        out = {
            "stamps": np.asarray(self.stamps[n_dropped:]),
            "ok": traj[:, 0] > 0.5,
            "R": traj[:, 1:10].reshape(-1, 3, 3),
            "t": traj[:, 10:13],
            "n_kf": n_kf,
            "n_kf_live": int(live.sum()),
            "kf_evicted": max(0, n_kf - self.lim.max_kf),
            "frames_dropped": n_dropped,
            "kf_R": np_(st.kf_R)[rows],
            "kf_t": np_(st.kf_t)[rows],
            "kf_frame": np_(st.kf_frame)[rows],
            "kf_lid": kf_lid[rows],
            "kf_obs": np_(st.kf_obs)[rows],
            "kf_desc": np_(st.kf_desc)[rows],
            "kf_w": np_(st.kf_w)[rows],
            "kf_kp_valid": np_(st.kf_kp_valid)[rows],
            "kf_pid": np_(st.kf_pid)[rows],
            "pt_pos": np_(st.pt_pos),
            "pt_valid": np_(st.pt_valid),
            "pt_desc": np_(st.pt_desc),
            "pt_angle": np_(st.pt_angle),
            "budget": int(st.budget),
            "n_ba_culled": int(st.n_ba_culled),
            "n_assoc": int(st.n_assoc),
            "limits": self.lim,
        }
        if self.maint is not None:
            out.update(self.maint.report(self.mstate))
        if self.cfg.sensor == "monocular":
            out["init_attempts"] = [
                {"frame": i, "ok": bool(a.ok),
                 "homography": bool(a.used_homography),
                 "good": int(a.n_good), "points": int(a.n_points)}
                for i, a in self.init_attempts]
        return out

"""Tracking: the per-frame device step with in-graph state transition.

Counterpart of ``track_step``, ``DevTrackState``, ``StepScalars``,
``StepOut``, ``fused_step`` and the ``_V_*`` layout of
``coebslam_tpu/slam/tracking.py``. The host ``Tracker`` is not part of this
slice.

The reference runs its four matching/solve stages under ``lax.scan`` and
skips the retry stage with ``lax.cond`` when stage 0 was healthy. Here the
stages are a Python loop and the retry stage always runs: its result is
adopted only when stage 0 was weak, so computing it unconditionally gives
the same state without a host read of the device-side condition.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SystemConfig
from ..geometry import camera as cam_ops
from ..geometry import se3, so3
from ..geometry.se3 import SE3
from ..ops import matching
from ..optim import pose_gn
from .frame import FrameData


class TrackStepResult(NamedTuple):
    pose: SE3
    point_idx: torch.Tensor    # [N] index into the point set (-1 no match)
    inliers: torch.Tensor      # [N] bool
    n_inliers: torch.Tensor    # int64
    n_matches: torch.Tensor    # int64


def track_step(frame: FrameData, pose_pred: SE3, pts_w, pt_signed_desc,
               pt_valid, pt_angle, pt_normal, pt_min_dist, pt_max_dist,
               radius, cfg: SystemConfig) -> TrackStepResult:
    """Project-match-optimize against a candidate point set [M, ...];
    ``radius`` is the search radius in px at level 0 (0-d tensor)."""
    cam = cfg.camera
    pc = se3.transform_points(pose_pred, pts_w)
    uvr = cam_ops.project_stereo(cam, pc)
    vis = pt_valid & cam_ops.in_frustum(cam, pc, margin=radius)

    # Scale-invariance band and viewing angle within 60 deg of the normal.
    center = -torch.einsum("ji,j->i", pose_pred.R, pose_pred.t)
    vec = pts_w - center
    dist = torch.linalg.norm(vec, dim=-1)
    dist_ok = (dist > 0.8 * pt_min_dist) & (dist < 1.2 * pt_max_dist)
    view_cos = torch.einsum(
        "mi,mi->m", vec / torch.clamp(dist, min=1e-9)[:, None], pt_normal)
    vis = vis & dist_ok & (view_cos > 0.5)

    feats = frame.feats
    d = matching.hamming_matrix(feats.signed_desc(), pt_signed_desc)
    sf = torch.full((), cfg.orb.scale_factor, dtype=torch.float32,
                    device=pts_w.device)
    scale = torch.pow(sf, feats.level.to(torch.float32))
    dx = torch.abs(feats.uv[:, None, 0] - uvr[None, :, 0])
    dy = torch.abs(feats.uv[:, None, 1] - uvr[None, :, 1])
    r = radius * scale[:, None]
    d = d + torch.where((dx <= r) & (dy <= r), 0.0, matching.BIG)

    # Octave compatibility: keypoint level within +-1 of the predicted one.
    log_sf = torch.log(sf)
    pred_level = torch.ceil(
        torch.log(torch.clamp(pt_max_dist, min=1e-6)
                  / torch.clamp(dist, min=1e-6)) / log_sf)
    pred_level = torch.clamp(pred_level, 0, cfg.orb.n_levels - 1)
    level_diff = feats.level[:, None].to(torch.float32) - pred_level[None, :]
    d = d + torch.where(torch.abs(level_diff) <= 1.0, 0.0, matching.BIG)

    res = matching.match(d, max_distance=cfg.matcher.th_high,
                         ratio=cfg.matcher.nn_ratio_tracking, mutual=True,
                         row_valid=feats.valid, col_valid=vis)
    if cfg.matcher.check_orientation:
        res = matching.rotation_consistency(feats.angle, pt_angle, res,
                                            cfg.matcher.histo_length)

    X = pts_w[torch.clamp(res.idx, min=0)]
    opt = pose_gn.optimize_pose(pose_pred, X, frame.obs, frame.inv_sigma2,
                                res.valid, cam, cfg.optimizer)
    idx = torch.where(opt.inliers, res.idx, torch.full_like(res.idx, -1))
    return TrackStepResult(pose=opt.pose, point_idx=idx,
                           inliers=opt.inliers, n_inliers=opt.n_inliers,
                           n_matches=res.valid.sum())


class DevTrackState(NamedTuple):
    """Tracking state chained across frames on the device."""
    R: torch.Tensor            # [3, 3] pose Tcw
    t: torch.Tensor            # [3]
    vR: torch.Tensor           # [3, 3] velocity (Tcur . Tlast^-1)
    vt: torch.Tensor           # [3]
    has_vel: torch.Tensor      # bool
    ok: torch.Tensor           # bool — last frame tracked
    pids: torch.Tensor         # [N] int64 map-point id per keypoint (-1)


class StepScalars(NamedTuple):
    """Decision bundle: one f32 vector (layout ``_V_*``) + matched ids."""
    vec: torch.Tensor          # [22] f32
    pids: torch.Tensor         # [N] int64


# Layout of StepScalars.vec (counts are exact in f32 below 2^24).
_V_R = slice(0, 9)
_V_T = slice(9, 12)
_V_OK = 12
_V_INL1 = 13
_V_MATCH1 = 14
_V_INL2A = 15
_V_INL = 16
_V_NFEAT = 17
_V_DT = 18
_V_ANG = 19
_V_TRACKED_CLOSE = 20
_V_UNTRACKED_CLOSE = 21


class StepOut(NamedTuple):
    state: DevTrackState
    fd: FrameData
    scalars: StepScalars


def _select(pred, a, b):
    """Element-wise select between two identically-shaped NamedTuples."""
    return type(a)(*[torch.where(pred, x, y) for x, y in zip(a, b)])


def _select_result(pred, a: TrackStepResult, b: TrackStepResult):
    return TrackStepResult(_select(pred, a.pose, b.pose),
                           *[torch.where(pred, x, y)
                             for x, y in zip(a[1:], b[1:])])


def fused_step(fd: FrameData, state: DevTrackState, local_ids, local_valid,
               arena, gate_scale, cfg: SystemConfig) -> StepOut:
    """The tracking part of one frame.

    Args:
      fd: frame front-end output.
      state: previous frame's DevTrackState.
      local_ids/local_valid: [L] local-map candidate rows of the arena.
      arena: (pos, signed desc, valid, angle, normal, min dist, max dist).
      gate_scale: 0-d float tensor — motion-gate widening while lost.
    """
    pos, sd, pv, pa, pn, pmin, pmax = arena
    t_cfg = cfg.tracking
    dev = pos.device
    f32 = torch.float32
    pose_last = SE3(state.R, state.t)
    pose_pred = _select(state.has_vel,
                        SE3(state.vR, state.vt).compose(pose_last), pose_last)

    L = local_ids.shape[0]
    N = state.pids.shape[0]
    if L < N:
        raise ValueError(f"local map capacity ({L}) must be >= max keypoints "
                         f"({N}): stage-0 candidates would be truncated")
    s1_ids = torch.cat([torch.clamp(state.pids, min=0),
                        torch.zeros(L - N, dtype=torch.int64, device=dev)])
    s1_valid = torch.cat([state.pids >= 0,
                          torch.zeros(L - N, dtype=torch.bool, device=dev)])

    # Stage semantics (Tracking.cc:933-1048):
    #   0: motion-model predict vs last frame's points, tight window;
    #   1: widened retry from the unpredicted pose, adopted only when stage
    #      0 was weak and it found more inliers;
    #   2: wide pass over the local map from the adopted pose;
    #   3: tight re-match from the refined pose; best of 2/3 wins.
    r_mm = cfg.matcher.radius_motion_model
    widen = torch.clamp(gate_scale, max=3.0)
    outage = (widen > 1.0) | ~state.has_vel
    r1 = torch.where(outage, max(2.0 * r_mm, 50.0) * widen,
                     torch.full((), 2.0 * r_mm, dtype=f32, device=dev))
    radii = [torch.full((), r_mm, dtype=f32, device=dev), r1, 16.0 * widen,
             torch.full((), 6.0, dtype=f32, device=dev)]
    stage_ids = [(s1_ids, s1_valid), (s1_ids, s1_valid),
                 (local_ids, local_valid), (local_ids, local_valid)]

    pose_cur = pose_pred
    n_cur = torch.zeros((), dtype=torch.int64, device=dev)
    ys = []
    for k in range(4):
        ids, idv = stage_ids[k]
        pose_in = pose_pred if k == 0 else pose_last if k == 1 else pose_cur
        res = track_step(fd, pose_in, pos[ids], sd[ids], idv & pv[ids],
                         pa[ids], pn[ids], pmin[ids], pmax[ids], radii[k], cfg)
        if k == 1:
            adopt = (n_cur < 30) & (res.n_inliers > n_cur)
            n_cur = torch.where(adopt, res.n_inliers, n_cur)
        elif k == 2:
            adopt = res.n_inliers >= t_cfg.min_inliers_track
        else:
            adopt = torch.ones((), dtype=torch.bool, device=dev)
            if k == 0:
                n_cur = res.n_inliers
        pose_cur = _select(adopt, res.pose, pose_cur)
        ys.append(res)

    y0, y1, y2a, y2 = ys
    res1 = _select_result((y0.n_inliers < 30) & (y1.n_inliers > y0.n_inliers),
                          y1, y0)
    res2a = y2a
    final = _select_result(y2.n_inliers >= y2a.n_inliers, y2, y2a)

    # In-graph gates: enough inliers and a plausible motion.
    d = final.pose.compose(pose_last.inverse())
    dt = torch.linalg.norm(d.t)
    ang = torch.arccos(torch.clamp((torch.trace(d.R) - 1.0) / 2.0, -1.0, 1.0))
    ok = ((res1.n_inliers >= t_cfg.min_inliers_track)
          & (final.n_inliers >= t_cfg.min_inliers_track)
          & (dt <= t_cfg.max_translation_per_frame * gate_scale)
          & (ang <= t_cfg.max_rotation_per_frame * gate_scale))

    new_pose = _select(ok, final.pose, pose_last)
    new_pose = SE3(so3.orthonormalize(new_pose.R), new_pose.t)
    vel_ok = ok & state.ok
    new_vR = torch.where(vel_ok, so3.orthonormalize(d.R),
                         torch.eye(3, dtype=f32, device=dev))
    new_vt = torch.where(vel_ok, d.t, torch.zeros_like(d.t))

    minus1 = torch.full_like(final.point_idx, -1)
    pids_frame = torch.where(final.point_idx >= 0,
                             local_ids[torch.clamp(final.point_idx, min=0)],
                             minus1)
    pids_frame = torch.where(ok, pids_frame, minus1)
    new_pids = torch.where(ok, pids_frame, state.pids)

    # Keyframe-policy close-point statistics (NeedNewKeyFrame, RGB-D).
    close = fd.feats.valid & (fd.depth > 0) \
        & (fd.depth < cfg.camera.depth_threshold)
    has_pt = pids_frame >= 0
    new_state = DevTrackState(R=new_pose.R, t=new_pose.t, vR=new_vR,
                              vt=new_vt, has_vel=vel_ok, ok=ok,
                              pids=new_pids)
    vec = torch.cat([
        new_pose.R.reshape(9), new_pose.t,
        torch.stack([ok.to(f32),
                     res1.n_inliers.to(f32), res1.n_matches.to(f32),
                     res2a.n_inliers.to(f32), final.n_inliers.to(f32),
                     fd.feats.valid.sum().to(f32), dt, ang,
                     (close & has_pt).sum().to(f32),
                     (close & ~has_pt).sum().to(f32)])])
    return StepOut(state=new_state, fd=fd,
                   scalars=StepScalars(vec=vec, pids=pids_frame))

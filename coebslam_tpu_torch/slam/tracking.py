"""Tracking: the per-frame device step with in-graph state transition,
and the host ``Tracker`` of the host-orchestrated path.

Counterpart of ``coebslam_tpu/slam/tracking.py``. ``fused_step`` is the
frame's tracking program: the four matching/solve stages that the
reference runs under ``lax.scan`` are a Python loop here, and the retry
stage always runs (the reference skips it with ``lax.cond`` when stage 0
was healthy); its result is adopted only when stage 0 was weak, so the
state is the same without a host read of the device-side condition.

``Tracker`` is the host state machine around it (RGB-D, stereo and
monocular): initialisation (RGB-D and stereo from the first frame with
enough keypoints; monocular from two views through the H/F initializer),
the frame's dispatch, the decision tail (``_finalize``: LOST and
recovery, found/visible counts, the keyframe policy and keyframe creation
with point spawning), the adaptive feature budget and the loop-consistent
trajectory. Each finalize reads the frame's decision bundle back in one
transfer (``pipelined`` with ``finalize_batch`` B: one transfer for B
frames); a keyframe reads its feature block in one more; a monocular
initialisation attempt reads its result in one. The jitted step programs
of the reference are the plain functions ``frontend``, ``step_rgbd``,
``step_stereo``, ``step_rgbd_dyn`` and ``run_track``. The RANSACs draw
from ``torch.Generator``s seeded as the reference seeds its ``PRNGKey``s
(per frame for the dynamic step, from the stamp for the monocular
initializer); tests inject the reference's draws through ``sampler`` and
``init_sampler``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..geometry import camera as cam_ops
from ..geometry import se3, so3
from ..geometry.se3 import SE3
from ..ops import fundamental, initializer_ops, matching
from ..optim import pose_gn
from ..utils import metrics
from ..utils.device import resolve_device
from . import dynamic as dynamic_mod
from . import frame as frame_mod
from .frame import FrameData
from .map import MapArena

LOCAL_MAP_CAP = 4096

# Tracking states.
NOT_INITIALIZED = "NOT_INITIALIZED"
OK = "OK"
LOST = "LOST"


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
    with metrics.span("hamming"):
        cam = cfg.camera
        pc = se3.transform_points(pose_pred, pts_w)
        uvr = cam_ops.project_stereo(cam, pc)
        vis = pt_valid & cam_ops.in_frustum(cam, pc, margin=radius)

        # Scale-invariance band and viewing angle within 60 deg of the
        # normal.
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

        # Octave compatibility: keypoint level within +-1 of the predicted
        # one.
        log_sf = torch.log(sf)
        pred_level = torch.ceil(
            torch.log(torch.clamp(pt_max_dist, min=1e-6)
                      / torch.clamp(dist, min=1e-6)) / log_sf)
        pred_level = torch.clamp(pred_level, 0, cfg.orb.n_levels - 1)
        level_diff = (feats.level[:, None].to(torch.float32)
                      - pred_level[None, :])
        d = d + torch.where(torch.abs(level_diff) <= 1.0, 0.0, matching.BIG)

        res = matching.match(d, max_distance=cfg.matcher.th_high,
                             ratio=cfg.matcher.nn_ratio_tracking,
                             mutual=True, row_valid=feats.valid,
                             col_valid=vis)
        if cfg.matcher.check_orientation:
            res = matching.rotation_consistency(feats.angle, pt_angle, res,
                                                cfg.matcher.histo_length)

    with metrics.span("pose_gn"):
        X = pts_w[torch.clamp(res.idx, min=0)]
        opt = pose_gn.optimize_pose(pose_pred, X, frame.obs,
                                    frame.inv_sigma2, res.valid, cam,
                                    cfg.optimizer)
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
        with metrics.span(f"track_stage{k}"):
            res = track_step(fd, pose_in, pos[ids], sd[ids], idv & pv[ids],
                             pa[ids], pn[ids], pmin[ids], pmax[ids],
                             radii[k], cfg)
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
    retry = (y0.n_inliers < 30) & (y1.n_inliers > y0.n_inliers)
    res1 = _select_result(retry, y1, y0)
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
    if metrics.enabled():
        row = {"keypoints": fd.feats.valid.sum()}
        for k, y in enumerate(ys):
            row[f"matches{k}"] = y.n_matches
            row[f"inliers{k}"] = y.n_inliers
        metrics.count_device("tracking", {**row, "retry_adopted": retry,
                                          "tracked": ok})
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


class HostScalars(NamedTuple):
    """Host view of one frame's StepScalars."""
    R: np.ndarray
    t: np.ndarray
    ok: bool
    n_inl1: int
    n_match1: int
    n_inl2a: int
    n_inl: int
    n_feat: int
    dt: float
    ang: float
    tracked_close: int
    untracked_close: int
    pids: np.ndarray

    @staticmethod
    def unpack(vec: np.ndarray, pids: np.ndarray) -> "HostScalars":
        v = np.asarray(vec, np.float32)
        return HostScalars(
            R=v[_V_R].reshape(3, 3), t=v[_V_T],
            ok=bool(v[_V_OK] > 0.5),
            n_inl1=int(v[_V_INL1]), n_match1=int(v[_V_MATCH1]),
            n_inl2a=int(v[_V_INL2A]), n_inl=int(v[_V_INL]),
            n_feat=int(v[_V_NFEAT]), dt=float(v[_V_DT]),
            ang=float(v[_V_ANG]),
            tracked_close=int(v[_V_TRACKED_CLOSE]),
            untracked_close=int(v[_V_UNTRACKED_CLOSE]),
            pids=np.asarray(pids, np.int32))


def _fetch_scalars(batch: List[StepScalars]):
    """The decision bundles of a batch of frames as numpy (vec f32 [22],
    pids int32 [N]) pairs, in ONE device-to-host transfer."""
    n_vec = batch[0].vec.shape[0]
    flat = torch.stack([torch.cat([sc.vec.to(torch.float64),
                                   sc.pids.to(torch.float64)])
                        for sc in batch]).cpu().numpy()
    return [(row[:n_vec].astype(np.float32), row[n_vec:].astype(np.int32))
            for row in flat]


# --------------------------------------------------------------------- #
# The step programs (the reference's jitted closures).
# --------------------------------------------------------------------- #

def _cast(g, d, cfg: SystemConfig):
    """Grey to float32; raw integer depth to metres."""
    g = g.to(torch.float32)
    if d.dtype.is_floating_point:
        d = d.to(torch.float32)
    else:
        d = d.to(torch.float32) / cfg.camera.depth_map_factor
    return g, d


def frontend(g, d, n, cfg: SystemConfig, mask=None, area=None) -> FrameData:
    """The RGB-D frame constructor (extraction + depth association)."""
    g, d = _cast(g, d, cfg)
    return frame_mod.process_rgbd(g, d, cfg.camera, cfg.orb, n_features=n,
                                  dynamic_mask=mask, area_mode=area)


def step_rgbd(g, d, n, st, lids, lval, arena, gate, cfg: SystemConfig,
              mask=None, area=None) -> StepOut:
    """One RGB-D frame: front-end (optionally masked) + ``fused_step``."""
    fd = frontend(g, d, n, cfg, mask, area)
    return fused_step(fd, st, lids, lval, arena, gate, cfg)


def step_stereo(gl, gr, n, st, lids, lval, arena, gate,
                cfg: SystemConfig) -> StepOut:
    """One stereo frame: extraction on both images, row-band matching for
    depth, then ``fused_step``."""
    fd = frame_mod.process_stereo(gl.to(torch.float32), gr.to(torch.float32),
                                  cfg.camera, cfg.orb, n_features=n)
    return fused_step(fd, st, lids, lval, arena, gate, cfg)


def step_rgbd_dyn(g, d, n, st, dynst, boxes, lids, lval, arena, gate,
                  cfg: SystemConfig, generator=None, idx=None):
    """The fused dynamic-path frame: extraction masked by the previous
    frame's sticky mask and area flag, the motion check with box
    classification and keypoint culling, then ``fused_step``. ``generator``
    / ``idx`` are the F-RANSAC sample source (``idx`` may be a callable of
    the correspondence mask). Returns (StepOut, spawn_ok, DynState,
    DynInfo)."""
    g, dimg = _cast(g, d, cfg)
    fd = frame_mod.process_rgbd(g, dimg, cfg.camera, cfg.orb, n_features=n,
                                dynamic_mask=dynst.sticky > 0,
                                area_mode=dynst.area_flag)
    fd2, spawn_ok, dynst2, info = dynamic_mod.dynamic_step(
        fd, g, dynst, boxes, cfg, generator=generator, idx=idx)
    out = fused_step(fd2, st, lids, lval, arena, gate, cfg)
    return out, spawn_ok, dynst2, info


def run_track(fd, pose_pred: SE3, arena, ids, idv, radius,
              cfg: SystemConfig) -> TrackStepResult:
    """``track_step`` against the arena rows ``ids`` (valid where ``idv``)."""
    pos, sd, pv, pa, pn, pmin, pmax = arena
    return track_step(fd, pose_pred, pos[ids], sd[ids], idv & pv[ids],
                      pa[ids], pn[ids], pmin[ids], pmax[ids], radius, cfg)


# --------------------------------------------------------------------- #
# The host Tracker.
# --------------------------------------------------------------------- #

def _record_columns(fd: FrameData) -> torch.Tensor:
    """A FrameData's per-keypoint fields as [N, 39] float32 columns (uv,
    level, angle, depth, ur, valid, 32 descriptor bytes; levels, bytes and
    flags are exact in float32)."""
    f = fd.feats
    return torch.cat([f.uv, f.level.to(torch.float32)[:, None],
                      f.angle[:, None], fd.depth[:, None], fd.ur[:, None],
                      f.valid.to(torch.float32)[:, None],
                      f.desc.to(torch.float32)], dim=1)


def _unpack_record(flo: np.ndarray) -> "FrameRecord":
    """The host FrameRecord of ``_record_columns``' [N, >= 39] float32
    block (no point ids yet)."""
    return FrameRecord(
        uv=np.ascontiguousarray(flo[:, 0:2]),
        level=flo[:, 2].astype(np.int32), angle=flo[:, 3].copy(),
        desc=flo[:, 7:39].astype(np.uint8), depth=flo[:, 4].copy(),
        ur=flo[:, 5].copy(), valid=flo[:, 6] > 0.5,
        point_ids=np.full(flo.shape[0], -1, np.int32))


def _np_unproject_world(cam, uv: np.ndarray, depth: np.ndarray,
                        R_cw: np.ndarray, t_cw: np.ndarray) -> np.ndarray:
    """X_w = R_cw^T (X_c - t_cw) of pixels with depth, all numpy."""
    z = depth.astype(np.float32)
    x = (uv[:, 0] - cam.cx) / cam.fx * z
    y = (uv[:, 1] - cam.cy) / cam.fy * z
    pts_c = np.stack([x, y, z], axis=-1).astype(np.float32)
    return (pts_c - t_cw) @ R_cw


def _np_compose(Ra, ta, Rb, tb):
    return Ra @ Rb, Ra @ tb + ta


@dataclass
class TrackerState:
    mode: str = NOT_INITIALIZED
    pose_R: np.ndarray = field(
        default_factory=lambda: np.eye(3, dtype=np.float32))
    pose_t: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    last_kf: int = -1
    frames_since_kf: int = 0
    frame_idx: int = 0
    # COEB adaptive budget counters.
    budget: int = 1000
    consec_ok: int = 0
    strong_frames: int = 0
    n_lost_frames: int = 0
    peak_inliers_since_kf: int = 0


class FrameRecord(NamedTuple):
    """Host copy of the per-frame data a keyframe keeps."""
    uv: np.ndarray
    level: np.ndarray
    angle: np.ndarray
    desc: np.ndarray
    depth: np.ndarray
    ur: np.ndarray
    valid: np.ndarray
    point_ids: np.ndarray      # map point id per slot (-1 none)


@dataclass
class _FrameCtx:
    """One in-flight frame: device outputs + host metadata. ``corr_R/corr_t``
    accumulate world-side pose corrections applied between the frame's
    dispatch and its finalize: pose' = pose o corr."""
    out: StepOut
    stamp: float
    local_ids: np.ndarray      # host copy of the local-map candidate ids
    spawn_mask: Optional[np.ndarray]
    spawn_ok: Optional[torch.Tensor] = None   # [N] device bool (dyn path)
    corr_R: Optional[np.ndarray] = None
    corr_t: Optional[np.ndarray] = None

    def apply_correction(self, dR: np.ndarray, dt: np.ndarray) -> None:
        if self.corr_R is None:
            self.corr_R, self.corr_t = dR.copy(), dt.copy()
        else:
            self.corr_R, self.corr_t = _np_compose(self.corr_R, self.corr_t,
                                                   dR, dt)


#: ``sampler(seed, valid) -> [256, 8]`` F-RANSAC sample indices of the
#: dynamic step of the frame seeded ``seed``.
Sampler = Callable[[int, torch.Tensor], torch.Tensor]
#: ``init_sampler(seed, valid) -> (idx_h [200, 4], idx_f [200, 8])``: the
#: monocular initializer's samples of the attempt seeded ``seed``.
InitSampler = Callable[[int, torch.Tensor], tuple]


def _read_bundle(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Device tensors as numpy arrays of their shapes, in ONE transfer
    (flattened to float64: int64 indices and counts stay exact)."""
    flat = torch.cat([t.reshape(-1).to(torch.float64)
                      for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


class Tracker:
    """Host orchestration of tracking (RGB-D, stereo, monocular), on
    ``device`` (default CUDA; no CPU fallback). ``pipelined = True``
    finalizes frame i-1 after dispatching frame i, ``finalize_batch``
    frames at a time; the default finalizes each frame synchronously.
    ``sampler`` injects the dynamic step's F-RANSAC draws, ``init_sampler``
    the monocular initializer's."""

    def __init__(self, cfg: SystemConfig, map_arena: Optional[MapArena] = None,
                 device=None, sampler: Optional[Sampler] = None,
                 init_sampler: Optional[InitSampler] = None):
        self.cfg = cfg
        self.device = resolve_device(device, "Tracker")
        self.map = map_arena if map_arena is not None else MapArena(cfg)
        self.map.on_keyframe_removed.append(self._on_kf_removed)
        self.state = TrackerState(budget=cfg.orb.n_features)
        self.trajectory = []        # (stamp, R_cw, t_cw) at track time
        self.traj_relative = []     # (stamp, ref_kf, ref_seq, R, t, lost)
        self.ref_kf: int = -1
        self.on_keyframe = None     # callback(kf_id): local mapping
        self.on_frame = None        # callback() each frame: mapper poll
        self.mapper_idle_fn = None  # callback() -> bool
        self.reloc_fn = None        # callback(fd) -> relocalization result
        self.pipelined = False
        self.finalize_batch = 1
        self.sampler = sampler
        self.init_sampler = init_sampler
        self._gen = torch.Generator(device=self.device)
        self._mono_ref: Optional[FrameData] = None
        self._mono_ref_stamp = 0.0
        self.init_attempts: List[dict] = []   # monocular, as read
        self._consts = {}
        self._dev_state: Optional[DevTrackState] = None
        self._dyn_state: Optional[dynamic_mod.DynState] = None
        self.last_dyn_info = None     # device DynInfo of the newest frame
        self._dyn_seed = 0
        self._local_np = np.full(LOCAL_MAP_CAP, -1, np.int32)
        self._local_dev = None
        self._local_version = (-1, -1)     # (ref_kf, map.version)
        self._pending: List[_FrameCtx] = []
        self._last_ctx: Optional[_FrameCtx] = None
        self._last_frame: Optional[FrameRecord] = None
        self._last_pids: Optional[np.ndarray] = None
        self._spawn_mask = None
        self._spawn_vec = None
        # Localization-only mode: no keyframe insertion, no point spawning.
        self.localization_only = False

    # ------------------------------------------------------------------ #

    def _up(self, x, dtype=None) -> torch.Tensor:
        """Host array -> device tensor; on the card through pinned memory,
        without waiting for queued device work."""
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
        if dtype is not None:
            t = t.to(dtype)
        if t.device == self.device:
            return t
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _const(self, value, dtype) -> torch.Tensor:
        """A 0-d device constant, made once per value."""
        key = (value, dtype)
        c = self._consts.get(key)
        if c is None:
            c = torch.full((), value, dtype=dtype, device=self.device)
            self._consts[key] = c
        return c

    def _on_kf_removed(self, k: int) -> None:
        """Re-anchor references to a culled keyframe before its id is
        recycled: trajectory records on k fold the cull-relative pose into
        their own and move to the cull parent; so does the reference
        keyframe."""
        rel = self.map.kf_cull_rel.get(k)
        if rel is None:
            parent, Rcp, tcp = 0, np.eye(3, dtype=np.float32), \
                np.zeros(3, np.float32)
        else:
            parent, Rcp, tcp = rel
        pseq = int(self.map.kf_seq[parent])
        for i, (stamp, ref, _seq, R_rel, t_rel, lost) in \
                enumerate(self.traj_relative):
            if ref == k:
                self.traj_relative[i] = (
                    stamp, parent, pseq, R_rel @ Rcp, R_rel @ tcp + t_rel,
                    lost)
        if self.ref_kf == k:
            self.ref_kf = int(parent)

    def freeze_trajectory(self) -> None:
        """Bake the current map poses into the relative records (before a
        map reset invalidates the reference keyframes)."""
        self.traj_relative = [(s, -1, -1, R, t, lost)
                              for (s, R, t), (_, _, _, _, _, lost)
                              in zip(self.export_trajectory(),
                                     self.traj_relative)]

    def reset_runtime(self) -> None:
        """Drop all in-flight device state (system reset)."""
        self._pending.clear()
        self._last_ctx = None
        self._last_frame = None
        self._last_pids = None
        self._dev_state = None
        self._dyn_state = None
        self._local_dev = None
        self._local_version = (-1, -1)
        self._mono_ref = None

    @property
    def last_frame(self) -> Optional[FrameRecord]:
        """The newest finalized frame's record, fetched when asked for."""
        if self._last_frame is None and self._last_ctx is not None:
            rec = self._fetch_record(self._last_ctx.out.fd)[0]
            pids = self._last_pids if self._last_pids is not None \
                else rec.point_ids
            self._last_frame = rec._replace(point_ids=pids)
        return self._last_frame

    @last_frame.setter
    def last_frame(self, rec: Optional[FrameRecord]) -> None:
        """Seed the frame the next one matches against (a checkpoint
        resume); the device state is rebuilt from it."""
        self._last_frame = rec
        self._last_pids = None if rec is None \
            else np.asarray(rec.point_ids, np.int32)
        self._dev_state = None

    # ------------------------------------------------------------------ #

    def process_frame(self, gray, depth, stamp: float, dynamic_mask=None,
                      area_mode: bool = False, spawn_mask=None,
                      boxes_dev=None):
        """Track one RGB-D or monocular frame. Returns (state_str,
        n_inliers).

        ``depth``: [H, W] metres, or raw integer units scaled on the
        device; None for monocular (a zero depth: no keypoint has depth).
        ``dynamic_mask``: optional [H, W] bool where keypoints are dropped.
        ``spawn_mask``: optional [H, W] bool where map points must not be
        created. ``boxes_dev``: optional [B, 4] device boxes — selects the
        fused dynamic path. In pipelined mode the result describes the
        newest finalized frame; call ``flush()`` after the last frame.
        """
        spawn = None if spawn_mask is None else np.asarray(spawn_mask)
        budget = self._const(int(self.state.budget), torch.int64)
        g = self._up(gray)
        d = self._up(depth) if depth is not None else torch.zeros(
            g.shape, dtype=torch.float32, device=self.device)
        if self.state.mode == NOT_INITIALIZED:
            self.flush()
            if dynamic_mask is not None:
                fd = frontend(g, d, budget, self.cfg,
                              self._up(dynamic_mask, torch.bool),
                              self._const(bool(area_mode), torch.bool))
            else:
                fd = frontend(g, d, budget, self.cfg)
            self._spawn_mask = spawn
            if self.cfg.sensor == "monocular":
                n = self._initialize_monocular(fd, stamp)
            else:
                n = self._initialize(fd, stamp)
            self._record_pose(stamp)
            return self.state.mode, n
        ctx = self._dispatch(g, d, budget, stamp, spawn, dynamic_mask,
                             area_mode, boxes_dev)
        return self._advance(ctx)

    def process_frame_stereo(self, gray_left, gray_right, stamp: float):
        """Track one rectified stereo pair: depth from row-band matching,
        then the RGB-D tail. Returns (state_str, n_inliers)."""
        budget = self._const(int(self.state.budget), torch.int64)
        gl = self._up(gray_left).to(torch.float32)
        gr = self._up(gray_right).to(torch.float32)
        if self.state.mode == NOT_INITIALIZED:
            self.flush()
            fd = frame_mod.process_stereo(gl, gr, self.cfg.camera,
                                          self.cfg.orb, n_features=budget)
            self._spawn_mask = None
            n = self._initialize(fd, stamp)
            self._record_pose(stamp)
            return self.state.mode, n
        self._ensure_state()
        lids, lval = self._refresh_local_map()
        out = step_stereo(gl, gr, budget, self._dev_state, lids, lval,
                          self._device_map(), self._gate_scale(), self.cfg)
        return self._advance(self._post_dispatch(out, stamp, None))

    # ------------------------------------------------------------------ #

    def _gate_scale(self) -> torch.Tensor:
        s = 1.0 + (self.state.n_lost_frames if self.state.mode == LOST else 0)
        return self._const(float(s), torch.float32)

    def _dispatch(self, g, d, budget, stamp, spawn_mask, dynamic_mask,
                  area_mode, boxes_dev=None) -> _FrameCtx:
        self._ensure_state()
        lids, lval = self._refresh_local_map()
        arena = self._device_map()
        gate = self._gate_scale()
        if boxes_dev is not None:
            if self._dyn_state is None:
                self._dyn_state = dynamic_mod.init_dyn_state(self.cfg,
                                                             self.device)
            self._dyn_seed += 1
            seed = self._dyn_seed
            if self.sampler is not None:
                idx = lambda valid: self.sampler(seed, valid).to(valid.device)
                gen = None
            else:
                idx, gen = None, self._gen.manual_seed(seed)
            out, spawn_ok, self._dyn_state, self.last_dyn_info = \
                step_rgbd_dyn(g, d, budget, self._dev_state, self._dyn_state,
                              self._up(boxes_dev, torch.float32), lids, lval,
                              arena, gate, self.cfg, generator=gen, idx=idx)
            return self._post_dispatch(out, stamp, spawn_mask,
                                       spawn_ok=spawn_ok)
        if dynamic_mask is not None:
            out = step_rgbd(g, d, budget, self._dev_state, lids, lval, arena,
                            gate, self.cfg, self._up(dynamic_mask, torch.bool),
                            self._const(bool(area_mode), torch.bool))
        else:
            out = step_rgbd(g, d, budget, self._dev_state, lids, lval, arena,
                            gate, self.cfg)
        return self._post_dispatch(out, stamp, spawn_mask)

    def _post_dispatch(self, out: StepOut, stamp, spawn_mask,
                       spawn_ok=None) -> _FrameCtx:
        self._dev_state = out.state
        return _FrameCtx(out=out, stamp=stamp, local_ids=self._local_np,
                         spawn_mask=spawn_mask, spawn_ok=spawn_ok)

    def _advance(self, ctx: _FrameCtx):
        """Finalize this frame (synchronous) or the oldest in-flight ones
        (pipelined; ``finalize_batch`` B > 1 finalizes B frames from one
        bundled transfer)."""
        if not self.pipelined:
            res = self._finalize(ctx)
            if self.on_frame:
                self.on_frame()
            return res
        self._pending.append(ctx)
        res = (self.state.mode, -1)
        B = max(1, self.finalize_batch)
        if len(self._pending) > B:
            raws = _fetch_scalars([c.out.scalars for c in self._pending[:B]]) \
                if B > 1 else [None]
            for raw in raws:
                if not self._pending:
                    break          # recovery drained the in-flight frames
                res = self._finalize(self._pending.pop(0), raw=raw)
        if self.on_frame:
            self.on_frame()
        return res

    def flush(self):
        """Finalize all in-flight frames (pipelined mode)."""
        res = None
        while self._pending:
            res = self._finalize(self._pending.pop(0))
        return res

    # ------------------------------------------------------------------ #

    def _ensure_state(self) -> None:
        """(Re)build the device state from the host's values."""
        if self._dev_state is not None:
            return
        st = self.state
        N = self.cfg.orb.max_keypoints
        pids = self._last_pids if self._last_pids is not None \
            else np.full(N, -1, np.int32)
        self._dev_state = DevTrackState(
            R=self._up(st.pose_R, torch.float32),
            t=self._up(st.pose_t, torch.float32),
            vR=torch.eye(3, dtype=torch.float32, device=self.device),
            vt=torch.zeros(3, dtype=torch.float32, device=self.device),
            has_vel=self._const(False, torch.bool),
            ok=self._const(st.mode == OK, torch.bool),
            pids=self._up(pids[:N], torch.int64))

    def apply_world_correction(self, dR: np.ndarray, dt: np.ndarray) -> None:
        """Right-compose a world-side pose correction (the map moved) into
        the live state; the velocity is invariant under it."""
        st = self.state
        st.pose_R, st.pose_t = _np_compose(st.pose_R, st.pose_t, dR, dt)
        if self._dev_state is not None:
            cur_R = self._dev_state.R.cpu().numpy()
            cur_t = self._dev_state.t.cpu().numpy()
            cR, ct = _np_compose(cur_R, cur_t, dR, dt)
            self._dev_state = self._dev_state._replace(
                R=self._up(cR, torch.float32), t=self._up(ct, torch.float32))
        for ctx in self._pending:
            ctx.apply_correction(dR, dt)

    def _set_state_pose(self, R, t, ok: bool = True, pids=None) -> None:
        """Overwrite the device state's pose (recovery, mapper refinement)."""
        kw = dict(R=self._up(np.asarray(R, np.float32).reshape(3, 3)),
                  t=self._up(np.asarray(t, np.float32).reshape(3)),
                  vR=torch.eye(3, dtype=torch.float32, device=self.device),
                  vt=torch.zeros(3, dtype=torch.float32, device=self.device),
                  has_vel=self._const(False, torch.bool),
                  ok=self._const(bool(ok), torch.bool))
        if pids is not None:
            kw["pids"] = self._up(pids, torch.int64)
        self._dev_state = self._dev_state._replace(**kw)

    def _refresh_local_map(self):
        """Covisibility local map, recomputed only when the reference
        keyframe or the arena changed."""
        key = (self.ref_kf, self.map.version)
        if self._local_dev is None or self._local_version != key:
            ids = self.map.local_map_points(self._local_keyframes(),
                                            LOCAL_MAP_CAP)
            self._local_np = ids
            self._local_dev = (self._up(np.clip(ids, 0, None), torch.int64),
                               self._up(ids >= 0))
            self._local_version = key
        return self._local_dev

    # ------------------------------------------------------------------ #

    def _finalize(self, ctx: _FrameCtx, raw=None) -> tuple:
        """Host decision tail of one frame: LOST handling, bookkeeping and
        the keyframe policy. Reads the frame's decision bundle (already
        fetched in batched mode); a keyframe or a recovery reads more."""
        st = self.state
        if raw is None:
            raw = _fetch_scalars([ctx.out.scalars])[0]
        sc = HostScalars.unpack(*raw)
        if ctx.corr_R is not None:
            Rn, tn = _np_compose(sc.R, sc.t, ctx.corr_R, ctx.corr_t)
            sc = sc._replace(R=Rn.astype(np.float32),
                             t=tn.astype(np.float32))
        self._last_ctx = ctx
        self._last_frame = None
        n_inliers = sc.n_inl

        if not sc.ok:
            recovered = self._recover(ctx)
            if recovered is None:
                st.mode = LOST
                st.n_lost_frames += 1
                st.consec_ok = 0
                self._record_pose(ctx.stamp)
                self._bump_frame(0)
                return LOST, 0
            sc, n_inliers = recovered

        st.mode = OK
        st.consec_ok += 1
        st.n_lost_frames = 0
        st.pose_R = np.asarray(sc.R, np.float32).reshape(3, 3)
        st.pose_t = np.asarray(sc.t, np.float32).reshape(3)

        # Found/visible counts for culling; the match list may be one
        # mapping stage stale, so follow fuse redirects and drop dead ids.
        pids = self.map.resolve_ids(sc.pids)
        self._last_pids = pids
        self.map.pt_found[pids[pids >= 0]] += 1
        lids = ctx.local_ids
        self.map.pt_visible[lids[lids >= 0]] += 1

        st.frames_since_kf += 1
        st.peak_inliers_since_kf = max(st.peak_inliers_since_kf, n_inliers)
        if not self.localization_only and self._need_keyframe(
                sc.tracked_close, sc.untracked_close, n_inliers):
            rec, spawn_vec = self._fetch_record(ctx.out.fd, ctx.spawn_ok)
            rec = rec._replace(point_ids=pids)
            self._spawn_mask = ctx.spawn_mask
            self._spawn_vec = spawn_vec
            self._create_keyframe(rec, ctx.stamp, fd_dev=ctx.out.fd)
            st.peak_inliers_since_kf = n_inliers
        self._record_pose(ctx.stamp)
        self._bump_frame(n_inliers)
        return OK, n_inliers

    def _bump_frame(self, n_inliers: int) -> None:
        self._apply_adaptive_budget(n_inliers)
        self.state.frame_idx += 1

    def _recover(self, ctx: _FrameCtx):
        """The in-graph gates failed: relocalization (``reloc_fn``), else a
        wide search against the reference keyframe, then local-map
        re-tracking, on the newest in-flight frame (older ones are
        dropped). Repairs the device state on success."""
        cfg = self.cfg
        while self._pending:
            newer = self._pending.pop(0)
            self._record_pose(ctx.stamp)
            ctx = newer
        fd = ctx.out.fd
        pose_cand = None
        relocalized = False
        if self.reloc_fn is not None:
            rr = self.reloc_fn(fd)
            if rr.ok:
                pose_cand = SE3(self._up(rr.R, torch.float32),
                                self._up(rr.t, torch.float32))
                relocalized = True
        if pose_cand is None and self.ref_kf >= 0:
            ref_ids = self.map.kf_obs_pt[self.ref_kf]
            ref_ids = self._pad_ids(ref_ids[ref_ids >= 0],
                                    self.cfg.orb.max_keypoints)
            pose_last = SE3(self._up(self.state.pose_R, torch.float32),
                            self._up(self.state.pose_t, torch.float32))
            res = self._run_track(fd, pose_last, ref_ids, 50.0)
            if int(res.n_inliers) < cfg.tracking.min_inliers_track:
                return None
            pose_cand = res.pose
        if pose_cand is None:
            return None
        local_ids = ctx.local_ids
        res2a = self._run_track(fd, pose_cand, local_ids, 16.0)
        n2a = int(res2a.n_inliers)
        pose = res2a.pose if n2a >= cfg.tracking.min_inliers_track \
            else pose_cand
        res2 = self._run_track(fd, pose, local_ids, 6.0)
        if int(res2.n_inliers) < n2a:
            res2 = res2a
        n = int(res2.n_inliers)
        if n < cfg.tracking.min_inliers_track and not relocalized:
            return None
        idx = res2.point_idx.cpu().numpy()
        pids = np.where(idx >= 0, local_ids[np.clip(idx, 0, None)], -1)
        pids = pids.astype(np.int32)
        R = res2.pose.R.cpu().numpy()
        t = res2.pose.t.cpu().numpy()
        self._set_state_pose(R, t, ok=True, pids=pids)
        sc = HostScalars(
            R=R, t=t, ok=True, n_inl1=n, n_match1=n, n_inl2a=n2a, n_inl=n,
            n_feat=0, dt=0.0, ang=0.0, tracked_close=0, untracked_close=0,
            pids=pids)
        self._last_ctx = ctx
        return sc, n

    def _fetch_record(self, fd: FrameData, spawn_ok=None):
        """A device FrameData (and the dynamic path's spawn mask) as a host
        FrameRecord, in ONE transfer."""
        cols = _record_columns(fd)
        if spawn_ok is not None:
            cols = torch.cat([cols, spawn_ok.to(torch.float32)[:, None]],
                             dim=1)
        flo = cols.cpu().numpy()
        spawn_vec = flo[:, 39] > 0.5 if spawn_ok is not None else None
        return _unpack_record(flo), spawn_vec

    # ------------------------------------------------------------------ #

    def _initialize(self, fd: FrameData, stamp: float) -> int:
        """RGB-D initialisation: with enough keypoints, spawn map points for
        every keypoint with depth and insert the first keyframe."""
        rec = self._fetch_record(fd)[0]
        n_feat = int(rec.valid.sum())
        if n_feat < 500:
            return n_feat
        has_depth = rec.valid & (rec.depth > 0) & ~self._in_spawn_mask(rec)
        pts_w = _np_unproject_world(self.cfg.camera, rec.uv[has_depth],
                                    rec.depth[has_depth],
                                    self.state.pose_R, self.state.pose_t)
        ids = self.map.add_points(pts_w, rec.desc[has_depth], first_kf=0,
                                  angles=rec.angle[has_depth])
        point_ids = np.full(rec.uv.shape[0], -1, np.int32)
        point_ids[np.nonzero(has_depth)[0][ids >= 0]] = ids[ids >= 0]
        kf = self.map.add_keyframe(
            self.state.pose_R, self.state.pose_t, stamp, rec.uv, rec.level,
            rec.angle, rec.desc, rec.depth, rec.ur, rec.valid, point_ids)
        self.map.update_point_stats(ids[ids >= 0])
        self._last_frame = rec._replace(point_ids=point_ids)
        self._last_pids = point_ids
        self.ref_kf = kf
        self.state.last_kf = kf
        self.state.frames_since_kf = 0
        self.state.mode = OK
        self._dev_state = None
        if self.on_keyframe:
            self.on_keyframe(kf)
        return n_feat

    def _init_draws(self, seed: int, valid: torch.Tensor):
        """The initializer's (idx_h, idx_f) samples of the attempt seeded
        ``seed``: the injected ones, or the generator's."""
        if self.init_sampler is not None:
            return tuple(i.to(valid.device)
                         for i in self.init_sampler(seed, valid))
        n = self.cfg.ransac.init_iterations
        gen = self._gen.manual_seed(seed)
        return (fundamental.sample_indices(valid, n, gen, k=4),
                fundamental.sample_indices(valid, n, gen, k=8))

    def _initialize_monocular(self, fd: FrameData, stamp: float) -> int:
        """Two-view monocular initialisation: hold a reference frame with
        more than 100 keypoints, match each next frame to it in a wide
        window, run the H/F initializer, and build the map from the
        triangulated points with the median depth scaled to 1 (the first
        keyframe at identity, the second at the recovered pose). An
        attempt reads its match count (a stale reference, with fewer than
        100 matches, is dropped before the initializer runs, as in the
        reference), then the initializer's result with both frames'
        records in one more transfer."""
        cfg = self.cfg
        n_feat = int(fd.feats.valid.sum())
        if self._mono_ref is None:
            if n_feat > 100:
                self._mono_ref = fd
                self._mono_ref_stamp = stamp
            return n_feat
        if n_feat <= 100:
            self._mono_ref = None
            return n_feat

        ref = self._mono_ref
        d = matching.hamming_matrix(ref.feats.signed_desc(),
                                    fd.feats.signed_desc())
        d = d + matching.window_penalty(ref.feats.uv, fd.feats.uv,
                                        cfg.matcher.radius_init)
        res = matching.match(d, max_distance=cfg.matcher.th_low,
                             ratio=cfg.matcher.nn_ratio_init, mutual=True,
                             row_valid=ref.feats.valid,
                             col_valid=fd.feats.valid)
        n_match = int(res.valid.sum())
        if n_match < 100:
            self._mono_ref = None       # the reference is stale: restart
            return n_feat
        uv2 = fd.feats.uv[torch.clamp(res.idx, min=0)]
        idx_h, idx_f = self._init_draws(int(stamp * 1e4) & 0x7fffffff,
                                        res.valid)
        rr = initializer_ops.reconstruct_graph(
            ref.feats.uv, uv2, res.valid, cfg.camera, idx_h, idx_f,
            n_hypotheses=cfg.ransac.init_iterations,
            sigma=cfg.ransac.init_sigma)
        (ok, use_h, R2, t2, good, X, idx2, ref_cols,
         cur_cols) = _read_bundle([
             rr.ok, rr.used_homography, rr.R, rr.t, rr.good, rr.points,
             res.idx, _record_columns(ref), _record_columns(fd)])
        self.init_attempts.append(dict(
            stamp=stamp, matches=n_match, ok=bool(ok),
            homography=bool(use_h), good=int(good.sum())))
        if not ok:
            return n_feat

        good = good > 0.5
        X = X.astype(np.float32)
        med = float(np.median(X[good][:, 2]))
        if med <= 0:
            return n_feat
        X = X / med
        t2 = (t2.astype(np.float32) / med).astype(np.float32)
        R2 = R2.astype(np.float32)
        ref_rec = _unpack_record(ref_cols.astype(np.float32))
        cur_rec = _unpack_record(cur_cols.astype(np.float32))

        # The first keyframe at identity.
        ids = self.map.add_points(X[good], ref_rec.desc[good], first_kf=0,
                                  angles=ref_rec.angle[good])
        pids1 = np.full(ref_rec.uv.shape[0], -1, np.int32)
        pids1[np.nonzero(good)[0][ids >= 0]] = ids[ids >= 0]
        kf1 = self.map.add_keyframe(
            np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
            self._mono_ref_stamp, ref_rec.uv, ref_rec.level, ref_rec.angle,
            ref_rec.desc, ref_rec.depth, ref_rec.ur, ref_rec.valid, pids1)
        # The second at the recovered pose.
        idx2 = idx2.astype(np.int64)
        pids2 = np.full(cur_rec.uv.shape[0], -1, np.int32)
        pids2[idx2[np.nonzero(good)[0][ids >= 0]]] = ids[ids >= 0]
        kf2 = self.map.add_keyframe(
            R2, t2, stamp, cur_rec.uv, cur_rec.level, cur_rec.angle,
            cur_rec.desc, cur_rec.depth, cur_rec.ur, cur_rec.valid, pids2)
        self.map.update_point_stats(ids[ids >= 0])

        self.state.pose_R, self.state.pose_t = R2, t2
        self._last_frame = cur_rec._replace(point_ids=pids2)
        self._last_pids = pids2
        self.ref_kf = kf2
        self.state.last_kf = kf2
        self.state.frames_since_kf = 0
        self.state.mode = OK
        self._mono_ref = None
        self._dev_state = None
        if self.on_keyframe:
            self.on_keyframe(kf1)
            self.on_keyframe(kf2)
            self.state.pose_R = self.map.kf_R[kf2].copy()
            self.state.pose_t = self.map.kf_t[kf2].copy()
        return int(n_match)

    # ------------------------------------------------------------------ #

    def _device_map(self):
        """Device-resident point arrays, synced row by row."""
        from . import map_device
        return map_device.sync(self.map, self.cfg, self.device).points

    def _run_track(self, fd, pose_pred, point_ids, radius) -> TrackStepResult:
        return run_track(fd, pose_pred, self._device_map(),
                         self._up(np.clip(point_ids, 0, None), torch.int64),
                         self._up(point_ids >= 0),
                         self._const(float(radius), torch.float32), self.cfg)

    def _pad_ids(self, ids: np.ndarray, size: int) -> np.ndarray:
        out = np.full(size, -1, np.int32)
        out[:min(len(ids), size)] = ids[:size]
        return out

    def _local_keyframes(self) -> np.ndarray:
        """The reference keyframe's covisibility neighbourhood, capped at
        ``max_local_keyframes``."""
        if self.ref_kf < 0:
            return np.zeros(0, np.int64)
        nbrs = self.map.covisible_keyframes(
            self.ref_kf, min_weight=1,
            top=self.cfg.tracking.max_local_keyframes - 1)
        return np.unique(np.concatenate([[self.ref_kf], nbrs]))

    def _need_keyframe(self, tracked_close: int, untracked_close: int,
                       n_inliers: int) -> bool:
        """NeedNewKeyFrame, RGB-D branch."""
        t = self.cfg.tracking
        if self.map.n_kf >= self.cfg.map.max_keyframes - 1:
            return False
        ref_obs = self.map.kf_obs_pt[self.ref_kf]
        ref_pts = ref_obs[ref_obs >= 0]
        min_obs = 3 if self.map.n_kf > 2 else self.map.n_kf
        n_ref = int((self.map.point_observation_count(ref_pts)
                     >= min_obs).sum()) if len(ref_pts) else 0
        need_close = tracked_close < 100 and untracked_close > 70
        c1a = self.state.frames_since_kf >= t.max_frames_between_kf
        # Throttle on mapper idleness; c1a (max interval) overrides it.
        mapper_idle = self.mapper_idle_fn() if self.mapper_idle_fn else True
        c1b = (self.state.frames_since_kf >= t.min_frames_between_kf
               and mapper_idle)
        ratio = t.kf_ref_ratio_mono if self.cfg.sensor == "monocular" \
            else t.kf_ref_ratio_stereo
        decayed = n_inliers < ratio * self.state.peak_inliers_since_kf
        c2 = (n_inliers < n_ref * ratio or decayed
              or need_close) and n_inliers > t.min_inliers_kf
        return bool((c1a or (c1b and c2)) and n_inliers > t.min_inliers_kf)

    def _create_keyframe(self, rec: FrameRecord, stamp: float,
                         fd_dev: Optional[FrameData] = None) -> None:
        """Insert a keyframe; spawn points for close-depth keypoints
        without an association (all closer than the depth threshold, else
        the closest 100)."""
        cam = self.cfg.camera
        spawn = rec.valid & (rec.point_ids < 0) & (rec.depth > 0) \
            & ~self._in_spawn_mask(rec)
        if self._spawn_vec is not None:
            spawn &= self._spawn_vec
        close = spawn & (rec.depth < cam.depth_threshold)
        if close.sum() < 100:
            cand = np.nonzero(spawn)[0]
            order = cand[np.argsort(rec.depth[cand])][:100]
            sel = np.zeros_like(spawn)
            sel[order] = True
        else:
            sel = close
        point_ids = rec.point_ids.copy()
        if sel.any():
            pts_w = _np_unproject_world(cam, rec.uv[sel], rec.depth[sel],
                                        self.state.pose_R, self.state.pose_t)
            ids = self.map.add_points(pts_w, rec.desc[sel],
                                      first_kf=self.map.n_kf,
                                      angles=rec.angle[sel])
            point_ids[np.nonzero(sel)[0][ids >= 0]] = ids[ids >= 0]

        kf = self.map.add_keyframe(
            self.state.pose_R, self.state.pose_t, stamp, rec.uv, rec.level,
            rec.angle, rec.desc, rec.depth, rec.ur, rec.valid, point_ids)
        if fd_dev is not None:
            dm = self.map.__dict__.get("_devmap")
            if dm is not None:
                dm.adopt_keyframe_row(self.map, kf, fd_dev)
        self.map.update_point_stats(point_ids[point_ids >= 0])
        self.ref_kf = kf
        self.state.last_kf = kf
        self.state.frames_since_kf = 0
        self._last_frame = rec._replace(point_ids=point_ids)
        self._last_pids = point_ids
        # The next frame matches against the newly spawned points too.
        if self._dev_state is not None:
            self._dev_state = self._dev_state._replace(
                pids=self._up(point_ids, torch.int64))
        if self.on_keyframe:
            self.on_keyframe(kf)
            # Synchronous mapping may have refined this keyframe's pose;
            # the tracker follows it. Pipelined mode applies no correction
            # (the next frame's local-map stages re-base the live pose).
            new_R, new_t = self.map.kf_R[kf], self.map.kf_t[kf]
            if not self.pipelined:
                self.state.pose_R = new_R.copy()
                self.state.pose_t = new_t.copy()
                self._set_state_pose(new_R, new_t, ok=True,
                                     pids=self._last_pids)

    def _apply_adaptive_budget(self, n_inliers: int) -> None:
        """COEB adaptive feature budget: grow by a step on loss or weak
        tracking, up to the cap; decay after a run of OK or strong frames."""
        t = self.cfg.tracking
        if not t.adaptive_budget:
            return
        st = self.state
        if st.mode == LOST or n_inliers <= t.weak_inlier_threshold:
            st.budget = min(st.budget + t.budget_step, t.budget_cap)
            st.strong_frames = 0
            return
        if n_inliers > t.strong_inlier_threshold:
            st.strong_frames += 1
        if st.consec_ok >= t.decay_success_window \
                or st.strong_frames >= t.decay_strong_window:
            floor = min(t.budget_floor, self.cfg.orb.n_features)
            st.budget = max(st.budget - t.budget_step, floor)
            st.consec_ok = 0
            st.strong_frames = 0

    # ------------------------------------------------------------------ #

    def _in_spawn_mask(self, rec: FrameRecord) -> np.ndarray:
        mask = self._spawn_mask
        if mask is None:
            return np.zeros(rec.uv.shape[0], bool)
        u = np.clip(rec.uv[:, 0].round().astype(int), 0, mask.shape[1] - 1)
        v = np.clip(rec.uv[:, 1].round().astype(int), 0, mask.shape[0] - 1)
        return mask[v, u]

    def _record_pose(self, stamp: float) -> None:
        self.trajectory.append((stamp, self.state.pose_R.copy(),
                                self.state.pose_t.copy()))
        # Loop-consistent record: the pose relative to the reference
        # keyframe, composed again at export.
        if self.ref_kf >= 0:
            Rr, tr = self.map.kf_R[self.ref_kf], self.map.kf_t[self.ref_kf]
            R_rel = self.state.pose_R @ Rr.T
            t_rel = self.state.pose_t - R_rel @ tr
            self.traj_relative.append(
                (stamp, self.ref_kf, int(self.map.kf_seq[self.ref_kf]),
                 R_rel, t_rel, self.state.mode == LOST))
        else:
            self.traj_relative.append(
                (stamp, -1, -1, self.state.pose_R.copy(),
                 self.state.pose_t.copy(), self.state.mode == LOST))

    def export_trajectory(self):
        """The relative records composed against the current keyframe
        poses, so later map corrections reach every earlier frame."""
        out = []
        for stamp, ref, ref_seq, R_rel, t_rel, lost in self.traj_relative:
            if ref < 0:
                out.append((stamp, R_rel, t_rel))
                continue
            if int(self.map.kf_seq[ref]) != ref_seq:
                raise RuntimeError(
                    f"trajectory record at t={stamp} references keyframe id "
                    f"{ref} whose slot was recycled (seq {ref_seq} -> "
                    f"{int(self.map.kf_seq[ref])})")
            Rr, tr, found = self.map.anchored_pose(int(ref))
            if not found:
                raise RuntimeError(
                    f"trajectory record at t={stamp}: anchor chain for "
                    f"culled keyframe {ref} could not be resolved")
            out.append((stamp, R_rel @ Rr, R_rel @ tr + t_rel))
        return out

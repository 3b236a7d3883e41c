"""The comparison that decides ``correct``, the control, and the faults the
tests plant.

``check_session`` compares what a session's timed path produced on its
sampled frames with the plain reference (``reference.py``) computed again
from the frames the benchmark made:

- ``feat_mismatch_pct``: keypoint slots whose validity, position, level or
  descriptor differ, in % of the slots valid on either side (the FAST
  kernel, the pyramid, grid selection, orientation and BRIEF).
- ``depth_mismatch_pct`` (stereo): left keypoints present on both sides
  whose stereo depth differs (presence, or by more than 1e-5 relative).
- ``det_head_rel_err`` (detector): the largest difference of the three
  raw YOLOv5s heads, over the largest magnitude of the reference's.
- ``match_mismatch_pct``: of the four tracking stages, keypoints whose
  final inlier map point differs, in % of those with one on either side.
- ``pose_gap_mm``: the stages' poses against the reference's pose solve in
  float64, the larger of the translation gap and the rotation gap times
  1 m, in mm.
- ``stages_unsolved`` (a count, no limit): sampled stages where fewer than
  3 matches enter the reference's pose solve. ORB-SLAM2's
  ``Optimizer::PoseOptimization`` returns before optimising when
  ``nInitialCorrespondences < 3``: 1-2 matches give 2-6 rows for 6
  unknowns, so the pose has no defined answer, and float32 against
  float64 lands anywhere. This is no tolerance: such a stage has no pose
  and no inliers to compare. Its number of matches is compared exactly
  instead: where the port's (``n_matches``, before its solve) differs
  from the reference's, the stage reads ``match_mismatch_pct`` 100. The
  port cannot make a frame from such a stage (it needs
  ``min_inliers_track`` inliers), and the next stage, which starts from
  its pose, is compared on its own inputs. The rule is keyed on the
  reference's count alone: a port that finds fewer than 3 matches where
  the reference finds 3 or more is compared in full. ``stages_solved``
  counts the others; a run that compares ``pose_gap_mm`` and solved no
  sampled stage is not correct (``fleet._not_covered``), since its pose
  and inlier numbers would read 0 by default.
- ``spawn_gap_mm`` (``check_keyframes``): on sampled keyframes of the
  window, the largest distance between a point the keyframe spawned, as
  the windowed BA receives it, and the reference's position of it in
  float64: RGB-D and stereo unproject the same keypoint at the
  reference's own depth through the keyframe's pose; monocular
  triangulates the reference's keypoint against the previous keyframe's
  keypoint that names the same new point (``reference.triangulate``).
- ``spawn_mismatch_pct``: of those spawned points, in %, the ones where the
  reference finds no valid keypoint, or no depth under the close-point
  threshold (RGB-D, stereo), or no partner in the previous keyframe or a
  failed gate of the triangulation (monocular), or whose chunk slot is
  not valid, and the chunk's valid slots that no keypoint names.
- ``ba_pose_gap_mm``: on the same keyframes, the windowed BA's free
  keyframe poses against the reference's BA (float64) of the window the
  timed path built, the largest pose gap as ``pose_gap_mm`` takes it.
- ``missing_outputs``: sampled frames that lack one of these outputs.

A monocular frame has no depth: its observations carry u_right -1, as
``track_mono`` hands the port a zero depth image. A monocular map's unit
is the median scene depth at its initialisation, not the metre, so for a
monocular sensor these "mm" are thousandths of that unit.

The extraction's budget, dynamic mask and area flag, the keypoints that
the dynamic step culled, each tracking stage's map points and start pose,
a keyframe's pose and choice of keypoints to spawn, a monocular
keyframe's partners in the previous keyframe (that keyframe's pose,
keypoints and levels), and the BA's window (its poses, points and
observations) exist only in the session's state:
the reference takes them as the timed path handed them on. The keypoints
themselves, their depths, observation vectors and weights are the
reference's own.
"""
from __future__ import annotations

import inspect
import math
from typing import NamedTuple

import torch

from . import reference as ref


class RefCam(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float
    width: int
    height: int


def ref_cam(cfg: dict) -> RefCam:
    c = cfg["camera"]
    return RefCam(c["fx"], c["fy"], c["cx"], c["cy"], c.get("bf", 0.0),
                  c["width"], c["height"])


def ref_orb(cfg: dict) -> ref.Orb:
    o = cfg["orb"]
    return ref.Orb(o["n_features"], o["scale_factor"], o["n_levels"],
                   o.get("fast_threshold_min", 7),
                   o.get("fast_threshold_min_masked", 10),
                   max_keypoints=o.get("max_keypoints", 2048))


def _stage_inputs(args):
    fd, pose, pts, sd, pv, pa, pn, pmin, pmax, radius = args[:10]
    return fd, pose, pts, sd, pv, pa, pn, pmin, pmax, radius


def ref_frame(cfg, cam, orb, frames, fi, nf, mask, area, dev):
    """The reference's keypoints of frame ``fi`` (with the budget, mask and
    area flag the timed path's extraction had), their depth and u_right:
    RGB-D from the frame's depth image at the rounded pixel, stereo from
    the row-band match against the right image, monocular none (0 and
    -1)."""
    g = torch.from_numpy(frames.gray[fi]).to(dev).to(torch.float32)
    fr = ref.extract(g, orb, nf, mask, area)
    if cfg["sensor"] == "monocular":
        d = torch.zeros_like(fr.uv[:, 0])
        ur = torch.full_like(d, -1.0)
    elif cfg["sensor"] == "stereo":
        right = torch.from_numpy(frames.second[fi]).to(dev).to(torch.float32)
        d, ur = ref.stereo_depth(fr, ref.extract(right, orb, nf), cam,
                                 orb.scale_factor)
    else:
        dm = torch.from_numpy(frames.second[fi]).to(dev).to(torch.float32) \
            / cfg["camera"]["depth_map_factor"]
        d = ref.depth_rgbd(fr, dm, cam)
        ur = torch.where(d > 0, fr.uv[:, 0] - cam.bf
                         / torch.where(d > 0, d, torch.ones_like(d)),
                         torch.full_like(d, -1.0))
    return fr, d, ur


def ref_stage(cfg, cam, args, dtype, fr=None, ur=None):
    """The reference's tracking stage on the inputs the timed path handed
    to one stage: (R, t, point index per keypoint, matches that entered
    the pose solve). With the reference's
    own keypoints ``fr`` and u_right ``ur``, the keypoints, observation
    vectors and weights are the reference's, and only the validity after
    the dynamic step's culling is the stage's."""
    fd, pose, pts, sd, pv, pa, pn, pmin, pmax, radius = _stage_inputs(args)
    f = fd.feats
    sf = cfg["orb"]["scale_factor"]
    if fr is None:
        uv, level, angle, desc, valid = f.uv, f.level, f.angle, f.desc, \
            f.valid
        obs, w = fd.obs, fd.inv_sigma2
    else:
        valid = f.valid & fr.valid
        uv = torch.where(valid[:, None], fr.uv, torch.full_like(fr.uv, -1.0))
        level, angle, desc = fr.level, fr.angle, fr.desc
        obs = torch.cat([fr.uv, ur[:, None]], dim=-1)
        w = ref.inv_sigma2(fr.level, sf)
    opt = {"rounds": 4, "iters": 10, "chi2_mono": 5.991,
           "chi2_stereo": 7.815}
    opt.update(cfg.get("optimizer", {}))
    mcfg = {"th_high": 100, "nn_ratio_tracking": 0.9, "histo_length": 30}
    mcfg.update(cfg.get("matcher", {}))
    return ref.track_stage(
        uv, level, angle, ref.signed(desc), valid, obs, w, pose.R, pose.t,
        pts, sd, pv, pa, pn, pmin, pmax, radius, cam, sf,
        cfg["orb"]["n_levels"], mcfg, opt, dtype)


def _pct(bad, among):
    n = int(among.sum())
    return 100.0 * float(bad.sum()) / n if n else 0.0


def compare_feats(p, r):
    """(% of slots differing, mask of slots equal on both sides and
    valid)."""
    same = (p.valid == r.valid) & (p.level == r.level) \
        & (p.uv == r.uv).all(-1) & (p.desc == r.desc).all(-1)
    either = p.valid | r.valid
    return _pct(either & ~same, either), same & p.valid & r.valid


def pose_gap_mm(R1, t1, R2, t2):
    R1, t1, R2, t2 = (x.to(torch.float64) for x in (R1, t1, R2, t2))
    dt = float(torch.linalg.norm(t1 - t2))
    D = R1 @ R2.T
    # The angle from the skew part as well as the trace: acos of the trace
    # alone loses all digits below ~3e-4 rad near the identity.
    s = float(torch.linalg.norm(torch.stack([D[2, 1] - D[1, 2],
                                             D[0, 2] - D[2, 0],
                                             D[1, 0] - D[0, 1]]))) / 2.0
    ang = math.atan2(s, float(torch.trace(D) - 1.0) / 2.0)
    return 1e3 * max(dt, ang * 1.0)


def compare_stage(out, res, R, t, idx, n_ref):
    """Fold one tracking stage into the session's numbers: the port's
    result ``res`` against the reference's (R, t, idx) from ``n_ref``
    matches. Below ``reference.MIN_POSE_MATCHES`` only the count of
    matches is compared (module docstring)."""
    if n_ref < ref.MIN_POSE_MATCHES:
        out["stages_unsolved"] += 1
        if int(res.n_matches) != n_ref:
            out["match_mismatch_pct"] = 100.0
        return
    out["stages_solved"] += 1
    either = (res.point_idx >= 0) | (idx >= 0)
    out["match_mismatch_pct"] = max(
        out["match_mismatch_pct"],
        _pct(either & (res.point_idx != idx), either))
    out["pose_gap_mm"] = max(out["pose_gap_mm"], pose_gap_mm(
        res.pose.R, res.pose.t, R, t))


def check_session(records, frames, cfg, ref_model, dev) -> dict:
    """The session's numbers: each the largest over its sampled frames."""
    cam = ref_cam(cfg)
    orb = ref_orb(cfg)
    stereo = cfg["sensor"] == "stereo"
    out = {"feat_mismatch_pct": 0.0, "match_mismatch_pct": 0.0,
           "pose_gap_mm": 0.0, "missing_outputs": 0,
           "frames_checked": len(records), "stages_solved": 0,
           "stages_unsolved": 0}
    if stereo:
        out["depth_mismatch_pct"] = 0.0
    if ref_model is not None:
        out["det_head_rel_err"] = 0.0
    with torch.no_grad(), ref.tf32(False):
        for r in records:
            if "extract" not in r or len(r["stages"]) != 4 or (
                    ref_model is not None and "heads" not in r):
                out["missing_outputs"] += 1
                continue
            fi = r["frame"]
            g8 = torch.from_numpy(frames.gray[fi]).to(dev)
            nf, mask, area, fd = r["extract"]
            fr, d_r, ur_r = ref_frame(cfg, cam, orb, frames, fi, nf, mask,
                                      area, dev)
            pct, same = compare_feats(fd.feats, fr)
            out["feat_mismatch_pct"] = max(out["feat_mismatch_pct"], pct)
            if stereo:
                d_p = fd.depth
                has = same & ((d_p > 0) | (d_r > 0))
                bad = has & (((d_p > 0) != (d_r > 0))
                             | (torch.abs(d_p - d_r) > 1e-5 * d_r))
                out["depth_mismatch_pct"] = max(out["depth_mismatch_pct"],
                                                _pct(bad, has))
            if ref_model is not None:
                heads_r = ref_model(ref.detector_input(
                    g8, cfg["detector"]["input_size"]))
                err = max(float((a - b).abs().max() / b.abs().max())
                          for a, b in zip(r["heads"], heads_r))
                out["det_head_rel_err"] = max(out["det_head_rel_err"], err)
            for args, res in r["stages"]:
                compare_stage(out, res, *ref_stage(cfg, cam, args,
                                                   torch.float64, fr, ur_r))
    return out


def _spawn_depth(r, cfg, cam, fr, d, kps):
    """RGB-D and stereo: the reference's unprojection of each spawned
    keypoint at its own depth through the keyframe's pose, and whether
    that depth is one the keyframe spawns from."""
    f64 = torch.float64
    c = cfg["camera"]
    z = d[kps].to(f64)
    uv = fr.uv[kps].to(f64)
    pc = torch.stack([(uv[:, 0] - cam.cx) / cam.fx * z,
                      (uv[:, 1] - cam.cy) / cam.fy * z, z], -1)
    X = (pc - r["t"].to(f64)) @ r["R"].to(f64)
    return X, (z > 0) & (z < c["bf"] * c["th_depth"] / c["fx"])


def _spawn_mono(r, cfg, cam, fr, d, kps):
    """Monocular: the reference's triangulation of each spawned keypoint
    against the previous keyframe's keypoint that names the same new point
    (its observation, level and pose as the BA received them), and whether
    there is one and the pair passes every gate."""
    f64 = torch.float64
    prev = r["prev"]
    sf = cfg["orb"]["scale_factor"]
    pair = r["pid"][kps][:, None] == prev["pid"][None, :]
    j = torch.argmax(pair.to(torch.uint8), 1)
    level2 = torch.round(-torch.log(prev["w"][j].to(f64))
                         / (2.0 * math.log(sf)))
    # 5.991: CreateNewMapPoints' own chi^2 (2 degrees of freedom, 95 %).
    X, ok = ref.triangulate(fr.uv[kps].to(f64), fr.level[kps],
                            prev["uv"][j], level2, r["R"], r["t"], prev["R"],
                            prev["t"], cam, sf, 5.991)
    return X, pair.any(1) & ok


def check_keyframes(records, frames, cfg, lim, dev) -> dict:
    """``spawn_gap_mm``, ``spawn_mismatch_pct`` and ``ba_pose_gap_mm``
    over the sampled keyframes, and how many keyframes and spawned points
    they cover."""
    cam = ref_cam(cfg)
    orb = ref_orb(cfg)
    S = lim.spawn_per_kf
    spawned = _spawn_mono if cfg["sensor"] == "monocular" else _spawn_depth
    out = {"spawn_gap_mm": 0.0, "spawn_mismatch_pct": 0.0,
           "ba_pose_gap_mm": 0.0, "keyframes_checked": 0,
           "spawned_checked": 0}
    with torch.no_grad(), ref.tf32(False):
        for r in records:
            if r.get("extract") is None:
                out["spawn_mismatch_pct"] = 100.0
                continue
            nf, mask, area = r["extract"]
            fr, d, _ = ref_frame(cfg, cam, orb, frames, r["frame"], nf, mask,
                                 area, dev)
            base = (int(r["n_kf"]) - 1) * S
            pid = r["pid"]
            new = (pid >= base) & (pid < base + S)
            kps = torch.nonzero(new)[:, 0]
            slots = pid[kps] - base
            X, spawns = spawned(r, cfg, cam, fr, d, kps)
            gap = 1e3 * torch.linalg.norm(r["pos"][slots].to(torch.float64)
                                          - X, dim=-1)
            sound = fr.valid[kps] & spawns & r["valid"][slots]
            # Every valid slot of the chunk belongs to exactly one keypoint.
            named = torch.zeros_like(r["valid"])
            named[slots] = True
            bad = int((~sound).sum()) + int((r["valid"] & ~named).sum()) \
                + len(kps) - len(torch.unique(slots))
            among = max(len(kps), int(r["valid"].sum()))
            if bool(sound.any()):
                out["spawn_gap_mm"] = max(out["spawn_gap_mm"],
                                          float(gap[sound].max()))
            out["spawn_mismatch_pct"] = max(
                out["spawn_mismatch_pct"], 100.0 * bad / among if among
                else 0.0)
            out["keyframes_checked"] += 1
            out["spawned_checked"] += len(kps)
            if "ba" not in r:
                out["ba_pose_gap_mm"] = math.inf
                continue
            prob, res = r["ba"]
            R, t, _, _ = ref_ba(cfg, cam, prob, torch.float64)
            for k in torch.nonzero(~prob.kf_fixed & prob.kf_valid)[:, 0]:
                out["ba_pose_gap_mm"] = max(out["ba_pose_gap_mm"], pose_gap_mm(
                    res.kf_R[k], res.kf_t[k], R[k], t[k]))
    return out


def ref_ba(cfg, cam, prob, dtype):
    """The reference's windowed BA of the window ``prob`` the timed path
    built: (R, t, X, final observation validity)."""
    opt = {"ba_first": 5, "ba_second": 10, "chi2_mono": 5.991,
           "chi2_stereo": 7.815}
    o = cfg.get("optimizer", {})
    opt.update({k: o[v] for k, v in (("ba_first", "local_ba_iters_first"),
                                     ("ba_second", "local_ba_iters_second"),
                                     ("chi2_mono", "chi2_mono"),
                                     ("chi2_stereo", "chi2_stereo"))
                if v in o})
    return ref.windowed_ba(prob.kf_R, prob.kf_t, prob.kf_fixed,
                           prob.kf_valid, prob.pt_pos, prob.pt_valid,
                           prob.obs_kf, prob.obs_uvr, prob.obs_w,
                           prob.obs_valid, cam, opt, dtype)


# ------------------------------------------------------------------ #
# The control: the reference in the program's place, one precision down
# ------------------------------------------------------------------ #

def install_control(det, ref_model, cfg, extractor, frame, tracking,
                    local_ba):
    """Put the reference in the program's place, computed in the
    precision below the configuration's: TF32 products in the pyramid and
    the detector, bfloat16 arithmetic in the RGB-D and the stereo depth,
    the pose solve and the windowed BA."""
    from coebslam_tpu_torch.geometry.se3 import SE3
    cam = ref_cam(cfg)
    orb = ref_orb(cfg)

    def extract(img, _cfg, *, n_features=None, dynamic_mask=None,
                area_mode=None):
        with ref.tf32(True):
            return extractor.Features(*ref.extract(img, orb, n_features,
                                                   dynamic_mask, area_mode))

    def process_rgbd(gray, depth_img, _cam, _orb, *, n_features=None,
                     dynamic_mask=None, area_mode=None):
        f = extract(gray, None, n_features=n_features,
                    dynamic_mask=dynamic_mask, area_mode=area_mode)
        bf16 = torch.bfloat16
        d = ref.depth_rgbd(f, depth_img.to(bf16), cam)
        ur = torch.where(d > 0, f.uv[:, 0].to(bf16) - cam.bf
                         / torch.where(d > 0, d, torch.ones_like(d)),
                         torch.full_like(d, -1.0))
        d, ur = d.to(torch.float32), ur.to(torch.float32)
        return frame.FrameData(
            feats=f, depth=d, ur=ur,
            inv_sigma2=ref.inv_sigma2(f.level, orb.scale_factor),
            obs=torch.cat([f.uv, ur[:, None]], dim=-1))

    def match_stereo(fl, fr, _cam, _orb, row_tolerance=2.0):
        return ref.stereo_depth(fl, fr, cam, orb.scale_factor,
                                dtype=torch.bfloat16)

    def track_step(*args):
        R, t, idx, n = ref_stage(cfg, cam, args, torch.bfloat16)
        inl = idx >= 0
        return tracking.TrackStepResult(
            SE3(R.to(torch.float32), t.to(torch.float32)), idx, inl,
            inl.sum(), torch.tensor(n, device=idx.device))

    def optimize_local_ba(prob, *_a, **_k):
        R, t, X, valid = ref_ba(cfg, cam, prob, torch.bfloat16)
        f = torch.float32
        return local_ba.BAResult(R.to(f), t.to(f), X.to(f), valid,
                                 torch.zeros_like(prob.obs_w))

    extractor.extract = extract
    frame.process_rgbd = process_rgbd
    frame.match_stereo = match_stereo
    tracking.track_step = track_step
    local_ba.optimize_local_ba = optimize_local_ba
    if det is not None:
        size = cfg["detector"]["input_size"]

        def heads(gray):
            with torch.no_grad(), ref.tf32(True):
                return ref_model(ref.detector_input(gray, size))

        det.heads = heads


# ------------------------------------------------------------------ #
# Faults the tests plant underneath the timed path
# ------------------------------------------------------------------ #

FAULTS = ("state_unchanged", "half_dropped", "answer_altered")
KEYFRAME_FAULTS = ("spawn_depth_off", "ba_skipped")


def install_fault(kind, extractor, realtime, tracking, local_ba):
    """``state_unchanged``: each step returns the state it was given;
    ``half_dropped``: every other keypoint slot is left out;
    ``answer_altered``: each tracking stage's pose is moved by 1 cm;
    ``spawn_depth_off``: a keyframe's points are spawned at 1.01 times
    their depth, unprojected (RGB-D, stereo) or triangulated and moved 1 %
    along the ray from the keyframe's centre (monocular);
    ``ba_skipped``: the windowed BA returns its window unchanged."""
    if kind == "state_unchanged":
        realtime._rt_step = lambda g, d, b, st, *a, **k: (st, 0, None)
    elif kind == "half_dropped":
        orig = extractor.extract

        def extract(*a, **k):
            f = orig(*a, **k)
            keep = torch.arange(f.valid.shape[0], device=f.valid.device) % 2
            return f._replace(valid=f.valid & (keep == 0))

        extractor.extract = extract
    elif kind == "answer_altered":
        orig = tracking.track_step

        def track_step(*a, **k):
            r = orig(*a, **k)
            t = r.pose.t + torch.tensor([0.01, 0.0, 0.0], device=r.pose.t.device)
            return r._replace(pose=r.pose._replace(t=t))

        tracking.track_step = track_step
    elif kind == "ba_skipped":
        local_ba.optimize_local_ba = lambda prob, *a, **k: local_ba.BAResult(
            prob.kf_R, prob.kf_t, prob.pt_pos, prob.obs_valid,
            torch.zeros_like(prob.obs_w))
    elif kind == "spawn_depth_off":
        orig = realtime._unproject_world
        realtime._unproject_world = lambda cam, uv, depth, R, t: orig(
            cam, uv, 1.01 * depth, R, t)
        tri = realtime.triangulation
        orig_tri = tri.triangulate_pair
        params = inspect.signature(orig_tri)

        def triangulate_pair(*a, **k):
            res = orig_tri(*a, **k)
            T1 = params.bind(*a, **k).arguments["T1"]
            centre = -T1.t @ T1.R
            return res._replace(points=centre + 1.01 * (res.points - centre))

        tri.triangulate_pair = triangulate_pair
    else:
        raise ValueError(f"unknown fault {kind!r}")

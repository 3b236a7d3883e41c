"""The scenes of the host System's stereo, monocular and flow entries and
the helpers that measure them, shared by ``chip_smoke.py`` ([15]),
``cpu_reference.py`` (``host-stereo``, ``host-mono``, ``host-flow`` and
their ``-full`` variants) and the port's tests.

[15a] is tests/test_stereo_checkpoint.py::test_stereo_tracking_e2e's room
(all 40 frames of its orbit), [15b] tests/test_monocular.py::
TestMonocularRelocalization's kidnap and [15c] tests/test_dynamic_e2e.py's
walker through the flow motion check. Each ``*_config`` builds either
package's ``SystemConfig`` from its ``config`` module: with ``full`` at
the width the phase runs (``SystemConfig(sensor="stereo")``, the mono
test's configuration with ``OrbConfig()``, ``SystemConfig()`` with the
flow check), else at the test's cut (1024 keypoints on 4 levels). The
``*_frames`` functions render a scene through a package's render
callable (``asarray`` makes that package's array from numpy); the
``run_*`` functions drive a ``System`` of either package and return the
gates' numbers, ``*_failures`` the failed gates.
"""
import contextlib
import time

import numpy as np

TEST_ORB = dict(max_keypoints=1024, n_levels=4, n_features=1000)
TEST_MAP = dict(max_keyframes=64, max_points=16384)
# [15a]: host stereo on the room's 0.35 m orbit of 40 frames, every frame.
HOST_STEREO_ORBIT = dict(n_frames=40, radius=0.35)
HOST_STEREO_MAX_NOT_OK = 1
HOST_STEREO_ATE_LIMIT_M = 0.05
# [15b]: host mono with a kidnap: frames 0-21 of the 0.8 m orbit of 60
# frames, 3 black frames, then frame 12 again; the scene's own
# vocabulary from every 4th frame.
HOST_MONO_ORBIT = dict(n_frames=60, radius=0.8)
HOST_MONO_TRACK = 22
HOST_MONO_BLACK = 3
HOST_MONO_RETURN = 12
HOST_MONO_VOCAB_FRAMES = range(0, HOST_MONO_TRACK, 4)
HOST_MONO_VOCAB = dict(n_desc=4000, branching=8, depth=3, seed=0)
HOST_MONO_FIRST_OK_MAX = 10
HOST_MONO_MAX_LOST_AFTER = 3
HOST_MONO_MIN_POINTS = 100
HOST_MONO_ATE_LIMIT_M = 0.25      # Sim3-aligned
HOST_MONO_RETURN_LIMIT_M = 0.15   # from the frame's own earlier centre
# [21]: the System's recovery through the Relocalizer's EPnP branch:
# [15b]'s configuration on the room's orbit at 1.2 m radius (60 frames a
# lap), frames 0-45 tracked, 3 black frames, then frame 15 again: 2.4 m
# from frame 45's pose, beyond the fused step's widened gate
# (slam/tracking.py: the search radius widens at most 3x while lost), so
# the lost state's retry fails and the tracker's relocalization callback,
# the Relocalizer, takes the frame: with no depth, through EPnP. ([15b]'s
# own 0.8 m orbit is too narrow: on the H100 the port's map recovered
# frame 12 from frame 45 through the widened gate.)
HOST_EPNP_ORBIT = dict(n_frames=60, radius=1.2)
HOST_EPNP_TRACK = 46
HOST_EPNP_RETURN = 15
HOST_EPNP_VOCAB_FRAMES = range(0, HOST_EPNP_TRACK, 4)
# [20]: the monocular Sim3 loop closure. No rendered circuit makes the JAX
# package's monocular System close a loop (ROADMAP queue 4), so [20] closes
# one on [21]'s map: the keyframes of the last third of the session (by
# sequence) are moved, with every point they observe, by a similarity of
# scale HOST_MONO_LOOP_DRIFT["scale"] about their mean centre (points the
# earlier keyframes also observe are copied first), as a monocular map
# that drifts in scale sees a place it returns to; the newest keyframe is
# then closed against the oldest (compute_sim3 with scale, correct with
# the free-scale pose graph and the global BA).
HOST_MONO_LOOP_DRIFT = dict(scale=1.2, yaw=0.06, shift=0.1, n_moved=1)
HOST_MONO_LOOP_GAIN = 0.8        # keyframe Sim3 ATE after < 0.8 x drifted
# [15c]: the flow motion check on the walker scene: the first 25 frames
# of the room's 0.35 m orbit of 50.
N_HOST_FLOW = 25
HOST_FLOW_ORBIT = dict(n_frames=2 * N_HOST_FLOW, radius=0.35)
HOST_FLOW_WALKER = dict(start=(-0.6, -0.15, 1.6), velocity=(0.04, 0.025, 0.0),
                        half_w=0.3, half_h=0.65)
HOST_FLOW_ATE_LIMIT_M = 0.02
HOST_FLOW_MAX_LOST = 2


def host_stereo_config(config, full=True):
    """[15a]'s SystemConfig: ``SystemConfig(sensor="stereo")``, or the
    test's stereo_config."""
    if full:
        return config.SystemConfig(sensor="stereo")
    return config.SystemConfig(
        camera=config.CameraConfig(), orb=config.OrbConfig(**TEST_ORB),
        map=config.MapConfig(**TEST_MAP),
        tracking=config.TrackingConfig(max_frames_between_kf=10),
        sensor="stereo")


def host_mono_config(config, full=True):
    """[15b]'s SystemConfig: TestMonocularRelocalization's, at
    ``OrbConfig()``'s width or the test's cut."""
    return config.SystemConfig(
        camera=config.CameraConfig(),
        orb=config.OrbConfig(**({} if full else TEST_ORB)),
        map=config.MapConfig(**TEST_MAP),
        tracking=config.TrackingConfig(max_frames_between_kf=6,
                                       reset_if_lost_with_kfs_below=2),
        sensor="monocular")


def host_flow_config(config, full=True):
    """[15c]'s SystemConfig: the flow check with its default 1000 points,
    in ``SystemConfig()`` or in the test's dyn_config."""
    dyn = config.DynamicConfig(motion_check="flow")
    if full:
        return config.SystemConfig(dynamic=dyn)
    return config.SystemConfig(
        camera=config.CameraConfig(), orb=config.OrbConfig(**TEST_ORB),
        map=config.MapConfig(**TEST_MAP),
        tracking=config.TrackingConfig(max_frames_between_kf=10),
        dynamic=dyn, use_dynamic_filtering=True)


def pose_centres(poses):
    """Camera centres [n, 3] of world-to-camera poses (either package)."""
    return np.asarray([-np.asarray(p.R).T @ np.asarray(p.t) for p in poses])


def host_stereo_frames(render, poses, cam, asarray):
    """[15a]'s (left, right) greys from ``render(pose) -> grey``: the right
    camera is the left one moved by the baseline along its x axis."""
    shift = np.asarray([cam.baseline, 0.0, 0.0], np.float32)
    return [(render(p), render(p._replace(t=asarray(np.asarray(p.t)
                                                    - shift))))
            for p in poses]


def host_flow_frames(render, poses):
    """[15c]'s (grey, depth, boxes [1, 4] numpy) frames from
    ``render(pose, i) -> (grey, depth, box)``: boxes on the host, as a
    detector's output reaches the System."""
    frames = []
    for i, p in enumerate(poses):
        g, d, box = render(p, i)
        box = box.cpu() if hasattr(box, "cpu") else box
        frames.append((g, d, np.asarray(box, np.float32)[None]))
    return frames


def traj_ate(ate, traj, gt, first=0, with_scale=False):
    """ATE of a System's trajectory records from frame ``first`` on
    against the true centres ``gt``."""
    est = np.asarray([-R.T @ t for _, R, t in traj])[first:]
    m = min(len(est), len(gt) - first)
    stamps = np.arange(first, first + m) / 30.0
    return float(ate.ate_rmse(stamps, est[:m], stamps, gt[first:first + m],
                              with_scale=with_scale)["rmse"])


def run_host_stereo(sysm, frames):
    """Drive [15a]; the states."""
    states = [sysm.track_stereo(gl, gr, stamp=i / 30.0)[0]
              for i, (gl, gr) in enumerate(frames)]
    sysm.shutdown()
    return states


def host_stereo_summary(sysm, states, gt, ate):
    """[15a]'s gates' numbers."""
    return {"n": len(states), "first": states[0],
            "not_ok": len(states) - states.count("OK"),
            "ate_m": traj_ate(ate, sysm.tracker.trajectory, gt),
            "n_kf": int(len(sysm.map.valid_keyframes())),
            "live_points": int(len(sysm.map.valid_points()))}


def host_stereo_failures(s):
    bad = []
    if s["first"] != "OK" or s["not_ok"] > HOST_STEREO_MAX_NOT_OK:
        bad.append(f"frame 0 {s['first']}, {s['not_ok']} frames not OK")
    if not s["ate_m"] < HOST_STEREO_ATE_LIMIT_M:
        bad.append(f"ATE {s['ate_m']} m")
    return bad


def run_host_mono(sysm, frames, black, gt, ate, ret=HOST_MONO_RETURN,
                  before_return=None):
    """Drive [15b] (or [21]): the tracked frames, the black ones, then
    frame ``ret`` again (``before_return()``, when given, is called just
    before it); the gates' numbers (tests/test_monocular.py's:
    over the tracked frames the first OK, the frames lost after it, the
    live points and the Sim3 ATE from the first OK on; then the state
    after the blackout and on the return, with the return's camera centre
    against the one the System had on that frame)."""
    states = [sysm.track_monocular(g, stamp=i / 30.0)[0]
              for i, g in enumerate(frames)]
    n = len(states)
    first = states.index("OK") if "OK" in states else n
    out = {"n": n, "first_ok": first,
           "lost_after": (n - first) - states[first:].count("OK"),
           "last": states[-1],
           "live_points": int(len(sysm.map.valid_points())),
           "n_kf": int(len(sysm.map.valid_keyframes())),
           "ate_sim3_m": traj_ate(ate, sysm.tracker.trajectory, gt, first,
                                  with_scale=True) if n - first >= 3
           else float("nan")}
    for j in range(HOST_MONO_BLACK):
        sysm.track_monocular(black, stamp=(n + j) / 30.0)
    out["after_black"] = sysm.get_tracking_state()
    if before_return is not None:
        before_return()
    t0 = time.perf_counter()
    state, k = sysm.track_monocular(frames[ret],
                                    stamp=(n + HOST_MONO_BLACK + 1) / 30.0)
    out.update(return_state=state, return_inliers=int(k),
               return_ms=(time.perf_counter() - t0) * 1e3)
    _, R0, t0_ = sysm.tracker.trajectory[ret]
    st = sysm.tracker.state
    out["return_err_m"] = float(np.linalg.norm(
        -st.pose_R.T @ st.pose_t + np.asarray(R0).T @ np.asarray(t0_)))
    return out


def host_mono_failures(s):
    bad = []
    d = s.get("direct_epnp")
    if d is not None and not (d["ok"] and d["branch"] == "epnp"
                              and d["centre_err_m"]
                              < HOST_MONO_RETURN_LIMIT_M):
        bad.append(f"the Relocalizer on the return frame: {d}")
    if s["first_ok"] > HOST_MONO_FIRST_OK_MAX \
            or s["lost_after"] > HOST_MONO_MAX_LOST_AFTER \
            or s["last"] != "OK":
        bad.append(f"first OK {s['first_ok']}, lost after it "
                   f"{s['lost_after']}, last {s['last']}")
    if s["live_points"] <= HOST_MONO_MIN_POINTS or s["n_kf"] < 2:
        bad.append(f"{s['live_points']} live points, {s['n_kf']} keyframes")
    if not s["ate_sim3_m"] < HOST_MONO_ATE_LIMIT_M:
        bad.append(f"Sim3 ATE {s['ate_sim3_m']} m")
    if s["after_black"] != "LOST" or s["return_state"] != "OK" \
            or not s["return_err_m"] < HOST_MONO_RETURN_LIMIT_M:
        bad.append(f"after the blackout {s['after_black']}, return "
                   f"{s['return_state']} off by {s['return_err_m']} m")
    return bad


def host_epnp_frames(synthetic, cam, device=None):
    """[21]'s grey frames (the port's renderer, on ``device``) and their
    true camera centres."""
    planes = synthetic.make_room(seed=0, device=device)
    poses = synthetic.camera_trajectory(**HOST_EPNP_ORBIT)[:HOST_EPNP_TRACK]
    return [synthetic.render(cam, p, planes)[0] for p in poses], \
        pose_centres(poses)


def host_mono_frame_of(k, n, ret):
    """The scene frame behind run_host_mono's k-th stamp (k / 30 s) for
    ``n`` tracked frames and the return frame ``ret``."""
    if k < n:
        return k
    if k == n + HOST_MONO_BLACK + 1:
        return ret
    raise ValueError(f"stamp {k} is a black frame")


def host_epnp_failures(s):
    """[21]'s gates on a run_host_mono result whose ``return_reloc`` lists
    the return frame's relocalize calls (``reloc_calls``) and
    ``return_pnp`` counts its EPnP RANSACs: [15b]'s gates, and the return
    taken by the Relocalizer through EPnP."""
    bad = host_mono_failures(s)
    calls = s["return_reloc"]
    if not (s["return_pnp"] >= 1 and calls and calls[-1]["ok"]
            and calls[-1]["branch"] == "epnp"):
        bad.append(f"the return not recovered through EPnP: "
                   f"{s['return_pnp']} EPnP RANSACs, calls {calls}")
    return bad


def drift_late_keyframes(m, scale, yaw, shift, n_moved):
    """Move the ``n_moved`` newest keyframes of a map arena (either
    package's, numpy) by the world similarity X -> c + scale * R_y(yaw)
    (X - c) + d, c their mean centre and d ``shift`` times the keyframes'
    extent along x: each keeps its orientation relative to the moved world
    and sees its points at ``scale`` times their depth, so its
    observations stay exact. A point that an older keyframe also observes
    is copied for the moved keyframes (older keyframes' slots that still
    name a copy's recycled id, a removed point's, are cleared). Returns
    (the moved keyframes, the copies' ids)."""
    kfs = m.valid_keyframes()
    order = kfs[np.argsort(m.kf_seq[kfs])]
    moved = [int(k) for k in order[-n_moved:]]
    early = [int(k) for k in order[:-n_moved]]
    centres = np.asarray([-m.kf_R[k].T @ m.kf_t[k] for k in kfs])
    c = centres[[list(kfs).index(k) for k in moved]].mean(0)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rd = np.asarray([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    d = np.asarray([shift * np.ptp(centres[:, 0]), 0.0, 0.0])
    td = c + d - scale * Rd @ c

    def sim(X):
        return (scale * X @ Rd.T + td).astype(np.float32)

    seen_early = np.zeros(m.pt_pos.shape[0], bool)
    for k in early:
        o = m.kf_obs_pt[k]
        seen_early[o[o >= 0]] = True
    pids = np.unique(np.concatenate([m.kf_obs_pt[k][m.kf_obs_pt[k] >= 0]
                                     for k in moved]))
    shared = pids[seen_early[pids]]
    own = pids[~seen_early[pids]]
    copies = m.add_points(
        sim(m.pt_pos[shared]), m.pt_desc[shared], moved[0],
        normals=m.pt_normal[shared] @ Rd.T,
        min_dists=scale * m.pt_min_dist[shared],
        max_dists=scale * m.pt_max_dist[shared], angles=m.pt_angle[shared])
    # A keyframe slot may still name a removed point's id, which add_points
    # recycles: clear such slots in the other keyframes, so each copy is
    # seen by the moved keyframes alone.
    n = m.n_kf
    stale = np.isin(m.kf_obs_pt[:n], copies)
    stale[moved] = False
    m.kf_obs_pt[:n][stale] = -1
    to_copy = dict(zip(shared.tolist(), copies.tolist()))
    m.pt_pos[own] = sim(m.pt_pos[own])
    m.pt_normal[own] = m.pt_normal[own] @ Rd.T
    m.pt_min_dist[own] *= scale
    m.pt_max_dist[own] *= scale
    m.mark_points_dirty(np.concatenate([own, copies]))
    for k in moved:
        R = m.kf_R[k] @ Rd.T
        m.set_keyframe_pose(k, R, scale * m.kf_t[k] - R @ td)
        for slot in np.nonzero(m.kf_obs_pt[k] >= 0)[0]:
            p = int(m.kf_obs_pt[k, slot])
            if p in to_copy:
                m._remove_observation(p, k)
                m.kf_obs_pt[k, slot] = to_copy[p]
                m._add_observation(to_copy[p], k, int(slot))
    for k in set(moved) | set(np.nonzero(stale.any(1))[0].tolist()):
        m.update_covisibility(int(k))
    m.bump()
    return moved, copies


def keyframe_ate(ate, m, gt_of_kf):
    """Sim3-aligned ATE of a map's keyframe centres against
    ``gt_of_kf(k)``, the true centre of keyframe k."""
    kfs = m.valid_keyframes()
    est = np.asarray([-m.kf_R[k].T @ m.kf_t[k] for k in kfs])
    gt = np.asarray([gt_of_kf(int(k)) for k in kfs])
    stamps = np.arange(len(kfs), dtype=np.float64)
    return float(ate.ate_rmse(stamps, est, stamps, gt,
                              with_scale=True)["rmse"])


def close_drifted_loop(lc, m):
    """[20]'s closure on a drifted map: the newest keyframe against the
    oldest, through the loop closer ``lc`` (either package's):
    compute_sim3 and, when it accepts, correct. Returns the pair, whether
    it was accepted, the corrected Sim3 and its scale (S12's) and the
    compute_sim3 gates' record."""
    kfs = m.valid_keyframes()
    order = kfs[np.argsort(m.kf_seq[kfs])]
    kf, cand = int(order[-1]), int(order[0])
    ok, S = lc.compute_sim3(kf, cand)
    out = {"pair": [kf, cand], "accepted": bool(ok),
           "debug": dict(lc.last_debug)}
    if ok:
        out.update(S=S, scale=float(S.s))
        lc.correct(kf, cand, S)
        lc.n_loops_closed += 1
    return out


def run_mono_loop(sysm, ate, gt_of_kf, around=None):
    """[20] on a System (either package's) that ran [21]'s scene: the
    keyframe Sim3 ATE (``gt_of_kf(k)`` the true centre of keyframe k), the
    map drifted (``drift_late_keyframes``) and its ATE, the closure
    (``close_drifted_loop``, inside the context ``around()`` when given)
    and its seconds, and the ATE after it."""
    lc, m = sysm.loop_closer, sysm.map
    before = keyframe_ate(ate, m, gt_of_kf)
    moved, copies = drift_late_keyframes(m, **HOST_MONO_LOOP_DRIFT)
    drifted = keyframe_ate(ate, m, gt_of_kf)
    with around() if around is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        out = close_drifted_loop(lc, m)
        secs = time.perf_counter() - t0
    out.update(close_s=secs, before_m=before, drifted_m=drifted,
               after_m=keyframe_ate(ate, m, gt_of_kf), moved=moved,
               n_copies=len(copies), n_kf=int(len(m.valid_keyframes())))
    return out


def run_host_flow(sysm, frames):
    """Drive [15c]; the states."""
    states = [sysm.track_rgbd(g, d, stamp=i / 30.0, boxes=b)[0]
              for i, (g, d, b) in enumerate(frames)]
    sysm.shutdown()
    return states


def host_flow_summary(sysm, states, gt, ate, walker_frames):
    """[15c]'s gates' numbers; ``walker_frames``: the frames on which the
    walker's box was classified dynamic."""
    return {"n": len(states), "ok": states.count("OK"),
            "lost": states.count("LOST"),
            "ate_m": traj_ate(ate, sysm.tracker.trajectory, gt),
            "walker_dynamic_frames": list(walker_frames),
            "n_kf": int(len(sysm.map.valid_keyframes())),
            "live_points": int(len(sysm.map.valid_points()))}


def host_flow_failures(s):
    bad = []
    if s["lost"] > HOST_FLOW_MAX_LOST or not s["ate_m"] < \
            HOST_FLOW_ATE_LIMIT_M:
        bad.append(f"{s['lost']} frames lost, ATE {s['ate_m']} m")
    if not s["walker_dynamic_frames"]:
        bad.append("the walker's box never classified dynamic")
    return bad

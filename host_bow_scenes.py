"""The scenes of the host path's BoW half and the helpers that measure
them, shared by ``chip_smoke.py`` ([14]), ``cpu_reference.py``
(``host-loop``, ``host-reloc``) and the port's tests.

[14a] is tests/test_loop_e2e.py's circuit and [14b]
tests/test_vocabulary.py::TestRelocalizationE2E's blackout, each at its
test's configuration; ``host_loop_config`` and ``host_reloc_config`` build
either package's ``SystemConfig`` from its ``config`` module. The
``run_*`` functions drive a ``System(vocabulary=)`` of either package, the
``*_summary`` and ``*_failures`` functions give the gates' numbers and the
failed gates, and ``watch_calls`` times the loop closer's and the
relocalizer's stages, with the host syncs that the CUDA sync-debug mode
reports inside each.
"""
import os
import time
import warnings

import numpy as np

# [14a]: host loop closing, System(vocabulary=) on tests/test_loop_e2e.py's
# circuit and configuration, with the scene's own vocabulary. Its ORB is
# the test's 1024-keypoint, 4-level cut: at OrbConfig()'s full width the
# JAX package itself misses the test's ATE gate on the CPU
# (cpu_reference.py jax host-loop-full: it closes the loop on frame 102,
# but the ATE goes from 6.45 cm before the closure to 6.28 cm after), so
# the cut is kept for both packages.
HOST_LOOP_ORB = dict(max_keypoints=1024, n_levels=4, n_features=1000)
HOST_LOOP_TRACKING = dict(max_frames_between_kf=4,
                          max_translation_per_frame=0.5)
HOST_LOOP_MAP = dict(max_keyframes=128, max_points=32768)
HOST_LOOP_LOOP = dict(min_score_factor=0.7, min_total_matches=30)
HOST_LOOP_VOCAB_FRAMES = range(0, 96, 12)     # every 12th circuit frame
HOST_LOOP_VOCAB = dict(n_desc=6000, branching=8, depth=3, seed=0)
HOST_LOOP_FIRST_MIN = 76         # N_CIRCUIT - 20
HOST_LOOP_PRE_ATE_MIN_M = 0.02   # the drift must be real
HOST_LOOP_GAIN = 0.8             # exported ATE < 0.8 x the pre-closure ATE
# [14b]: host relocalization after a blackout
# (tests/test_vocabulary.py::TestRelocalizationE2E), with the test's ORB
# cut: at full width the JAX package makes 5 keyframes before the
# blackout, so its System resets instead of relocalizing
# (cpu_reference.py jax host-reloc-full).
HOST_RELOC_ORB = dict(max_keypoints=1024, n_levels=4, n_features=800)
HOST_RELOC_MAP = dict(max_keyframes=64, max_points=16384)
HOST_RELOC_ORBIT = dict(n_frames=30, radius=0.35)
HOST_RELOC_TRACK = 12            # frames tracked before the blackout
HOST_RELOC_BLACK = 3             # black frames with flat depth
HOST_RELOC_RETURN = 8            # the frame shown again after them
HOST_RELOC_VOCAB_FRAMES = range(0, 30, 4)     # every 4th orbit frame
HOST_RELOC_VOCAB = dict(n_desc=4000, branching=8, depth=3, seed=0)
HOST_RELOC_LIMIT_M = 0.1
# [14b]'s standalone RANSAC EPnP at the relocalizer's shapes, and its
# tolerance card against CPU: cuSOLVER's float32 eigh of the 12x12 M^T M
# gives the pose to 2.4e-5 (R) and 1.06e-4 (t) of LAPACK's on this scene
# (the port and the JAX package agree to 6.6e-6 on the CPU).
EPNP_SHAPE = dict(n_hypotheses=300, sample=6, n=2048)
EPNP_CARD_TOL = 1e-3


def sync_sites(caught):
    """Host synchronisations among caught warnings, counted by source
    line."""
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.basename(w.filename)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return sites


def host_loop_config(config, full=False):
    """[14a]'s SystemConfig from either package's config module; with
    ``full``, at OrbConfig()'s full width instead of the test's cut."""
    return config.SystemConfig(
        camera=config.CameraConfig(),
        orb=config.OrbConfig(**({} if full else HOST_LOOP_ORB)),
        map=config.MapConfig(**HOST_LOOP_MAP),
        tracking=config.TrackingConfig(**HOST_LOOP_TRACKING),
        loop=config.LoopConfig(**HOST_LOOP_LOOP),
        use_dynamic_filtering=False)


def host_reloc_config(config, full=False):
    """[14b]'s SystemConfig from either package's config module; with
    ``full``, at OrbConfig()'s full width instead of the test's cut."""
    return config.SystemConfig(
        camera=config.CameraConfig(),
        orb=config.OrbConfig(**({} if full else HOST_RELOC_ORB)),
        map=config.MapConfig(**HOST_RELOC_MAP),
        tracking=config.TrackingConfig(max_frames_between_kf=10))


def scene_vocabulary(voc_mod, descs, n_desc, **train):
    """A scene's own vocabulary, trained as the tests train it: the valid
    descriptors of its vocabulary frames ([N, 32] uint8 arrays, one per
    frame), concatenated, the first ``n_desc``."""
    return voc_mod.train(np.concatenate(descs)[:n_desc], **train)


def run_host_loop(sysm, frames):
    """Drive [14a]: track ``frames`` (grey, biased depth) at 30 fps stamps.
    Returns (states, the trajectory as it stood before the first closure,
    the frame that closed it or None)."""
    states, pre, closed_at = [], None, None
    for i, (g, d) in enumerate(frames):
        states.append(sysm.track_rgbd(g, d, stamp=i / 30.0)[0])
        if closed_at is None and sysm.loop_closer.n_loops_closed > 0:
            closed_at = i
        if closed_at is None:
            pre = [(s, R.copy(), t.copy()) for s, R, t
                   in sysm.tracker.trajectory]
    sysm.shutdown()
    return states, pre, closed_at


def _traj_ate(ate, traj, gt):
    est = np.asarray([-R.T @ t for _, R, t in traj])
    m = min(len(est), len(gt))
    stamps = np.arange(m) / 30.0
    return float(ate.ate_rmse(stamps, est[:m], stamps, gt[:m])["rmse"])


def host_loop_summary(sysm, states, pre, closed_at, gt, ate):
    """[14a]'s gates' numbers (tests/test_loop_e2e.py): loops closed and
    the first closing frame, the loop edges, the fused edges, the ATE of
    the trajectory before the first closure and of the exported one."""
    lc = sysm.loop_closer
    return {"ok": states.count("OK"), "n": len(states),
            "loops": int(lc.n_loops_closed), "closed_at": closed_at,
            "loop_edges": [[int(a), int(b)] for a, b in lc.loop_edges],
            "fused_edges": len(getattr(lc, "_fused_edges", [])),
            "ate_pre_m": _traj_ate(ate, pre, gt) if pre else None,
            "ate_post_m": _traj_ate(ate, sysm.tracker.export_trajectory(),
                                    gt),
            "n_kf": int(len(sysm.map.valid_keyframes()))}


def host_loop_failures(s):
    """[14a]'s gates on a host_loop_summary; the failed ones."""
    bad = []
    if s["loops"] < 1 or s["closed_at"] is None \
            or s["closed_at"] < HOST_LOOP_FIRST_MIN:
        bad.append(f"loops {s['loops']}, first at frame {s['closed_at']}")
    if s["ate_pre_m"] is None or not s["ate_pre_m"] > HOST_LOOP_PRE_ATE_MIN_M:
        bad.append(f"pre-closure ATE {s['ate_pre_m']} m")
    elif not s["ate_post_m"] < HOST_LOOP_GAIN * s["ate_pre_m"]:
        bad.append(f"exported ATE {s['ate_post_m']} m, pre-closure "
                   f"{s['ate_pre_m']} m")
    if s["fused_edges"] < 1:
        bad.append("no fused edge")
    return bad


def run_host_reloc(sysm, frames, black, Rg, tg):
    """Drive [14b]: track the first HOST_RELOC_TRACK frames, then
    HOST_RELOC_BLACK black ones (``black`` = (grey, flat depth)), then frame
    HOST_RELOC_RETURN again. ``Rg``, ``tg``: that frame's true pose in the
    first frame's camera frame. Returns the gates' numbers."""
    for i in range(HOST_RELOC_TRACK):
        g, d = frames[i]
        sysm.track_rgbd(g, d, stamp=i / 30.0)
    before = sysm.get_tracking_state()
    n_kf = int(len(sysm.map.valid_keyframes()))
    for j in range(HOST_RELOC_BLACK):
        sysm.track_rgbd(*black, stamp=(HOST_RELOC_TRACK + j) / 30.0)
    lost = sysm.get_tracking_state()
    g, d = frames[HOST_RELOC_RETURN]
    t0 = time.perf_counter()
    state, n = sysm.track_rgbd(
        g, d, stamp=(HOST_RELOC_TRACK + HOST_RELOC_BLACK + 1) / 30.0)
    ms = (time.perf_counter() - t0) * 1e3
    st = sysm.tracker.state
    c_now = -st.pose_R.T @ st.pose_t
    c_gt = -Rg.T @ tg
    return {"before": before, "n_kf_before": n_kf, "after_black": lost,
            "return": state, "n_inliers": int(n),
            "centre_err_m": float(np.linalg.norm(c_now - c_gt)),
            "return_ms": ms}


def depth_free_frames(torch, frame_mod, sysm, cfg, g, d):
    """A frame through the port's RGB-D front-end on the System's device,
    its depth-free copy (no depth, no virtual right coordinate: the
    relocalizer takes its EPnP branch) and its words."""
    up = sysm.tracker._up
    fd = frame_mod.process_rgbd(up(g, torch.float32), up(d, torch.float32),
                                cfg.camera, cfg.orb)
    flat = fd._replace(
        depth=torch.zeros_like(fd.depth), ur=torch.full_like(fd.ur, -1.0),
        obs=torch.cat([fd.obs[:, :2], torch.full_like(fd.obs[:, 2:], -1.0)],
                      1))
    return fd, flat, sysm._words(fd.feats.desc, fd.feats.valid)


def reloc_direct(sysm, fd, words, Rg, tg):
    """One call of the System's Relocalizer on the frame ``fd`` (its
    words given) against the tracked map: ok, inliers, host ms and the
    camera centre's error against the true pose (Rg, tg)."""
    t0 = time.perf_counter()
    rr = sysm.relocalizer.relocalize(fd, words)
    ms = (time.perf_counter() - t0) * 1e3
    err = None
    if rr.ok:
        err = float(np.linalg.norm(-rr.R.T @ rr.t + Rg.T @ tg))
    return {"ok": bool(rr.ok), "n_inliers": int(rr.n_inliers), "ms": ms,
            "centre_err_m": err}


def host_reloc_failures(s, min_kf):
    """[14b]'s gates on a run_host_reloc result; the failed ones."""
    bad = []
    if s["before"] != "OK" or s["n_kf_before"] < min_kf:
        bad.append(f"before the blackout {s['before']}, "
                   f"{s['n_kf_before']} keyframes")
    if s["after_black"] != "LOST":
        bad.append(f"after the blackout {s['after_black']}")
    if s["return"] != "OK" or not s["centre_err_m"] < HOST_RELOC_LIMIT_M:
        bad.append(f"return {s['return']}, centre off by "
                   f"{s['centre_err_m']} m")
    for branch in ("horn", "epnp"):
        d = s.get(f"direct_{branch}")
        if d is not None and not (d["ok"] and d["centre_err_m"]
                                  < HOST_RELOC_LIMIT_M):
            bad.append(f"direct relocalization ({branch}): {d}")
    return bad


def watch_calls(rec, obj, names):
    """Wrap the methods ``names`` of ``obj`` (either package's): each call
    appends (name, host ms, host sync sites, result) to ``rec``. The syncs
    are those the CUDA sync-debug mode reports inside the call (none on the
    CPU); they are passed on to an enclosing ``count_host_syncs``."""
    for name in names:
        fn = getattr(obj, name)

        def watched(*a, _fn=fn, _name=name, **kw):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                ms = (time.perf_counter() - t0) * 1e3
            for w in caught:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
            rec.append((_name, ms, sync_sites(caught), out))
            return out

        setattr(obj, name, watched)
    return rec


def closure_stages(rec):
    """Host ms and host syncs of each loop closure's stages from a
    ``watch_calls`` record of compute_sim3, correct, run_pose_graph and the
    global BA's run: one dict per accepted closure (correct's own work
    without the pose graph and the global BA)."""
    out, cur = [], None
    for name, ms, sites, res in rec:
        n = sum(sites.values())
        if name == "compute_sim3":
            cur = {"compute_sim3_ms": ms, "compute_sim3_syncs": n,
                   "accepted": bool(res[0])}
            if cur["accepted"]:
                out.append(cur)
        elif cur is not None and cur["accepted"]:
            key = {"run_pose_graph": "pose_graph", "run": "global_ba",
                   "correct": "correct"}[name]
            cur[f"{key}_ms"], cur[f"{key}_syncs"] = ms, n
            if name == "correct":
                cur["sites"] = sites
    for c in out:
        for k in ("ms", "syncs"):
            c[f"correct_own_{k}"] = c.get(f"correct_{k}", 0) - c.get(
                f"pose_graph_{k}", 0) - c.get(f"global_ba_{k}", 0)
    return out


def pnp_scene(cam, seed, n, noise_px=0.0, outlier_frac=0.0):
    """tests/test_pnp.py's scene (numpy): n world points in front of a
    random pose (R, t), their pixels with noise and a share of uniform
    outliers in the first rows. Returns float32 (X, uv) and float64 (R, t)."""
    rng = np.random.RandomState(seed)
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    ang = 0.4 * rng.rand()
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
    t = 0.3 * rng.randn(3)
    z = 1.0 + 3.0 * rng.rand(n)
    u = rng.uniform(40, cam.width - 40, n)
    v = rng.uniform(40, cam.height - 40, n)
    pc = np.stack([(u - cam.cx) * z / cam.fx, (v - cam.cy) * z / cam.fy,
                   z], -1)
    X = (pc - t) @ R
    uv = np.stack([u, v], -1) + noise_px * rng.randn(n, 2)
    n_out = int(outlier_frac * n)
    if n_out:
        uv[:n_out] = rng.uniform(0, cam.width, (n_out, 2))
    return X.astype(np.float32), uv.astype(np.float32), R, t


#: The Relocalizer's attempt methods in each package: (depth, depth-free).
RELOC_ATTEMPTS = {"jax": ("_jit_attempt", "_jit_attempt_pnp"),
                  "port": ("_attempt", "_attempt_pnp")}


def reloc_calls(rec):
    """Each relocalize call of a ``watch_calls`` record of the
    Relocalizer's attempts and ``relocalize``: ok, inliers, host ms and
    syncs, the candidates tried and the branch (Horn or EPnP)."""
    out, tried = [], []
    for name, ms, sites, res in rec:
        if name != "relocalize":
            tried.append(name)
            continue
        out.append({"ok": bool(res.ok), "n_inliers": int(res.n_inliers),
                    "ms": ms, "syncs": sum(sites.values()), "sites": sites,
                    "candidates_tried": len(tried),
                    "branch": ("epnp" if any("pnp" in n for n in tried)
                               else "horn") if tried else None})
        tried = []
    return out


def reloc_truth(R0, t0, R, t):
    """A pose (R, t) in the camera frame of the pose (R0, t0)."""
    Rg = R @ R0.T
    return Rg, t - Rg @ t0

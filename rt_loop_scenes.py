"""The realtime maintenance program's loop-circuit scenes and the helpers
that measure them, shared by ``chip_smoke.py`` ([6], [7], [19]),
``cpu_reference.py`` (``circuit``, ``kidnap``, ``rt-bank-loop``,
``rt-bank-reloc``), ``profile_maintenance.py`` and the port's tests.

The scene is tests/test_loop_e2e.py's drifted circuit (the six-wall room,
a 1 m circle of N_CIRCUIT frames and N_OVERLAP more past its start, depth
x DEPTH_BIAS) under tests/test_realtime_loop.py's configuration
(``circuit_config``, ``CIRCUIT_LIMITS``). The place-bank scenes are
tests/test_place_bank.py's: the same circuit with an 8-row keyframe ring
(``BANK_LIMITS``), so every place of the circuit's start is evicted about
three ring generations before the camera returns and only the bank can
recognise it:

* (a) ``bank loop``: the whole circuit with maintenance every frame and
  its odometry twin (no vocabulary);
* (b) ``bank reloc``: the first half of the circuit, BANK_RELOC_BLACK
  black frames, then BANK_RELOC_REVISIT again.

Each function takes the package's modules or classes it needs, so it
drives either package; the ``*_summary`` functions give the gates'
numbers (tests/test_place_bank.py's, the same in
tests/test_torch_realtime_loop.py) and ``*_failures`` the failed gates.
"""
import numpy as np

# The loop circuit's configuration (bench.py run_loop_event), for either
# package's config module (circuit_config) and RTLimits (**CIRCUIT_LIMITS).
CIRCUIT_ORB = dict(max_keypoints=1024, n_levels=4, n_features=1000)
CIRCUIT_TRACKING = dict(max_frames_between_kf=4,
                        max_translation_per_frame=0.5)
CIRCUIT_LIMITS = dict(max_kf=64, spawn_per_kf=256, ba_window=6,
                      local_window=6, max_frames=256)
#: Ring of 8 rows vs ~27 keyframes/circuit: wraps >= 3x per lap.
BANK_LIMITS = dict(max_kf=8, spawn_per_kf=256, ba_window=4, local_window=4,
                   max_frames=256, bank_cap=64, bank_words=64,
                   bank_landmarks=128, seed_slots=256)
# The scene vocabulary: every 12th circuit frame's descriptors, the first
# 6000, branching 8, depth 3 (tests/test_place_bank.py).
BANK_VOCAB_EVERY = 12
BANK_VOCAB = dict(n_desc=6000, branching=8, depth=3, seed=0)
BANK_RELOC_BLACK = 8
BANK_RELOC_REVISIT = range(6, 16)
# The gates.
BANK_GAP_GAIN = 0.6              # revisit gap < 0.6 x the odometry's
BANK_ATE_GAIN, BANK_ATE_SLACK_M = 1.1, 0.005
BANK_RELOC_MAX_LOST = 2          # of the revisit frames
BANK_RELOC_LIMIT_M = 0.30        # median centre error of the revisit


def circuit_config(config):
    """The loop circuit's SystemConfig from ``config``, either package's
    config module."""
    return config.SystemConfig(
        camera=config.CameraConfig(), orb=config.OrbConfig(**CIRCUIT_ORB),
        tracking=config.TrackingConfig(**CIRCUIT_TRACKING),
        use_dynamic_filtering=False)


def loop_scene(device, sched, bias, synthetic, cam):
    """Frames ``sched`` of the circuit (grey, depth x ``bias``) rendered by
    the port on ``device``, and their ground-truth camera centres."""
    planes = synthetic.six_wall_room(device=device)
    poses = synthetic.circuit_poses(max(sched) + 1)
    frames = []
    for i in sched:
        g, d = synthetic.render(cam, poses[i], planes)[:2]
        frames.append((g, d * bias))
    gt = np.asarray([-poses[i].R.numpy().T @ poses[i].t.numpy()
                     for i in sched])
    return frames, gt


def bank_vocab_frames(n_circuit):
    """The circuit frames the bank scenes' vocabulary is trained on."""
    return range(0, n_circuit, BANK_VOCAB_EVERY)


def centres(res):
    """Camera centres of a ``finish()`` result's poses."""
    return np.asarray([-R.T @ t for R, t in zip(res["R"], res["t"])])


def run_realtime(rt, frames):
    """Track ``frames`` (grey, depth) at 30 fps stamps; ``finish()``."""
    for i, (g, d) in enumerate(frames):
        rt.track(g, d, stamp=i / 30.0)
    rt.block()
    return rt.finish()


def bank_loop_summary(res, res_odo, gt, n_circuit, n_overlap, ate):
    """(a)'s gates' numbers: keyframes made, bank entries, bank closures,
    the applied events' keyframe gaps, the revisit gap (the overlap frames'
    mean distance to their first-lap twins) of the session and of its
    odometry twin, and both ATEs."""
    c_loop, c_odo = centres(res), centres(res_odo)
    stamps = np.arange(len(gt)) / 30.0
    applied = [e for e in res["loop_events"] if e["applied"]]
    return {
        "n": len(res["ok"]), "ok": int(res["ok"].sum()),
        "n_kf": int(res["n_kf"]), "bank_entries": int(res["bank_entries"]),
        "n_bank_loops": int(res["n_bank_loops"]),
        "n_loops_closed": int(res["n_loops_closed"]),
        "applied_gaps": [int(e["lid"] - e["cand_lid"]) for e in applied],
        "gap_m": float(np.linalg.norm(
            c_loop[n_circuit:] - c_loop[:n_overlap], axis=1).mean()),
        "gap_odo_m": float(np.linalg.norm(
            c_odo[n_circuit:] - c_odo[:n_overlap], axis=1).mean()),
        "ate_m": float(ate.ate_rmse(res["stamps"], c_loop, stamps,
                                    gt)["rmse"]),
        "ate_odo_m": float(ate.ate_rmse(res_odo["stamps"], c_odo, stamps,
                                        gt)["rmse"])}


def bank_loop_failures(s, max_kf):
    bad = []
    if s["n_kf"] < 3 * max_kf:
        bad.append(f"ring only wrapped {s['n_kf']}/{max_kf} rows")
    if s["bank_entries"] <= max_kf:
        bad.append(f"{s['bank_entries']} bank entries")
    if s["n_bank_loops"] < 1 or not any(g > max_kf
                                        for g in s["applied_gaps"]):
        bad.append(f"{s['n_bank_loops']} bank closures, applied gaps "
                   f"{s['applied_gaps']}")
    if not s["gap_m"] < BANK_GAP_GAIN * s["gap_odo_m"]:
        bad.append(f"revisit gap {s['gap_m']} m, odometry {s['gap_odo_m']}")
    if not s["ate_m"] <= s["ate_odo_m"] * BANK_ATE_GAIN + BANK_ATE_SLACK_M:
        bad.append(f"ATE {s['ate_m']} m, odometry {s['ate_odo_m']} m")
    return bad


def run_bank_reloc(rt, frames, black, n_half):
    """(b): track the first ``n_half`` frames, BANK_RELOC_BLACK black ones
    (``black`` = (grey, depth)), then BANK_RELOC_REVISIT again; ``finish()``."""
    for i in range(n_half):
        rt.track(frames[i][0], frames[i][1], stamp=i / 30.0)
    for k in range(BANK_RELOC_BLACK):
        rt.track(*black, stamp=(n_half + k) / 30.0)
    for j, i in enumerate(BANK_RELOC_REVISIT):
        rt.track(frames[i][0], frames[i][1],
                 stamp=(n_half + BANK_RELOC_BLACK + j) / 30.0)
    rt.block()
    return rt.finish()


def bank_reloc_summary(res):
    """(b)'s gates' numbers: bank relocalizations, the revisit frames
    tracked, and the revisit's camera centres against the ones the session
    gave the same frames before (no alignment: the same map frame)."""
    revisit = list(BANK_RELOC_REVISIT)
    c = centres(res)
    err = np.linalg.norm(c[-len(revisit):] - c[revisit], axis=1)
    return {"n": len(res["ok"]), "n_bank_reloc": int(res["n_bank_reloc"]),
            "n_relocalizations": int(res["n_relocalizations"]),
            "revisit_ok": int(res["ok"][-len(revisit):].sum()),
            "n_revisit": len(revisit),
            "median_err_m": float(np.median(err)),
            "bank_entries": int(res["bank_entries"])}


def bank_reloc_failures(s):
    bad = []
    if s["n_bank_reloc"] < 1:
        bad.append("no bank relocalization applied")
    if s["revisit_ok"] < s["n_revisit"] - BANK_RELOC_MAX_LOST:
        bad.append(f"{s['revisit_ok']} of {s['n_revisit']} revisit frames "
                   f"tracked")
    if not s["median_err_m"] < BANK_RELOC_LIMIT_M:
        bad.append(f"revisit median error {s['median_err_m']} m")
    return bad

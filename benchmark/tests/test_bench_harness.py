"""CPU tests of the benchmark harness.

Run from the repository root: ``python -m pytest benchmark/tests -q``.
The end-to-end cases drive a whole run of a cell on the CPU at a reduced
size (320 x 240, one session, a few frames), the card's look skipped;
the cases marked ``cuda`` run on the card only.
"""
import ast
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.insert(0, ROOT)

from slambench import checks, counts, fleet, reference, spec, stats, traffic  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "coebslam_tpu"}


def _bench():
    return spec.load(ROOT)


def _small(cell):
    """The cell at a size a CPU test run holds: 320 x 240, one session of
    12 frames, the detector at 160^2."""
    c = json.loads(json.dumps(cell))
    cam = c["config"]["camera"]
    for k in ("fx", "fy", "cx", "cy", "bf"):
        cam[k] = cam[k] / 2.0
    cam["width"], cam["height"] = cam["width"] // 2, cam["height"] // 2
    c["config"]["orb"].update(n_features=500, max_keypoints=1024)
    if "detector" in c["config"]:
        c["config"]["detector"]["input_size"] = 160
    c["traffic"].update(sessions=1, frames=12, warmup_frames=3,
                        sample_frames=2)
    if "ate_cm" in c["limits"]:
        # The cell's ATE limit is set for 640 x 480; at half the width the
        # features are coarser (4.14 cm on 12 frames, my CPU run).
        c["limits"]["ate_cm"] = 10.0
    return c


def _mono_small(cell):
    """The RGB-D cell turned into the test copy's monocular configuration
    (``track_mono``, no detector), at ``_small``'s size: long enough that
    the two-view initialisation falls in the warm-up and keyframes in the
    window. Its limits are the RGB-D cell's with the spawn mismatch."""
    c = _small(cell)
    c["config"].update(name="mono_tum1", sensor="monocular",
                       detector_enabled=False,
                       entry={"method": "track_mono",
                              "args": ["gray", "stamp", "boxes"]})
    c["traffic"].update(frames=24, warmup_frames=5)
    c["limits"]["spawn_mismatch_pct"] = 2.0
    return c


# ------------------------------------------------------------------ #
# The files resolve, and a new cell needs only new files
# ------------------------------------------------------------------ #

def test_every_cell_config_and_metric_resolves():
    b = _bench()
    names = {m["name"] for m in b["end_to_end"] + b["per_layer"]}
    for w in b["workloads"]:
        c = spec.cell(ROOT, b, w["name"])
        assert c["config"]["name"] == w["config"]
        assert int(c["traffic"]["sessions"]) >= 1
        assert "setup_s" in {m["name"] for m in c["end_to_end"]}
        assert c["per_layer"], w["name"]
        assert set(c["limits"]) >= {"feat_mismatch_pct", "match_mismatch_pct",
                                    "pose_gap_mm", "missing_outputs"}
    for n in names:
        assert callable(spec.reader(n))
    for conf in b["configs"]:
        with open(os.path.join(ROOT, conf["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
        assert cfg["reduced"] == conf["reduced"]
        assert os.path.exists(os.path.join(ROOT, cfg["vocabulary_file"]))


def test_names_units_and_sizes_keep_to_the_contract():
    import re
    b = _bench()
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for m in b["end_to_end"] + b["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert name.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024


def test_a_cell_added_in_a_copy_is_found_without_edits(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    b["workloads"].append({"name": "stereo_euroc.fleet2",
                           "config": "stereo_euroc", "traffic": "fleet2",
                           "chips": 1, "why": "a later cell"})
    for m in b["per_layer"]:
        if "stereo_euroc.fleet" in m.get("workloads", []):
            m["workloads"].append("stereo_euroc.fleet2")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cells = root / "benchmark" / "cells"
    t = json.loads((cells / "stereo_euroc.fleet.json").read_text())
    t["sessions"] = 2
    (cells / "stereo_euroc.fleet2.json").write_text(json.dumps(t))
    shutil.copy(root / "benchmark" / "limits" / "stereo_euroc.fleet.json",
                root / "benchmark" / "limits" / "stereo_euroc.fleet2.json")
    c = spec.cell(str(root), b, "stereo_euroc.fleet2",
                  bench_dir=str(root / "benchmark"))
    assert c["traffic"]["sessions"] == 2
    assert {m["name"] for m in c["per_layer"]} >= {"track_ms", "frame_mfu"}
    # A metric added the same way.
    (root / "benchmark" / "metrics" / "new_metric.py").write_text(
        "def read(run):\n    return 1.5\n")
    assert spec.reader("new_metric", str(root / "benchmark"))(None) == 1.5
    # A configuration on another entry and a traffic mix with its own
    # cadence and depth bias, the same way.
    conf = json.loads((root / "benchmark" / "configs"
                       / "rgbd_tum_walking.json").read_text())
    conf.update(name="mono_tum1", sensor="monocular", detector_enabled=False,
                entry={"method": "track_mono",
                       "args": ["gray", "stamp", "boxes"]})
    (root / "benchmark" / "configs" / "mono_tum1.json").write_text(
        json.dumps(conf))
    b["configs"].append({"name": "mono_tum1", "source": "x",
                         "file": "benchmark/configs/mono_tum1.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "mono_tum1.loop", "config": "mono_tum1",
                           "traffic": "loop", "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    t = json.loads((cells / "rgbd_tum_walking.fleet.json").read_text())
    t.update(maintain_every=1, detect_every=4, depth_scale=1.06)
    (cells / "mono_tum1.loop.json").write_text(json.dumps(t))
    shutil.copy(root / "benchmark" / "limits" / "rgbd_tum_walking.fleet.json",
                root / "benchmark" / "limits" / "mono_tum1.loop.json")
    c = spec.cell(str(root), b, "mono_tum1.loop",
                  bench_dir=str(root / "benchmark"))
    assert c["config"]["entry"]["method"] == "track_mono"
    assert (c["traffic"]["maintain_every"], c["traffic"]["detect_every"],
            c["traffic"]["depth_scale"]) == (1, 4, 1.06)


def test_the_entry_and_spans_come_from_the_configuration():
    from slambench import session
    from coebslam_tpu_torch.slam import frame, realtime
    for w in _bench()["workloads"]:
        cfg = spec.cell(ROOT, _bench(), w["name"])["config"]
        assert hasattr(realtime.RealtimeSlam, cfg["entry"]["method"])
        for label, path in cfg["spans"].items():
            tgt = session.span_target(path, {"detector": "d", "maint": None})
            if path.startswith("maint."):
                assert tgt is None
            elif path.startswith("detector."):
                assert tgt == ("d", path.split(".")[1])
            else:
                assert callable(getattr(*tgt)), path
    assert session.span_target("slam.frame.process_rgbd", {}) == (
        frame, "process_rgbd")
    fr = traffic.Frames(np.zeros((2, 4, 4), np.uint8),
                        np.ones((2, 4, 4), np.uint16),
                        [np.zeros((0, 4), np.float32),
                         np.ones((1, 4), np.float32)], None, None)
    empty = np.zeros((0, 4), np.float32)
    a = session.frame_args(["gray", "stamp", "boxes"], fr, 1, 0.5, empty)
    assert np.shares_memory(a[0], fr.gray[1]) and a[1] == 0.5
    assert a[2] is fr.boxes[1]
    assert session.frame_args(["boxes"], fr, 0, 0.0, empty)[0] is empty


def test_depth_scale_biases_the_depth_images_alone():
    cell = _small(spec.cell(ROOT, _bench(), "rgbd_tum_walking.fleet"))
    a = _frames(cell)
    cell["traffic"]["depth_scale"] = 1.06
    b = _frames(cell)
    assert np.array_equal(a.gray, b.gray) and np.array_equal(a.t_cw, b.t_cw)
    m = a.second > 0
    ratio = b.second[m].astype(np.float64) / a.second[m]
    assert abs(np.median(ratio) - 1.06) < 1e-3


# ------------------------------------------------------------------ #
# Nothing of JAX
# ------------------------------------------------------------------ #

def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    found = {}
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(d, f)
                bad = set(_imports(p)) & FORBIDDEN
                if bad:
                    found[p] = bad
    assert not found
    # The port's name begins with the JAX package's: whole names only.
    assert "coebslam_tpu_torch".split(".")[0] not in FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    for f in ("reference.py", "traffic.py", "counts.py", "stats.py"):
        mods = set(_imports(os.path.join(BENCH, "slambench", f)))
        assert "coebslam_tpu_torch" not in mods, f


def test_a_run_loads_no_module_of_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; import run; run._environment();"
            "from slambench import fleet, session; import coebslam_tpu_torch;"
            "from coebslam_tpu_torch.slam import realtime, maintenance;"
            "from coebslam_tpu_torch.models import detector;"
            "print(session.forbidden_modules())" % (BENCH, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ------------------------------------------------------------------ #
# Frozen counts and statistics
# ------------------------------------------------------------------ #

def test_fast_work_counts_each_live_pixel_and_both_maps():
    b, ops = counts.fast_work(48, 64, 2, 2.0)
    live = 48 * 64 + 24 * 32
    assert b == 4 * live + 2 * 4 * 2 * 48 * 64
    assert ops == 97 * live
    assert counts.fast_work(480, 640, 8, 1.2) == (23462928, 92201604)


def test_yolo_conv_flops_from_shapes():
    det = {"num_classes": 80, "width_multiple": 0.5, "depth_multiple": 0.33,
           "input_size": 64}
    flops = counts.yolo_conv_flops(det)
    # The stem alone: 32 output channels at 32 x 32, 6 x 6 x 3 taps.
    assert flops > 2 * 32 * 32 * 32 * 108
    det["input_size"] = 128
    assert counts.yolo_conv_flops(det) == 4 * flops


def test_hamming_flops_from_the_configurations_features():
    cfg = {"sensor": "rgbd", "orb": {"n_features": 4, "max_keypoints": 8},
           "limits": {"local_window": 1, "reuse_chunks": 1,
                      "spawn_per_kf": 2, "seed_slots": 1}}
    assert counts.hamming_flops(cfg) == 2 * 256 * (4 * 4 * 5 + 16)
    cfg["sensor"] = "stereo"
    assert counts.hamming_flops(cfg) == 2 * 256 * (4 * 4 * 5 + 32)
    # The padded slot capacity does not count.
    cfg["orb"]["max_keypoints"] = 2048
    assert counts.hamming_flops(cfg) == 2 * 256 * (4 * 4 * 5 + 32)


def test_percentile_union_gaps_and_ate():
    assert stats.percentile(list(range(101)), 95) == 95.0
    iv = np.array([[0, 2], [1, 3], [5, 6]], float)
    u = stats.union(iv)
    assert u.tolist() == [[0, 3], [5, 6]]
    assert stats.gaps(u, 0, 10).tolist() == [[3, 5], [6, 10]]
    gt = np.random.RandomState(0).randn(20, 3)
    R = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], float)
    assert stats.ate_rmse(gt @ R.T + 1.0, gt)[0] < 1e-9


def test_ate_with_scale_aligns_a_monocular_trajectory():
    gt = np.random.RandomState(1).randn(30, 3)
    R = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], float)
    est = 2.5 * gt @ R.T + np.array([0.3, -1.0, 2.0])
    err, scale = stats.ate_rmse(est, gt, with_scale=True)
    assert err < 1e-9 and abs(scale - 0.4) < 1e-12
    err, scale = stats.ate_rmse(est, gt)
    assert err > 0.5 and scale == 1.0


def test_ping_pong_and_session_seeds():
    assert [traffic.ping_pong(k, 4) for k in range(8)] == [0, 1, 2, 3, 2,
                                                           1, 0, 1]
    s = {traffic.session_seed(2 ** 31 + 17, i) for i in range(8)}
    assert len(s) == 8 and all(0 <= x < 2 ** 30 for x in s)
    assert traffic.session_seed(5, 1) == traffic.session_seed(5, 1)


def test_pose_gap_is_precise_near_the_identity():
    a = 1e-6
    R = torch.tensor([[math.cos(a), -math.sin(a), 0], [math.sin(a),
                      math.cos(a), 0], [0, 0, 1]], dtype=torch.float64)
    g = checks.pose_gap_mm(R, torch.zeros(3), torch.eye(3), torch.zeros(3))
    assert abs(g - 1e-3) < 1e-9


# ------------------------------------------------------------------ #
# A tracking stage with fewer than 3 matches has no pose to compare
# ------------------------------------------------------------------ #

def _compare_stage(n_ref, moved_m=0.0, n_port=None):
    """One stage through ``checks.compare_stage``: the reference's pose
    from ``n_ref`` matches (its inliers, or none below 3), the port's pose
    moved ``moved_m`` along x with its own inliers and ``n_port`` matches
    before its solve (default: the reference's count)."""
    from coebslam_tpu_torch.geometry.se3 import SE3
    from coebslam_tpu_torch.slam import tracking
    f64 = torch.float64
    ids = torch.full((16,), -1, dtype=torch.int64)
    ids[:n_ref] = torch.arange(n_ref) + 5
    ref_idx = ids if n_ref >= reference.MIN_POSE_MATCHES else \
        torch.full_like(ids, -1)
    R, t = torch.eye(3, dtype=f64), torch.tensor([0.1, -0.2, 1.5], dtype=f64)
    moved = t + torch.tensor([moved_m, 0.0, 0.0], dtype=f64)
    n = n_ref if n_port is None else n_port
    res = tracking.TrackStepResult(SE3(R.float(), moved.float()), ids.clone(),
                                   ids >= 0, (ids >= 0).sum(), torch.tensor(n))
    out = {"match_mismatch_pct": 0.0, "pose_gap_mm": 0.0,
           "stages_solved": 0, "stages_unsolved": 0}
    checks.compare_stage(out, res, R, t, ref_idx, n_ref)
    return out


def _passes(out):
    lim = spec.cell(ROOT, _bench(), "rgbd_tum_walking.fleet")["limits"]
    return all(out[k] <= lim[k] for k in ("match_mismatch_pct",
                                          "pose_gap_mm"))


@pytest.mark.parametrize("n_ref,moved_m", [(2, 1.0), (0, 0.0)])
def test_a_stage_below_3_reference_matches_is_not_failed_for_its_pose(
        n_ref, moved_m):
    out = _compare_stage(n_ref, moved_m)
    assert out == {"match_mismatch_pct": 0.0, "pose_gap_mm": 0.0,
                   "stages_solved": 0, "stages_unsolved": 1}
    assert _passes(out)


@pytest.mark.parametrize("n_ref,n_port", [(2, 3), (2, 1), (0, 1)])
def test_a_stage_below_3_matches_fails_on_the_count_of_matches(n_ref,
                                                                n_port):
    out = _compare_stage(n_ref, n_port=n_port)
    assert out["match_mismatch_pct"] == 100.0 and out["stages_unsolved"] == 1
    assert not _passes(out)


@pytest.mark.parametrize("n_ref", [3, 8])
def test_a_stage_of_3_matches_or_more_is_compared_in_full(n_ref):
    assert _passes(_compare_stage(n_ref))
    out = _compare_stage(n_ref, 0.01)
    assert out["stages_unsolved"] == 0 and out["stages_solved"] == 1
    assert abs(out["pose_gap_mm"] - 10.0) < 1e-4 and not _passes(out)
    # A port that finds fewer than 3 where the reference finds 3 or more
    # is still held to the pose.
    out = _compare_stage(n_ref, 0.01, n_port=2)
    assert out["stages_unsolved"] == 0 and not _passes(out)


def test_a_run_whose_sampled_stages_all_have_fewer_than_3_matches_fails():
    """Every stage under 3 reference matches, the port's counts equal:
    the pose and inlier numbers read 0 by default, so the run is not
    correct for want of a solved stage, as it is for want of a keyframe."""
    lim = spec.cell(ROOT, _bench(), "rgbd_tum_walking.fleet")["limits"]
    sessions = []
    for n_ref in (0, 1, 2, 2):
        out = _compare_stage(n_ref, 1.0)
        out["keyframes_checked"] = 2
        sessions.append(out)
    assert all(_passes(c) for c in sessions)
    assert fleet._not_covered(lim, sessions) == [
        "no sampled stage of the window was solved"]
    sessions[-1] = dict(sessions[-1], stages_solved=1)
    assert fleet._not_covered(lim, sessions) == []
    # Without a pose limit, as without a keyframe limit, nothing is owed.
    assert fleet._not_covered({"feat_mismatch_pct": 5.0},
                              [dict(c, keyframes_checked=0)
                               for c in sessions[:1]]) == []
    assert fleet._not_covered(lim, [dict(c, keyframes_checked=0)
                                    for c in sessions]) == [
        "no keyframe of the window was checked"]


def test_the_reference_solves_no_pose_from_fewer_than_3_matches():
    cam = checks.RefCam(500.0, 500.0, 160.0, 120.0, 0.0, 320, 240)
    opt = {"rounds": 4, "iters": 10, "chi2_mono": 5.991, "chi2_stereo": 7.815}
    g = torch.Generator().manual_seed(5)
    X = torch.rand(6, 3, generator=g, dtype=torch.float64) + \
        torch.tensor([-0.5, -0.5, 2.0], dtype=torch.float64)
    obs = torch.stack([cam.fx * X[:, 0] / X[:, 2] + cam.cx,
                       cam.fy * X[:, 1] / X[:, 2] + cam.cy,
                       torch.full((6,), -1.0, dtype=torch.float64)], -1)
    w = torch.ones(6, dtype=torch.float64)
    R0 = torch.eye(3, dtype=torch.float64)
    t0 = torch.tensor([0.02, -0.01, 0.03], dtype=torch.float64)
    for n in range(7):
        valid = torch.arange(6) < n
        R, t, inl = reference.solve_pose(R0, t0, X, obs, w, valid, cam, opt,
                                         torch.float64)
        if n < 3:
            assert torch.equal(R, R0) and torch.equal(t, t0)
            assert not bool(inl.any())
        else:
            # Exact projections from the identity: the solve finds it.
            assert float(torch.linalg.norm(t)) < 1e-6, n
            assert torch.equal(inl, valid)


# ------------------------------------------------------------------ #
# The reference against the port at a small size
# ------------------------------------------------------------------ #

def _frames(cell, seed=7):
    cfg = cell["config"]
    c = cfg["camera"]
    cam = traffic.Camera(c["fx"], c["fy"], c["cx"], c["cy"], c["width"],
                         c["height"], c["fps"])
    return traffic.make_frames(dict(cell["traffic"], frames=4), cam,
                               cfg["sensor"], seed, 1, "cpu",
                               baseline=c["bf"] / c["fx"])


@pytest.mark.parametrize("name", ["rgbd_tum_walking.fleet",
                                  "stereo_euroc.fleet"])
def test_reference_extraction_equals_the_port(name):
    from coebslam_tpu_torch import config as cm
    from coebslam_tpu_torch.ops import extractor
    cell = _small(spec.cell(ROOT, _bench(), name))
    fr = _frames(cell)
    cfg = cm.config_from_dict(cell["config"])
    img = torch.from_numpy(fr.gray[1]).float()
    nf = torch.tensor(400)
    mask = torch.zeros(img.shape, dtype=torch.bool)
    mask[40:120, 60:140] = True
    p = extractor.extract(img, cfg.orb, n_features=nf, dynamic_mask=mask,
                          area_mode=torch.tensor(False))
    r = reference.extract(img, checks.ref_orb(cell["config"]), nf, mask,
                          torch.tensor(False))
    pct, same = checks.compare_feats(p, r)
    assert pct == 0.0 and int(same.sum()) > 100


def test_reference_stereo_depth_equals_the_port():
    from coebslam_tpu_torch import config as cm
    from coebslam_tpu_torch.slam import frame
    cell = _small(spec.cell(ROOT, _bench(), "stereo_euroc.fleet"))
    fr = _frames(cell)
    cfg = cm.config_from_dict(cell["config"])
    left = torch.from_numpy(fr.gray[1]).float()
    right = torch.from_numpy(fr.second[1]).float()
    fd = frame.process_stereo(left, right, cfg.camera, cfg.orb)
    orb = checks.ref_orb(cell["config"])
    fl = reference.extract(left, orb)
    frr = reference.extract(right, orb)
    d, ur = reference.stereo_depth(fl, frr, checks.ref_cam(cell["config"]),
                                   orb.scale_factor)
    assert int((d > 0).sum()) > 50
    assert torch.equal(d, fd.depth) and torch.equal(ur, fd.ur)


def test_reference_triangulation_equals_the_port():
    """The port's epipolar match and triangulation of a keyframe pair
    against the reference's float64 triangulation of the same pairs."""
    from coebslam_tpu_torch import config as cm
    from coebslam_tpu_torch.geometry.se3 import SE3
    from coebslam_tpu_torch.ops import triangulation
    cell = _mono_small(spec.cell(ROOT, _bench(), "rgbd_tum_walking.fleet"))
    cfg = cm.config_from_dict(cell["config"])
    cam = checks.ref_cam(cell["config"])
    g = torch.Generator().manual_seed(3)
    n = 200
    X = torch.stack([torch.rand(n, generator=g) * 2.0 - 1.0,
                     torch.rand(n, generator=g) * 1.5 - 0.75,
                     torch.rand(n, generator=g) * 2.0 + 1.0], -1)
    a = 0.05
    R2 = torch.tensor([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                       [-math.sin(a), 0, math.cos(a)]])
    T1 = SE3(torch.eye(3), torch.zeros(3))
    T2 = SE3(R2, torch.tensor([-0.12, 0.01, 0.0]))

    def project(T):
        p = X @ T.R.T + T.t
        uv = torch.stack([cam.fx * p[:, 0] / p[:, 2] + cam.cx,
                          cam.fy * p[:, 1] / p[:, 2] + cam.cy], -1)
        return uv + 0.3 * torch.randn(n, 2, generator=g)

    uv1, uv2 = project(T1), project(T2)
    desc = torch.randint(0, 256, (n, 32), generator=g, dtype=torch.uint8)
    sd = reference.signed(desc)
    level = torch.randint(0, 3, (n,), generator=g)
    ok = torch.ones(n, dtype=torch.bool)
    p = triangulation.triangulate_pair(
        uv1, sd, ok, level, uv2, sd, ok, level.float(), -torch.ones(n),
        T1, T2, cfg.camera, cfg.orb, cfg.matcher)
    assert bool((p.idx2[p.good] == torch.arange(n)[p.good]).all())
    f64 = torch.float64
    Xr, good = reference.triangulate(
        uv1.to(f64), level, uv2, level, T1.R, T1.t, T2.R, T2.t, cam,
        cfg.orb.scale_factor, 5.991)
    # Every pair the port keeps passes the reference's gates. (The port's
    # epipolar band also turns away some true pairs, which the reference
    # takes as matched: the check compares the pairs the program made.)
    assert int(p.good.sum()) > 0.5 * n and int(good.sum()) > 0.9 * n
    assert not bool((p.good & ~good).any())
    gap = torch.linalg.norm(p.points.to(f64) - Xr, dim=-1)[p.good]
    # float32 normal equations against float64: 5e-5 of the depth here.
    assert float(gap.max()) < 1e-4 * float(torch.linalg.norm(Xr, dim=-1).max())


def test_reference_detector_equals_the_port():
    from coebslam_tpu_torch import config as cm
    from coebslam_tpu_torch.models import detector as det_mod
    cell = _small(spec.cell(ROOT, _bench(), "rgbd_tum_walking.fleet"))
    fr = _frames(cell)
    cfg = cm.config_from_dict(cell["config"])
    g = torch.from_numpy(fr.gray[0])
    size = cell["config"]["detector"]["input_size"]
    model = reference.make_detector(cell["config"]["detector"], 99,
                                    reference.detector_input(g, size), "cpu")
    det = det_mod.YoloDetector(cfg.detector, cfg.dynamic,
                               variables=model.state_dict(), device="cpu")
    with torch.no_grad():
        hp = det.heads(torch.from_numpy(fr.gray[2]))
        hr = model(reference.detector_input(torch.from_numpy(fr.gray[2]),
                                            size))
    for a, b in zip(hp, hr):
        assert torch.equal(a, b)
    assert 0.1 < float(hr[0].std()) < 50.0


# ------------------------------------------------------------------ #
# Whole runs on the CPU: sound, and with a fault planted underneath
# ------------------------------------------------------------------ #

def _run(name, opts=None, seconds=2.0, trace=0, seed=2 ** 31 + 5,
         edit=_small, log=None):
    cell = edit(spec.cell(ROOT, _bench(), name))
    o = {"device": "cpu"}
    o.update(opts or {})
    return fleet.run(cell, seed, seconds, trace, time.monotonic(), o,
                     log=log or (lambda s: None))


def _schema(res, trace):
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert list(res)[-1] == "checks"
    for k, c in res["checks"].items():
        assert set(c) == {"value", "limit"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert "busy_s" in res["device"] and "window_s" in res["device"]
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", ["rgbd_tum_walking.fleet",
                                  "stereo_euroc.fleet"])
def test_a_sound_run_is_correct(name):
    # Long enough for a keyframe in the window, whose spawn is compared.
    res, code = _run(name, seconds=4.0)
    assert code == 0
    _schema(res, 0)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert {"fps", "frame_ms_p95", "setup_s"} <= set(res["metrics"])


def test_a_traced_run_reports_the_layers():
    res, code = _run("rgbd_tum_walking.fleet", trace=1)
    assert code == 0
    _schema(res, 1)
    assert res["correct"]
    m = res["metrics"]
    assert {"host_ms_per_frame", "track_host_ms"} <= set(m)
    # No device on the CPU: no device-trace metric, no device number.
    assert not {"track_ms", "device_idle_pct", "frame_mfu"} & set(m)


@pytest.mark.parametrize("name,fault",
                         [("rgbd_tum_walking.fleet", f) for f in checks.FAULTS]
                         + [("stereo_euroc.fleet", f)
                            for f in checks.KEYFRAME_FAULTS])
def test_a_planted_fault_makes_the_run_incorrect(name, fault):
    res, code = _run(name, {"fault": fault}, seconds=4.0)
    assert res is not None
    assert res["correct"] is False, (fault, res["checks"])
    if fault == "spawn_depth_off":
        # Caught by the spawn comparison itself, not by chance.
        assert res["checks"]["spawn_gap_mm"]["value"] > 1.0
        assert res["checks"]["spawn_mismatch_pct"]["value"] == 0.0
    if fault == "ba_skipped":
        assert res["checks"]["ba_pose_gap_mm"]["value"] \
            > res["checks"]["ba_pose_gap_mm"]["limit"]


def test_a_sound_monocular_run_is_correct():
    """The test copy's ``track_mono`` configuration: no depth in the
    reference's observations, keyframes spawned by triangulation against
    the previous keyframe and checked so, the map's scale fitted by the
    ATE's similarity."""
    lines = []
    res, code = _run("rgbd_tum_walking.fleet", seconds=8.0, edit=_mono_small,
                     log=lines.append)
    assert code == 0
    _schema(res, 0)
    assert res["correct"], res["checks"]
    c = res["checks"]
    assert c["match_mismatch_pct"]["value"] == 0.0
    assert c["pose_gap_mm"]["value"] < 2.0
    assert {"spawn_gap_mm", "spawn_mismatch_pct", "ba_pose_gap_mm",
            "ate_cm"} <= set(c)
    line = next(s for s in lines if s.startswith("session 0:"))
    checked = int(line.split("keyframes checked ")[1].split()[0])
    spawned = int(line.split(" with ")[1].split()[0])
    built = int(line.split("map built at step ")[1].split()[0])
    assert checked >= 1 and spawned >= 1 and built < 5, line
    assert "similarity, scale" in line


@pytest.mark.parametrize("fault", checks.KEYFRAME_FAULTS)
def test_a_planted_keyframe_fault_makes_a_monocular_run_incorrect(fault):
    res, code = _run("rgbd_tum_walking.fleet", {"fault": fault},
                     seconds=8.0, edit=_mono_small)
    assert res is not None
    c = res["checks"]
    assert res["correct"] is False, (fault, c)
    if fault == "spawn_depth_off":
        assert c["spawn_gap_mm"]["value"] > c["spawn_gap_mm"]["limit"]
        assert c["spawn_mismatch_pct"]["value"] == 0.0
    else:
        assert c["ba_pose_gap_mm"]["value"] > c["ba_pose_gap_mm"]["limit"]


def test_a_junction_ba_at_the_same_keyframe_count_is_not_a_keyframe():
    """A loop closure's junction BA calls ``_windowed_ba`` again at the
    keyframe count of the last keyframe: only the keyframe's own BA is
    recorded, with the previous keyframe's row for a monocular sensor."""
    from types import SimpleNamespace
    from coebslam_tpu_torch import config as cm
    from coebslam_tpu_torch.slam import realtime
    from slambench import session
    cell = _mono_small(spec.cell(ROOT, _bench(), "rgbd_tum_walking.fleet"))
    lim = realtime.RTLimits(**cell["config"]["limits"])
    st = realtime.init_state(cm.config_from_dict(cell["config"]), lim, "cpu")
    sample = session.Sample(8, np.random.RandomState(0))
    cur = {"window": True, "frame": 3}
    cap = session.KeyframeCapture(sample, lim, True, cur, [("budget",)])
    solved = []
    rt = SimpleNamespace()
    lba = SimpleNamespace(optimize_local_ba=lambda prob: solved.append(prob))
    rt._windowed_ba = lambda s: (lba.optimize_local_ba("window"), s)[1]
    rt._create_keyframe = lambda s: rt._windowed_ba(
        s._replace(n_kf=s.n_kf + 1))
    cap.install(rt, lba)
    st = rt._create_keyframe(st._replace(n_kf=torch.tensor(2)))
    rt._windowed_ba(st)                       # the junction BA
    assert len(solved) == 2
    recs = sample.records()
    assert len(recs) == 1 and int(recs[0]["n_kf"]) == 3
    assert recs[0]["ba"][0] == "window" and recs[0]["extract"] == ("budget",)
    assert set(recs[0]["prev"]) == {"R", "t", "uv", "w", "pid"}
    assert recs[0]["prev"]["uv"].shape == (st.kf_obs.shape[1], 2)
    # Outside the window nothing is recorded, and the flag is spent.
    cur["window"] = False
    rt._create_keyframe(st)
    cur["window"] = True
    rt._windowed_ba(st)
    assert len(sample.records()) == 1


def test_the_control_is_not_correct_on_a_monocular_run():
    import control
    res, code = control.run_control("rgbd_tum_walking.fleet", 2 ** 31 + 9,
                                    8.0, {"device": "cpu"}, _mono_small)
    assert res is not None
    assert res["correct"] is False, res["checks"]


# ------------------------------------------------------------------ #
# On the card
# ------------------------------------------------------------------ #

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rgbd_tum_walking.fleet",
                                  "stereo_euroc.fleet"])
def test_the_command_prints_one_result_line(card, name):
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload", name,
         "--seed", "4242", "--seconds", "5", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    _schema(res, 0)
    assert res["device"]["platform"] == "gpu"


@pytest.mark.parametrize("name", ["rgbd_tum_walking.fleet",
                                  "stereo_euroc.fleet"])
def test_the_control_is_not_correct(name):
    """The reference one precision down in the program's place (on the CPU
    TF32 changes nothing, so the bfloat16 pose solve and stereo depth
    carry it here)."""
    import control
    res, code = control.run_control(name, 2 ** 31 + 9, 2.0,
                                    {"device": "cpu"}, _small)
    assert res is not None
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rgbd_tum_walking.fleet",
                                  "stereo_euroc.fleet"])
def test_the_control_is_not_correct_at_the_cells_size(card, name):
    """On the card at the cell's own size and load, three seeds."""
    import control
    for seed in (71, 72, 73):
        res, code = control.run_control(name, seed, 10.0)
        assert res is not None
        assert res["correct"] is False, res["checks"]


def test_traces_of_the_sessions_merge_on_one_clock():
    """Two sessions' device intervals overlap: the card is busy for their
    union, idle stretches are named by the span the sessions were in."""
    def session(busy, track):
        iv = np.array(busy, float) * 1e9
        return {"hand": [0.0], "back": [0.1], "done": [0.2], "h_end": 10.0,
                "attempted": 1, "peak_bytes": 1, "chip_used_bytes": 1,
                "maint_host_ms": [], "syncs": 3,
                "trace": {"busy": iv, "kernels": len(busy),
                          "by_name": {"_Z11fast_kernelPKf": (2, 2e6)},
                          "spans": {"track": {
                              "calls": 1, "host_ns": 1e9, "device_ns": 5e8,
                              "kernels": 1,
                              "intervals": np.array(track, float) * 1e9}}}}
    cell = {"config": {}}
    res = [session([[1, 3], [6, 7]], [[0, 10]]),
           session([[2, 4]], [[0, 5]])]
    run = fleet.Run(cell, res, 0.0, 1.0, {"fast": 1e-3}, 1e-3)
    assert abs(run.busy_s - 4.0) < 1e-9 and run.window_s == 10.0
    assert run.on_device and run.kernels == 3 and run.syncs == 6
    assert dict(run.gaps) == {"host:track": 6.0}
    assert run.spans["track"]["device_ms"] == 1000.0
    read = spec.reader("fast_roofline_pct")
    assert abs(read(run) - 100.0 * 4 * 1e-3 / 4e-3) < 1e-9
    assert abs(spec.reader("device_idle_pct")(run) - 60.0) < 1e-9

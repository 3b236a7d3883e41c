"""The port's recorder of spans and counters (``utils/metrics.py``) on the
CPU: off it records nothing and hands out one shared no-op; on it keeps
parents, request ids, wall and thread CPU time on the profiler's clock;
and a realtime session records one ``step`` a frame with tracking's four
stages split into matching and pose GN, device counters that agree with
the step's own decision bundle, and the same state as with it off.
"""
import threading
import time

import numpy as np
import pytest
import torch

from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.slam import realtime as trt
from coebslam_tpu_torch.slam import tracking as ttrack
from coebslam_tpu_torch.utils import metrics
from coebslam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

CAM = dict(width=320, height=240, fx=267.7, fy=269.6, cx=160.05, cy=123.8)
LIM = dict(max_kf=8, spawn_per_kf=256, ba_window=4, local_window=3,
           max_frames=64, seed_slots=64)
N_FRAMES = 6


@pytest.fixture(autouse=True)
def recorder_off():
    """Every case starts and ends with the recorder off and empty."""
    metrics.tracing(False)
    metrics.drain()
    yield
    metrics.tracing(False)
    metrics.drain()


def test_off_records_nothing_and_hands_out_the_shared_no_op():
    assert not metrics.enabled()
    assert metrics.span("a") is metrics.NO_SPAN
    assert metrics.host_read("a", 2) is metrics.NO_SPAN
    with metrics.span("a"), metrics.host_read("b"):
        metrics.count("c", 3)
        metrics.count_device("d", {"x": torch.tensor(1)})
    assert metrics.drain() == {"spans": [], "counters": {},
                               "device_counters": {}}


def test_on_keeps_parents_requests_and_cpu_within_wall():
    metrics.tracing(True)
    metrics.request(7)
    with metrics.span("outer"):
        with metrics.span("inner"):
            sum(i * i for i in range(20000))
        with metrics.host_read("site", 2):
            pass
        metrics.count("c", 3)
        metrics.count("c")
    metrics.request(8)
    metrics.count("c")
    metrics.count_device("d", {"x": torch.tensor(2), "y": torch.tensor(True)})
    metrics.request(9)
    metrics.count_device("d", {"x": torch.tensor(5), "y": torch.tensor(False)})

    def other():                 # another thread's stack starts empty
        with metrics.span("elsewhere"):
            pass
    th = threading.Thread(target=other)
    th.start()
    th.join()

    rec = metrics.drain()
    by = {s["path"]: s for s in rec["spans"]}
    assert set(by) == {"outer", "outer/inner", "outer/read:site",
                       "elsewhere"}
    assert by["outer"]["parent"] is None and by["elsewhere"]["parent"] is None
    assert by["outer/inner"]["parent"] == "outer"
    assert by["outer/read:site"]["reads"] == 2 and by["outer"]["reads"] == 0
    assert {s["request"] for s in rec["spans"]} == {7, 9}
    for s in rec["spans"]:
        assert 0 <= s["cpu_ns"] <= s["t1"] - s["t0"]
    assert by["outer"]["t0"] <= by["outer/inner"]["t0"] \
        <= by["outer/inner"]["t1"] <= by["outer"]["t1"]
    assert rec["counters"] == {"c": {7: 4, 8: 1}}
    assert rec["device_counters"] == {"d": {"request": [8, 9],
                                            "x": [2.0, 5.0],
                                            "y": [1.0, 0.0]}}
    assert metrics.drain() == {"spans": [], "counters": {},
                               "device_counters": {}}
    with pytest.raises(ValueError):
        metrics.count_device("d", {"x": torch.tensor(1)})
        metrics.count_device("d", {"z": torch.tensor(1)})


def test_a_profiler_event_lies_inside_its_span():
    a = torch.randn(64, 64)
    metrics.tracing(True)
    act = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=act) as prof:
        with metrics.span("mm"):
            torch.mm(a, a)
    (s,) = metrics.drain()["spans"]
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert ev
    for e in ev:
        assert s["t0"] <= e.start_ns() <= s["t1"]


def test_stage_timer_times_with_the_recorder_off_and_records_when_on():
    mc = metrics.MetricsCollector()
    with mc.stage("frontend"):
        time.sleep(0.002)
    assert mc._stage_acc["frontend"] >= 2.0
    assert metrics.drain()["spans"] == []
    metrics.tracing(True)
    with mc.stage("frontend"):
        pass
    (s,) = metrics.drain()["spans"]
    assert s["path"] == "frontend"


# ------------------------------------------------------------------ #
# A realtime session
# ------------------------------------------------------------------ #

def _config(sensor):
    return tcfg.SystemConfig(
        camera=tcfg.CameraConfig(**CAM),
        orb=tcfg.OrbConfig(n_levels=4, max_keypoints=1024),
        tracking=tcfg.TrackingConfig(max_frames_between_kf=3),
        sensor=sensor)


@pytest.fixture(scope="module")
def scenes():
    """RGB-D (grey, uint16 depth) and stereo (left, right) renders of the
    port's room on an orbit, N_FRAMES each."""
    cam = _config("rgbd").camera
    planes = tsyn.make_room(seed=0, device="cpu")
    poses = tsyn.camera_trajectory(40, radius=0.35)[:N_FRAMES]
    shift = torch.tensor([cam.baseline, 0.0, 0.0])
    rgbd, stereo = [], []
    for i, p in enumerate(poses):
        g, d, _, _ = tsyn.render(cam, p, planes, None, i)
        gr = tsyn.render(cam, type(p)(p.R, p.t - shift), planes, None, i)[0]
        g8 = torch.clamp(g, 0, 255).to(torch.uint8)
        rgbd.append((g8, (d * cam.depth_map_factor).to(torch.int32)))
        stereo.append((g.to(torch.float32), gr.to(torch.float32)))
    return {"rgbd": rgbd, "stereo": stereo}


def _session(sensor, frames, on, monkeypatch):
    """Run the frames; returns (final state, recorder contents, the
    final-stage inliers of each fused_step's decision bundle)."""
    inl = []
    fused = trt.fused_step

    def keep(*a, **k):
        out = fused(*a, **k)
        inl.append(float(out.scalars.vec[ttrack._V_INL]))
        return out

    monkeypatch.setattr(trt, "fused_step", keep)
    metrics.tracing(on)
    rt = trt.RealtimeSlam(_config(sensor), trt.RTLimits(**LIM), device="cpu")
    entry = rt.track if sensor == "rgbd" else rt.track_stereo
    for i, (a, b) in enumerate(frames):
        entry(a, b, stamp=i / 30.0)
    metrics.tracing(False)
    monkeypatch.setattr(trt, "fused_step", fused)
    return rt.state, metrics.drain(), inl


def _leaves(t):
    if isinstance(t, tuple):
        return [x for v in t for x in _leaves(v)]
    return [t]


@pytest.mark.parametrize("sensor", ["rgbd", "stereo"])
def test_a_session_records_its_steps_and_keeps_its_state(sensor, scenes,
                                                         monkeypatch):
    st_on, rec, inl = _session(sensor, scenes[sensor], True, monkeypatch)
    st_off, rec_off, inl_off = _session(sensor, scenes[sensor], False,
                                        monkeypatch)
    # The same state, bit for bit, with the recorder on and off.
    for x, y in zip(_leaves(st_on), _leaves(st_off)):
        assert torch.equal(x, y)
    assert rec_off == {"spans": [], "counters": {}, "device_counters": {}}
    assert inl == inl_off and len(inl) == N_FRAMES

    spans = rec["spans"]
    steps = [s for s in spans if s["path"] == "step"]
    assert [s["request"] for s in steps] == list(range(N_FRAMES))
    per = {}
    for s in spans:
        per.setdefault(s["path"], []).append(s)
    assert len(per["step/tracking"]) == N_FRAMES
    for k in range(4):
        stage = f"step/tracking/track_stage{k}"
        assert len(per[stage]) == N_FRAMES
        assert len(per[stage + "/hamming"]) == N_FRAMES
        assert len(per[stage + "/pose_gn"]) == N_FRAMES
    for s in spans:
        if s["parent"] is not None:
            p = next(q for q in per[s["parent"]]
                     if q["t0"] <= s["t0"] and s["t1"] <= q["t1"])
            assert p["request"] == s["request"]
    for p in ("step/frontend", "step/dynamic_frontend", "step/arena_unpack",
              "step/read:kf_decision",
              "step/dynamic_frontend/read:f_refit_svd"):
        assert len(per[p]) == N_FRAMES, p
    assert all(s["reads"] == 2
               for s in per["step/dynamic_frontend/read:f_refit_svd"])
    if sensor == "stereo":
        assert len(per["step/frontend/stereo_match"]) == N_FRAMES
    made = sum(rec["counters"]["keyframes"].values())
    assert made >= 2
    assert len(per["step/keyframe_ba"]) == made
    assert len(per["step/keyframe_ba/local_ba"]) == made

    dc = rec["device_counters"]["tracking"]
    assert dc["request"] == list(range(N_FRAMES))
    final = np.maximum(dc["inliers2"], dc["inliers3"])
    assert final.tolist() == inl
    for k in range(4):
        assert all(i <= m for i, m in zip(dc[f"inliers{k}"],
                                          dc[f"matches{k}"]))
    adopted = [(a < 30) and (b > a) for a, b in zip(dc["inliers0"],
                                                    dc["inliers1"])]
    assert dc["retry_adopted"] == [float(x) for x in adopted]
    assert sum(dc["tracked"]) >= N_FRAMES - 2
    assert min(dc["keypoints"]) >= 500


def test_a_maintenance_dispatch_shares_its_frames_request(scenes,
                                                          monkeypatch):
    """A dispatch after a frame carries the frame's request id, with one
    ``bow`` (and its descent) per keyframe it processes."""
    import os
    from coebslam_tpu_torch.slam import vocabulary
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    voc = vocabulary.load(os.path.join(root, "artifacts", "vocab_1e5.npz"))
    metrics.tracing(True)
    rt = trt.RealtimeSlam(_config("rgbd"), trt.RTLimits(**LIM),
                          device="cpu", vocabulary=voc, maintain_every=2)
    for i, (g, d) in enumerate(scenes["rgbd"][:4]):
        rt.track(g, d, stamp=i / 30.0)
    rec = metrics.drain()
    maint = [s for s in rec["spans"] if s["path"] == "step/maintenance"]
    assert [s["request"] for s in maint] == [1, 3]
    bow = [s for s in rec["spans"] if s["path"] == "step/maintenance/bow"]
    descend = [s for s in rec["spans"]
               if s["path"] == "step/maintenance/bow/descend"]
    reads = [s for s in rec["spans"]
             if s["path"] == "step/maintenance/read:maint_branch"]
    kfs = sum(rec["counters"]["maint_keyframes"].values())
    assert len(bow) == len(descend) == len(reads) == kfs >= 2
    assert sum(rec["counters"]["maint_dispatches"].values()) == 2
    assert len([s for s in rec["spans"]
                if s["path"] == "step/maintenance/read:reloc_need"]) == 2

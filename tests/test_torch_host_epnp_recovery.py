"""The host monocular System's recovery through the Relocalizer's EPnP
branch (chip_smoke.py [21], host_sensor_scenes.py) and the monocular Sim3
loop closure ([20]) beside the JAX package's, on the CPU.

A monocular kidnap whose return frame lies beyond the fused step's widened
gate (the search radius widens at most 3x while lost): the lost state's
retry fails, the tracker calls its relocalization callback, and the
Relocalizer, with no depth on the frame, takes its EPnP branch. Both
packages' ``System(vocabulary=)`` run it at the tests' ORB cut (1024
keypoints, 4 levels) on the JAX renderer's frames with the scene's JAX
vocabulary; the port draws the reference's RANSAC samples
(``init_sampler``, ``reloc_sampler``, ``loop_sampler``).

Held, frame by frame: the returned state and the tracker's mode equal;
both recover the return frame through EPnP, with the same count of EPnP
RANSACs, within 15 cm of the centre each gave that place before. The
poses are not held frame by frame: the monocular initialisation's
homography comes from a float32 pixel DLT that LAPACK and XLA solve apart
(ops/initializer_ops.py; 1e-4 on the 0.8 m orbit's first pair), and the
young monocular map's local BAs grow that gap to ~5e-3 within six frames
(measured on that orbit). So
the relocalization is held on one map: the JAX System's as it stands
before the return frame, copied for the port, where both Relocalizers take
the return frame: the relocalized pose within tests/test_torch_pnp.py's
5e-5, the point ids and the EPnP RANSAC's inlier set equal.

The same session's final map closes [20]'s monocular Sim3 loop: no
rendered circuit makes either package's monocular System close one, so
the map is drifted in scale (host_sensor_scenes.drift_late_keyframes: its
last keyframes and their points moved by a similarity of scale 1.2,
shared points copied) and its newest keyframe closed against its oldest,
on one copy per package: the pair, compute_sim3's gates and the corrected
Sim3 (scale 1.2) within optimize_sim3's 1e-4; ``correct`` with the global
BA held back, as tests/test_torch_loop_closing.py holds the RGB-D closure.

Scenes, on [21]'s orbit (60 frames a lap at 1.2 m radius): ``full``
(slow) is [21]'s own, frames 0-45 tracked, then frame 15; ``short`` (the
fast tier) tracks frames 0, 1 and then every third frame to 43 (the
initialising pair is the orbit's first), then frame 15.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from coebslam_tpu import config as jcfg
from coebslam_tpu.ops import extractor as jext
from coebslam_tpu.slam import frame as jframe
from coebslam_tpu.slam import vocabulary as jvoc
from coebslam_tpu.slam.relocalization import Relocalizer as JReloc
from coebslam_tpu.slam.system import System as JSystem
from coebslam_tpu.utils import synthetic as jsyn
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.ops.extractor import Features
from coebslam_tpu_torch.slam import frame as tframe
from coebslam_tpu_torch.slam import system as tsys
from coebslam_tpu_torch.slam import vocabulary as tvoc
from coebslam_tpu_torch.slam.relocalization import Relocalizer as TReloc
from host_bow_scenes import scene_vocabulary
from coebslam_tpu.slam.loop_closing import LoopCloser as JLoop
from coebslam_tpu_torch.slam.loop_closing import LoopCloser as TLoop
from host_sensor_scenes import (HOST_EPNP_RETURN, HOST_EPNP_TRACK,
                                HOST_EPNP_VOCAB_FRAMES, HOST_MONO_BLACK,
                                HOST_MONO_LOOP_DRIFT, HOST_EPNP_ORBIT,
                                HOST_MONO_RETURN_LIMIT_M, HOST_MONO_VOCAB,
                                close_drifted_loop, drift_late_keyframes,
                                host_mono_config)
from test_torch_host_sensors import init_sampler
from test_torch_keyframe_db import port_db_of
from test_torch_loop_closing import (_HeldBack, _copying_views,
                                     assert_arenas_match, port_arena_of)
from test_torch_relocalization import JaxDraws

torch.set_num_threads(2)
PNP_POSE_TOL = 5e-5
SCENES = {
    # The orbit's first pair, then every third frame to frame 43.
    "short": dict(sched=[0] + list(range(1, HOST_EPNP_TRACK, 3)),
                  ret=HOST_EPNP_RETURN, ref=(13, 16)),
    "full": dict(sched=list(range(HOST_EPNP_TRACK)), ret=HOST_EPNP_RETURN,
                 ref=(HOST_EPNP_RETURN,)),
}


def _world(scene):
    """The configuration in both packages, the JAX renderer's frames of
    [21]'s orbit and the scene's vocabulary (every 4th of the first
    HOST_EPNP_TRACK frames, as [21]) in both."""
    cfg = host_mono_config(jcfg, full=False)
    tc = tcfg.config_from_dict(dataclasses.asdict(cfg))
    planes = jsyn.make_room(seed=0)
    poses = jsyn.camera_trajectory(**HOST_EPNP_ORBIT)[:HOST_EPNP_TRACK]
    render = jax.jit(lambda p: jsyn.render(cfg.camera, p, planes)[0])
    frames = [np.asarray(render(p)) for p in poses]
    ex = jax.jit(lambda g: jext.extract(g, cfg.orb))
    descs = []
    for i in HOST_EPNP_VOCAB_FRAMES:
        f = ex(frames[i])
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    voc = scene_vocabulary(jvoc, descs, **HOST_MONO_VOCAB)
    return SCENES[scene], cfg, tc, frames, voc, tvoc.Vocabulary(*voc)


class _PnpLog:
    """Records each EPnP attempt's RANSAC inlier set (valid matches that
    are inliers) of a Relocalizer of either package."""

    def __init__(self, reloc, name):
        self.sets = []
        fn = getattr(reloc, name)

        def logged(*a):
            res, sol = fn(*a)
            self.sets.append(np.asarray(res.valid) & np.asarray(sol.inliers))
            return res, sol

        setattr(reloc, name, logged)


@pytest.fixture(scope="module", params=[
    "short", pytest.param("full", marks=pytest.mark.slow)])
def kidnap(request):
    """Both Systems over the scene: the states, both relocalizers' EPnP
    logs, and the JAX map and keyframe database as the return frame
    finds them."""
    sc, cfg, tc, frames, voc, tv = _world(request.param)
    js = JSystem(cfg, vocabulary=voc)
    ts = tsys.System(tc, device="cpu", vocabulary=tv,
                     init_sampler=init_sampler, reloc_sampler=JaxDraws(7),
                     loop_sampler=JaxDraws(13))
    jlog = _PnpLog(js.relocalizer, "_jit_attempt_pnp")
    tlog = _PnpLog(ts.relocalizer, "_attempt_pnp")
    seq = [frames[i] for i in sc["sched"]] \
        + [np.zeros_like(frames[0])] * HOST_MONO_BLACK + [frames[sc["ret"]]]
    states, modes, before = [], [], None
    for k, g in enumerate(seq):
        if k == len(seq) - 1:
            before = _copies(js.map, js.kf_db), len(jlog.sets), \
                len(tlog.sets)
        states.append((js.track_monocular(g, stamp=k / 30.0)[0],
                       ts.track_monocular(g, stamp=k / 30.0)[0]))
        modes.append((js.tracker.state.mode, ts.tracker.state.mode))
    return dict(sc=sc, cfg=cfg, tc=tc, frames=frames, voc=voc, tv=tv, js=js,
                ts=ts, jlog=jlog, tlog=tlog, states=states, modes=modes,
                before=before)


def _copies(m, db):
    """Copies of a JAX map arena and keyframe database, the database on
    the copied arena; the arena's poses in strided arrays
    (tests/test_torch_loop_closing.py)."""
    jm = copy.deepcopy(m)
    jm.on_keyframe_removed = []
    jm.kf_R, jm.kf_t = _copying_views(jm.kf_R), _copying_views(jm.kf_t)
    jdb = copy.deepcopy(db)
    jdb.map = jm
    return jm, jdb


def test_epnp_recovery_matches_jax(kidnap):
    k = kidnap
    sc, js, ts = k["sc"], k["js"], k["ts"]
    for i, ((sj, st), (mj, mt)) in enumerate(zip(k["states"], k["modes"])):
        assert st == sj and mt == mj, (i, sj, st, mj, mt)
    states = [s for s, _ in k["states"]]
    n = len(sc["sched"])
    # OK through the tracked frames (after the initialisation), LOST in
    # the blackout, OK again on the return: through EPnP in both.
    assert states[n - 1] == "OK" and states[n:-1] == ["LOST"] * \
        HOST_MONO_BLACK and states[-1] == "OK", states
    _, n_j, n_t = k["before"]
    assert n_j == n_t == 0
    assert len(k["tlog"].sets) == len(k["jlog"].sets) >= 1
    # The return's centre against the one the session gave the frame (or
    # the mean of the tracked frames on either side, 13 and 16, in the
    # short scene).
    for sysm in (js, ts):
        ref = np.mean([-R.T @ t for _, R, t in (
            sysm.tracker.trajectory[sc["sched"].index(i)]
            for i in sc["ref"])], 0)
        st = sysm.tracker.state
        err = np.linalg.norm(-st.pose_R.T @ st.pose_t - ref)
        assert err < HOST_MONO_RETURN_LIMIT_M, err


def test_relocalizer_on_one_map_matches_jax(kidnap):
    """The JAX System's map as the return frame found it, both
    Relocalizers, the return frame without depth."""
    k = kidnap
    cfg, tc, voc, tv = k["cfg"], k["tc"], k["voc"], k["tv"]
    (jm, jdb), _, _ = k["before"]
    g = k["frames"][k["sc"]["ret"]]
    fj = jframe.process_rgbd(jnp.asarray(g), jnp.zeros(g.shape, jnp.float32),
                             cfg.camera, cfg.orb)
    ft = tframe.FrameData(Features(*(torch.from_numpy(np.array(x))
                                     for x in fj.feats)),
                          *(torch.from_numpy(np.array(x)) for x in fj[1:]))
    ft = ft._replace(feats=ft.feats._replace(level=ft.feats.level.long()))
    words = np.asarray(jvoc.transform_words(voc, fj.feats.desc,
                                            fj.feats.valid)[0])
    jr = JReloc(cfg, jm, jdb)
    tr = TReloc(tc, jm, port_db_of(jdb, tv, jm), device="cpu",
                sampler=JaxDraws(7))
    jlog, tlog = _PnpLog(jr, "_jit_attempt_pnp"), _PnpLog(tr, "_attempt_pnp")
    a, b = jr.relocalize(fj, words), tr.relocalize(ft, words)
    assert a.ok and b.ok, (a.n_inliers, b.n_inliers)
    assert len(tlog.sets) == len(jlog.sets) >= 1
    for x, y in zip(tlog.sets, jlog.sets):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(b.R, a.R, atol=PNP_POSE_TOL)
    np.testing.assert_allclose(b.t, a.t, atol=PNP_POSE_TOL)
    np.testing.assert_array_equal(b.point_ids, a.point_ids)
    assert b.n_inliers == a.n_inliers


def test_mono_sim3_closure_matches_jax(kidnap):
    """[20]'s closure on the JAX System's final map, drifted in scale
    (host_sensor_scenes.drift_late_keyframes), copied for the port: the
    pair, compute_sim3's gates and S12 (its scale 1.2, not 1) within
    1e-4; ``correct`` with the global BA held back: poses and points
    within 1e-4, every other array of the arena equal, loop and fused
    edges equal (tests/test_torch_loop_closing.py's rules)."""
    k = kidnap
    cfg, tc = k["cfg"], k["tc"]
    jm, jdb = _copies(k["js"].map, k["js"].kf_db)
    moved, copies = drift_late_keyframes(jm, **HOST_MONO_LOOP_DRIFT)
    assert moved and len(copies) > 0
    tm = port_arena_of(jm, tc)
    assert_arenas_match(jm, tm, "copy")
    jl = JLoop(cfg, jm, jdb)
    tl = TLoop(tc, tm, port_db_of(jdb, k["tv"], tm), device="cpu",
               sampler=JaxDraws(13))
    jl._global_ba, tl._global_ba = _HeldBack(), _HeldBack()
    a, b = close_drifted_loop(jl, jm), close_drifted_loop(tl, tm)
    assert b["debug"] == a["debug"] and b["pair"] == a["pair"]
    assert a["accepted"] and b["accepted"], a["debug"]
    assert a["pair"][1] == jm.valid_keyframes()[np.argmin(
        jm.kf_seq[jm.valid_keyframes()])]
    assert abs(a["scale"] - HOST_MONO_LOOP_DRIFT["scale"]) < 0.02
    for x, y in zip(b["S"], a["S"]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-4)
    assert tl._global_ba.calls == jl._global_ba.calls == [a["pair"][1]]
    assert tl.loop_edges == jl.loop_edges == [tuple(a["pair"])]
    assert tl._fused_edges == jl._fused_edges
    assert_arenas_match(jm, tm, "correct")

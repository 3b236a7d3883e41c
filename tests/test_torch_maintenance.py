"""Parity of the port's maintenance program (BoW loop closing, the place
bank, relocalization) with the JAX package's, on the CPU.

The state comes from a short JAX session of the 320x240 room of
tests/test_torch_realtime.py that returns to its first pose; it is carried
into the port with ``state_from_numpy`` / ``maint_state_from_numpy``, and
each function runs on both packages from it. RANSAC draws are the
reference's ``jax.random`` indices, injected into the port through its
``sampler`` (a torch generator cannot reproduce them). Decisions, the
event log and the counters must be equal; poses and the trajectory within
1e-4, points within 1e-3 on rows valid in both, BoW scores within 1e-6.
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from coebslam_tpu import config as jcfg
from coebslam_tpu.slam import maintenance as jm, realtime as jrt, \
    vocabulary as jvoc
from coebslam_tpu.utils import synthetic as jsyn
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.slam import maintenance as tm, realtime as trt, \
    vocabulary as tvoc
from coebslam_tpu_torch.utils import synthetic as tsyn

from test_loop_e2e import (DEPTH_BIAS, N_CIRCUIT, N_OVERLAP, circuit_poses,
                           six_wall_room)

torch.set_num_threads(1)
VOCAB = pathlib.Path(__file__).resolve().parents[1] / "artifacts" / \
    "vocab_1e5.npz"
CAM = dict(width=320, height=240, fx=267.7, fy=269.6, cx=160.05, cy=123.8)
JCFG = jcfg.SystemConfig(camera=jcfg.CameraConfig(**CAM),
                         orb=jcfg.OrbConfig(n_levels=4, max_keypoints=1024),
                         tracking=jcfg.TrackingConfig(max_frames_between_kf=3))
LIM = dict(max_kf=8, spawn_per_kf=256, ba_window=4, local_window=3,
           max_frames=64, seed_slots=64, bank_cap=16, bank_landmarks=64)
#: Out along the orbit and back to the first pose: keyframes at poses 0,
#: 6, 12, 10 and 4, the last frame at pose 0 again.
SCHEDULE = (0, 2, 4, 6, 8, 10, 12, 14, 12, 10, 8, 6, 4, 2, 0)
SEED = 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def world():
    jlim = jrt.RTLimits(**LIM)
    step = jax.jit(lambda g, d, b, s, st: jrt.rt_step(g, d, b, s, st, JCFG,
                                                      jlim))
    planes = jsyn.make_room(seed=0)
    poses = jsyn.camera_trajectory(40, radius=0.35)
    no_boxes = jnp.full((16, 4), -1.0)
    st = jrt.init_state(JCFG, jlim)
    for k, i in enumerate(SCHEDULE):
        g, d, _, _ = jsyn.render(JCFG.camera, poses[i], planes)
        st = step(jnp.clip(g, 0, 255).astype(jnp.uint8),
                  (d * JCFG.camera.depth_map_factor).astype(jnp.uint16),
                  no_boxes, np.uint32(k), st)
    voc = jvoc.load(str(VOCAB))
    maint = jm.Maintainer(JCFG, jlim, voc)
    tc = tcfg.config_from_dict(dataclasses.asdict(JCFG))
    tlim = trt.RTLimits(**LIM)
    tmaint = tm.Maintainer(tc, tlim, tvoc.Vocabulary(*voc), device="cpu")
    return dict(st=_np(st), jlim=jlim, maint=maint, voc=voc, tc=tc,
                tlim=tlim, tmaint=tmaint)


@pytest.fixture(scope="module")
def processed(world):
    """The session's state with every keyframe BoW-processed (one JAX
    dispatch from a fresh MaintState) and the tracking marked lost."""
    w = world
    st, ms = w["maint"].step(_j(w["st"]), w["maint"].init_state(),
                             np.uint32(SEED))
    lost = _np(st)._replace(n_lost=np.int32(tm.RELOC_AFTER_LOST))
    lost = lost._replace(track=lost.track._replace(ok=np.bool_(False)))
    return lost, _np(ms)


def _draws(key):
    """The reference's draw for one RANSAC solve from ``key``."""
    def draw(valid):
        logits = jnp.where(jnp.asarray(valid.numpy()), 0.0, -1e9)
        idx = jax.random.categorical(key, logits[None, :], shape=(256, 3))
        return torch.from_numpy(np.array(idx)).long()
    return draw


def _dispatch_sampler(seed):
    k_detect, k_reloc = jax.random.split(jax.random.PRNGKey(seed))

    def sampler(tag, valid):
        if tag[0] == "loop":
            key = jax.random.fold_in(k_detect, tag[1])
        elif tag[0] == "bank":
            key = jax.random.fold_in(k_detect, ~np.int32(tag[1]))
        else:
            key = k_reloc
        return _draws(key)(valid)
    return sampler


def _assert_states_match(js, jms, ts, tms, lim):
    """Decisions and counters equal; poses 1e-4, points 1e-3, BoW 1e-6."""
    js, jms = _np(js), _np(jms)
    tn = lambda x: x.numpy()
    for k in ("n_kf", "n_lost", "reuse_lid", "reuse_ttl", "seed_ttl"):
        assert int(getattr(js, k)) == int(getattr(ts, k)), k
    assert bool(js.track.ok) == bool(ts.track.ok)
    np.testing.assert_array_equal(tn(ts.track.pids), js.track.pids)
    for k in ("R", "t", "vR", "vt"):
        np.testing.assert_allclose(tn(getattr(ts.track, k)),
                                   getattr(js.track, k), atol=1e-4)
    np.testing.assert_allclose(tn(ts.kf_R), js.kf_R, atol=1e-4)
    np.testing.assert_allclose(tn(ts.kf_t), js.kf_t, atol=1e-4)
    np.testing.assert_allclose(tn(ts.traj), js.traj, atol=1e-4)
    np.testing.assert_array_equal(tn(ts.kf_pid), js.kf_pid)
    np.testing.assert_array_equal(tn(ts.pt_valid), js.pt_valid)
    both = tn(ts.pt_valid) & js.pt_valid
    assert np.abs(tn(ts.pt_pos)[both] - js.pt_pos[both]).max(initial=0) \
        <= 1e-3
    np.testing.assert_array_equal(tn(ts.pt_desc), js.pt_desc)
    for k in ("bow_lid", "bow_next", "cand_lid", "streak", "last_loop_lid",
              "n_events", "n_loops", "n_reloc", "bank_lid", "bank_next",
              "bank_bow_i", "bank_desc", "bank_ok", "n_bank_loops",
              "n_bank_reloc"):
        np.testing.assert_array_equal(tn(getattr(tms, k)), getattr(jms, k),
                                      err_msg=k)
    for k, tol in (("kf_bow", 1e-6), ("bank_bow_w", 1e-6), ("loop_log", 1e-4),
                   ("bank_R", 1e-4), ("bank_t", 1e-4), ("bank_pos", 1e-3)):
        np.testing.assert_allclose(tn(getattr(tms, k)), getattr(jms, k),
                                   atol=tol, err_msg=k)


def test_maint_state_carries_over(world):
    jms = _np(world["maint"].init_state())
    tms = tm.maint_state_from_numpy(jms, "cpu")
    fresh = world["tmaint"].init_state()
    for k in tm.MaintState._fields:
        a, b, c = getattr(jms, k), getattr(tms, k), getattr(fresh, k)
        np.testing.assert_array_equal(b.numpy(), a)
        assert b.shape == c.shape and torch.equal(b, c.to(b.dtype)), k


def test_dispatch_processes_keyframes_and_relocalizes(world, processed):
    """A whole dispatch from a fresh MaintState on the lost state: the
    five keyframes get their BoW rows and bank entries, then the ring
    relocalization solves against the first pose and is applied."""
    w = world
    lost, _ = processed
    js, jms = w["maint"].step(_j(lost), w["maint"].init_state(),
                              np.uint32(SEED))
    ts, tms = w["tmaint"].step(trt.state_from_numpy(lost, "cpu"),
                               w["tmaint"].init_state(), SEED,
                               n_kf=int(lost.n_kf), bow_next=0,
                               sampler=_dispatch_sampler(SEED))
    _assert_states_match(js, jms, ts, tms, w["tlim"])
    assert int(tms.bow_next) == 5 and int((tms.bank_lid >= 0).sum()) == 5
    assert int(tms.n_reloc) == 1 and int(tms.n_bank_reloc) == 0
    assert bool(ts.track.ok)


def test_bank_relocalization(world, processed):
    """The ring solve fails (its landmarks invalidated) and every bank
    entry counts as evicted: the bank branch relocalizes and stages its
    landmark subset into the seed arena."""
    w = world
    lost, jms = processed
    PT = LIM["max_kf"] * LIM["spawn_per_kf"]
    pt_valid = lost.pt_valid.copy()
    pt_valid[:PT] = False
    lost = lost._replace(pt_valid=pt_valid)
    jms = jms._replace(bank_lid=np.where(jms.bank_lid >= 0,
                                         jms.bank_lid + LIM["max_kf"], -1)
                       .astype(np.int32))
    n_kf = int(lost.n_kf)
    js, jms2 = w["maint"].step(_j(lost), _j(jms), np.uint32(SEED + 1))
    ts, tms2 = w["tmaint"].step(trt.state_from_numpy(lost, "cpu"),
                                tm.maint_state_from_numpy(jms, "cpu"),
                                SEED + 1, n_kf=n_kf, bow_next=n_kf,
                                sampler=_dispatch_sampler(SEED + 1))
    _assert_states_match(js, jms2, ts, tms2, w["tlim"])
    assert int(tms2.n_bank_reloc) == 1 and int(ts.seed_ttl) == tm.REUSE_TTL
    assert bool(ts.track.ok) and (ts.track.pids >= trt.SEED_BASE).sum() >= 15


@pytest.mark.parametrize("branch", ["ring", "bank"])
def test_close_loop(world, processed, branch):
    """The newest keyframe (pose 4 on the way back) against the first
    keyframe (pose 0): in the ring, or as bank entry 0. Both solves are
    accepted and run the whole correction."""
    w = world
    st, jms = processed
    st = st._replace(track=st.track._replace(ok=np.bool_(True)))
    lid = int(st.n_kf) - 1
    key = jax.random.PRNGKey(11)
    jfn, tfn = ((jm._close_loop, tm._close_loop) if branch == "ring"
                else (jm._close_loop_bank, tm._close_loop_bank))
    cand = int(np.nonzero(st.kf_lid == 0)[0][0]) if branch == "ring" else 0
    js, jms2 = jfn(_j(st), _j(jms), jnp.int32(lid), jnp.int32(cand),
                   jnp.float32(0.5), key, JCFG, w["jlim"])
    ts, tms2 = tfn(trt.state_from_numpy(st, "cpu"),
                   tm.maint_state_from_numpy(jms, "cpu"), lid,
                   torch.tensor(cand), torch.tensor(0.5), w["tc"],
                   w["tlim"], _draws(key))
    _assert_states_match(js, jms2, ts, tms2, w["tlim"])
    ev = w["tmaint"].report(tms2)["loop_events"]
    assert ev == w["maint"].report(jms2)["loop_events"]
    assert len(ev) == 1 and ev[0]["applied"] and ev[0]["cand_lid"] == 0
    moved = np.abs(ts.kf_t.numpy() - st.kf_t).max()
    assert moved > 1e-4                      # the correction did move poses


def test_bow_helpers_match(world):
    rng = np.random.RandomState(0)
    voc = world["voc"]
    n_words = voc.n_words
    words = rng.randint(-1, 2000, 300).astype(np.int32)
    words[:40] = words[40:80]                        # repeated words
    valid = rng.rand(300) < 0.8
    ww = np.asarray(voc.word_weight)
    jb, jh = jm._bow_vector(jnp.asarray(words), jnp.asarray(valid),
                            jnp.asarray(ww), n_words)
    tb, th = tm._bow_vector(torch.from_numpy(words).long(),
                            torch.from_numpy(valid), torch.from_numpy(ww),
                            n_words)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)
    assert bool(th) == bool(jh)
    rows = np.abs(rng.rand(6, n_words).astype(np.float32)) ** 8
    rows /= rows.sum(1, keepdims=True)
    np.testing.assert_allclose(
        tm._l1_scores(tb, torch.from_numpy(rows)).numpy(),
        np.asarray(jm._l1_scores(jb, jnp.asarray(rows))), atol=1e-6)
    idx = np.where(rng.rand(6, 64) < 0.8,
                   rng.choice(words[words >= 0], (6, 64)), -1).astype(np.int32)
    wts = rng.rand(6, 64).astype(np.float32) / 64
    np.testing.assert_allclose(
        tm._sparse_scores(tb, torch.from_numpy(wts),
                          torch.from_numpy(idx).long()).numpy(),
        np.asarray(jm._sparse_scores(jb, jnp.asarray(wts),
                                     jnp.asarray(idx))), atol=1e-6)
    for take in (16, 300):
        js_, jv = jm._compact(jnp.asarray(valid), take)
        ts_, tv = tm._compact(torch.from_numpy(valid), take)
        np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_remap_trajectory_matches():
    rng = np.random.RandomState(1)
    K, F = 8, 40
    from coebslam_tpu.geometry import so3 as jso3
    rot = lambda n: np.array(jso3.exp(jnp.asarray(
        rng.randn(n, 3).astype(np.float32))))
    traj = np.zeros((F, 14), np.float32)
    traj[:, 0] = 1.0
    traj[:, 1:10] = rot(F).reshape(F, 9)
    traj[:, 10:13] = rng.randn(F, 3)
    traj[:, 13] = rng.randint(-1, 12, F)
    kf_lid = np.array([8, 9, 10, 11, 4, 5, -1, 7], np.int32)
    Ro, Rn = rot(K), rot(K)
    to, tn = (rng.randn(K, 3).astype(np.float32) for _ in range(2))
    moved = rng.rand(K) < 0.7
    args = (traj, kf_lid, Ro, to, Rn, tn, moved)
    j = jm._remap_trajectory(*map(jnp.asarray, args), K)
    t = tm._remap_trajectory(*[torch.from_numpy(a) if a.dtype != np.int32
                               else torch.from_numpy(a).long()
                               for a in args], K)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
    assert (np.abs(np.asarray(j) - traj).max(1) > 1e-3).sum() >= 5


def test_loop_scene_matches():
    """six_wall_room and circuit_poses against the JAX scene helpers: same
    poses, and a rendered frame within the renderer test's tolerance."""
    pj = circuit_poses(N_CIRCUIT + N_OVERLAP)
    pt = tsyn.circuit_poses(tsyn.N_CIRCUIT + tsyn.N_OVERLAP)
    assert (tsyn.N_CIRCUIT, tsyn.N_OVERLAP, tsyn.DEPTH_BIAS) == \
        (N_CIRCUIT, N_OVERLAP, DEPTH_BIAS)
    for a, b in zip(pj, pt):
        np.testing.assert_array_equal(b.R.numpy(), np.asarray(a.R))
        np.testing.assert_array_equal(b.t.numpy(), np.asarray(a.t))
    cam_j, cam_t = jcfg.CameraConfig(**CAM), tcfg.CameraConfig(**CAM)
    gj, dj = jsyn.render(cam_j, pj[60], six_wall_room())[:2]
    gt, dt = tsyn.render(cam_t, pt[60], tsyn.six_wall_room(device="cpu"))[:2]
    err = np.abs(gt.numpy() - np.asarray(gj))
    assert (err <= 1e-2).mean() >= 0.999 and err.max() < 5.0
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)

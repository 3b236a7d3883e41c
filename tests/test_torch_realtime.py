"""Parity of the port's realtime RGB-D step with the JAX package, state by
state, through the boot keyframe, later keyframes and their windowed BA;
plus the renderer, and (slow tier) a whole session's ATE.

Each step starts both packages from the same state: the reference's state
before the step, carried over with ``state_from_numpy``. No boxes are
given, so the RANSAC draws (which a torch generator cannot reproduce) do
not touch the state.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from coebslam_tpu import config as jcfg
from coebslam_tpu.slam import realtime as jrt
from coebslam_tpu.utils import synthetic as jsyn
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.eval import ate as tate
from coebslam_tpu_torch.slam import maintenance as tmaint, realtime as trt
from coebslam_tpu_torch.slam import system as tsys, tracking as ttrack
from coebslam_tpu_torch.utils import replica as trep
from coebslam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

CAM = dict(width=320, height=240, fx=267.7, fy=269.6, cx=160.05, cy=123.8)
# The smallest session whose boot gate (>= 500 valid keypoints) fires on
# this scene; a keyframe every 3 frames brings BA into the first frames.
JCFG = jcfg.SystemConfig(camera=jcfg.CameraConfig(**CAM),
                         orb=jcfg.OrbConfig(n_levels=4, max_keypoints=1024),
                         tracking=jcfg.TrackingConfig(max_frames_between_kf=3))
LIM = dict(max_kf=8, spawn_per_kf=256, ba_window=4, local_window=3,
           max_frames=64, seed_slots=64)
N_STEPS = 7


def _frames(n, cam, quad=None):
    planes = jsyn.make_room(seed=0)
    poses = jsyn.camera_trajectory(40, radius=0.35)
    out = []
    for i in range(n):
        g, d, _, _ = jsyn.render(cam, poses[i], planes, quad, i)
        out.append((np.clip(np.asarray(g), 0, 255).astype(np.uint8),
                    (np.asarray(d) * cam.depth_map_factor).astype(np.uint16)))
    return out


def _share(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


def test_rt_step_state_by_state():
    tc = tcfg.config_from_dict(dataclasses.asdict(JCFG))
    jlim, tlim = jrt.RTLimits(**LIM), trt.RTLimits(**LIM)
    step = jax.jit(lambda g, d, b, s, st: jrt.rt_step(g, d, b, s, st, JCFG,
                                                      jlim))
    no_boxes = np.full((16, 4), -1.0, np.float32)
    st_np = jax.tree.map(np.asarray, jrt.init_state(JCFG, jlim))
    n_kf_seen = []
    for i, (g, d) in enumerate(_frames(N_STEPS, JCFG.camera)):
        st_t = trt.rt_step(torch.from_numpy(g), torch.from_numpy(d),
                           torch.from_numpy(no_boxes),
                           trt.state_from_numpy(st_np, "cpu"), tc, tlim,
                           generator=torch.Generator().manual_seed(i))
        st_np = jax.tree.map(np.asarray, step(
            jnp.asarray(g), jnp.asarray(d), jnp.asarray(no_boxes),
            np.uint32(i), jax.tree.map(jnp.asarray, st_np)))
        assert_states_close(st_np, st_t, i)
        n_kf_seen.append(int(st_np.n_kf))
    assert n_kf_seen[0] == 1 and n_kf_seen[-1] >= 3     # boot + 2 BA'd KFs


def assert_states_close(j, t, i, permuted=False):
    """The reference's state ``j`` (numpy leaves) against the port's ``t``
    after the same step: counters equal, poses within 1e-4, point ids
    equal on >= 99 % of keypoints, live points equal on >= 99.5 % of rows
    and within 1e-3 where live on both, trajectory within 1e-4.

    ``permuted``: keypoints that tie in the extractor's slot order may sit
    in other slots, and so spawn into other point rows; then at most 1 % of
    the rows live on both may differ, each within 1e-3 of a live point of
    the reference."""
    tn = lambda x: x.numpy()
    for k in ("n_kf", "frame_idx", "frames_since_kf", "budget",
              "consec_ok", "strong_frames", "n_lost", "n_assoc"):
        assert int(getattr(j, k)) == int(getattr(t, k)), (i, k)
    assert bool(j.track.ok) == bool(t.track.ok)
    assert abs(int(j.peak_inliers) - int(t.peak_inliers)) <= 2
    np.testing.assert_allclose(tn(t.track.R), j.track.R, atol=1e-4)
    np.testing.assert_allclose(tn(t.track.t), j.track.t, atol=1e-4)
    assert _share(tn(t.track.pids), j.track.pids) >= 0.99, i
    np.testing.assert_array_equal(tn(t.kf_lid), j.kf_lid)
    assert _share(tn(t.kf_pid), j.kf_pid) >= 0.99, i
    np.testing.assert_allclose(tn(t.kf_R), j.kf_R, atol=1e-4)
    np.testing.assert_allclose(tn(t.kf_t), j.kf_t, atol=1e-4)
    assert _share(tn(t.pt_valid), j.pt_valid) >= 0.995, i
    both = tn(t.pt_valid) & j.pt_valid
    err = np.abs(tn(t.pt_pos)[both] - j.pt_pos[both]).max(1)
    off = err > 1e-3
    if permuted and off.any():
        ref = j.pt_pos[j.pt_valid]
        moved = tn(t.pt_pos)[both][off]
        nearest = np.abs(moved[:, None] - ref[None]).max(-1).min(1)
        assert off.mean() <= 0.01 and nearest.max() <= 1e-3, i
    else:
        assert err.max(initial=0) <= 1e-3, i
    np.testing.assert_allclose(tn(t.traj), j.traj, atol=1e-4)
    np.testing.assert_array_equal(tn(t.dyn.sticky), j.dyn.sticky)


def test_state_from_numpy_round_trip():
    st = jax.tree.map(np.asarray, jrt.init_state(JCFG, jrt.RTLimits(**LIM)))
    t = trt.state_from_numpy(st, "cpu")
    fresh = trt.init_state(tcfg.config_from_dict(dataclasses.asdict(JCFG)),
                           trt.RTLimits(**LIM), "cpu")
    for a, b in zip(jax.tree.leaves(st), torch.utils._pytree.tree_leaves(t)):
        np.testing.assert_array_equal(b.numpy(), a)
    for a, b in zip(torch.utils._pytree.tree_leaves(fresh),
                    torch.utils._pytree.tree_leaves(t)):
        assert a.shape == b.shape and torch.equal(a, b.to(a.dtype))


def test_ring_helpers_match():
    rng = np.random.RandomState(0)
    a = rng.randn(10, 3).astype(np.float32)
    chunk = rng.randn(4, 3).astype(np.float32)
    for k in (0, 3, 8):
        np.testing.assert_array_equal(
            trt._rotate(torch.from_numpy(a), torch.tensor(k)).numpy(),
            np.asarray(jrt._rotate(jnp.asarray(a), k)))
        np.testing.assert_array_equal(
            trt._unrotate_update(torch.from_numpy(a), torch.from_numpy(chunk),
                                 torch.tensor(k)).numpy(),
            np.asarray(jrt._unrotate_update(jnp.asarray(a),
                                            jnp.asarray(chunk), k)))
    lim = jrt.RTLimits(**LIM)
    kf_lid = np.array([8, 1, 2, -1, 4, 5, 6, 7])
    pids = np.array([-1, 0, 5, 300, 8 * 256 + 3, 2 * 256, jrt.SEED_BASE + 7])
    np.testing.assert_array_equal(
        trt.pid_phys(torch.from_numpy(pids), trt.RTLimits(**LIM)).numpy(),
        np.asarray(jrt.pid_phys(jnp.asarray(pids), lim)))
    for seed_ok in (False, True):
        np.testing.assert_array_equal(
            trt.pid_alive(torch.from_numpy(pids), torch.from_numpy(kf_lid),
                          trt.RTLimits(**LIM), seed_ok=seed_ok).numpy(),
            np.asarray(jrt.pid_alive(jnp.asarray(pids), jnp.asarray(kf_lid),
                                     lim, seed_ok=seed_ok)))


def test_renderer_matches():
    """Same room, walker and pose: grey within 1e-2 on 99.9% of pixels
    (texture lookups at cell boundaries may round to the other texel),
    depth within 1e-5 relative, identical box and walker mask."""
    cam_j = jcfg.CameraConfig(**CAM)
    cam_t = tcfg.CameraConfig(**CAM)
    kw = dict(start=(-0.9, -0.2, 1.8), velocity=(0.012, 0.004, 0.0),
              half_w=0.3, half_h=0.65)
    pj = jsyn.camera_trajectory(150, radius=0.35)[17]
    pt = tsyn.camera_trajectory(150, radius=0.35)[17]
    np.testing.assert_array_equal(pt.R.numpy(), np.asarray(pj.R))
    gj, dj, bj, mj = jsyn.render(cam_j, pj, jsyn.make_room(seed=0),
                                 jsyn.make_walker(**kw), 17)
    gt, dt, bt, mt = tsyn.render(cam_t, pt,
                                 tsyn.make_room(seed=0, device="cpu"),
                                 tsyn.make_walker(**kw, device="cpu"), 17)
    err = np.abs(gt.numpy() - np.asarray(gj))
    assert (err <= 1e-2).mean() >= 0.999 and err.max() < 5.0
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert np.asarray(mj).sum() > 1000


@pytest.mark.parametrize("entry", [
    lambda: trt.RealtimeSlam(tcfg.SystemConfig()),
    lambda: trt.RealtimeSlam(tcfg.SystemConfig(sensor="stereo")),
    lambda: trt.RealtimeSlam(tcfg.SystemConfig(sensor="monocular")),
    lambda: tsyn.make_room(seed=0),
    lambda: tsyn.make_walker(),
    lambda: tsyn.dynamic_orbit(tcfg.CameraConfig(), 1),
    lambda: tmaint.Maintainer(tcfg.SystemConfig(), trt.RTLimits(), None),
    lambda: tsyn.six_wall_room(),
    lambda: tsys.System(tcfg.SystemConfig()),
    lambda: ttrack.Tracker(tcfg.SystemConfig()),
    lambda: next(trep.generate(n_frames=4)),
], ids=["RealtimeSlam", "RealtimeSlam_stereo", "RealtimeSlam_mono",
        "make_room", "make_walker", "dynamic_orbit",
        "Maintainer", "six_wall_room", "System", "Tracker",
        "replica_generate"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """With no device given, an entry point runs on CUDA, and raises where
    CUDA is absent: there is no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


@pytest.mark.slow
def test_realtime_session_tracks_full_width():
    """Full width (SystemConfig() and RTLimits() defaults) on the 40-frame
    room of tests/test_realtime.py: every frame OK, ATE under 2 cm."""
    cfg = tcfg.SystemConfig()
    frames = _frames(40, jcfg.SystemConfig().camera)
    poses = tsyn.camera_trajectory(40, radius=0.35)
    rt = trt.RealtimeSlam(cfg, trt.RTLimits(max_kf=16), device="cpu")
    for i, (g, d) in enumerate(frames):
        rt.track(g, d, stamp=i / 30.0)
    res = rt.finish()
    assert res["ok"].all()
    est = np.asarray([-R.T @ t for R, t in zip(res["R"], res["t"])])
    gt = np.asarray([-p.R.numpy().T @ p.t.numpy() for p in poses])
    stamps = np.arange(40) / 30.0
    assert tate.ate_rmse(stamps, est, stamps, gt)["rmse"] < 0.02

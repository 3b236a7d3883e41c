"""Parity of the port's realtime stereo path with the JAX package on the
CPU: the row-band stereo matcher and frame constructor, the stereo
``rt_step`` state by state, and (slow tier) the JAX package's end-to-end
stereo gates on the port.

Frames are 320x240 renders of the room (left view, and the right view from
the pose shifted by the baseline, as ``tests/test_stereo_checkpoint.py``
makes them), at 4 levels and 1024 keypoints. No boxes are given to the
step, so the RANSAC draws (which a torch generator cannot reproduce) do
not touch the state.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from coebslam_tpu import config as jcfg
from coebslam_tpu.geometry.se3 import SE3 as JSE3
from coebslam_tpu.slam import frame as jframe, realtime as jrt
from coebslam_tpu.utils import synthetic as jsyn
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.eval import ate as tate
from coebslam_tpu_torch.ops.extractor import Features as TFeatures
from coebslam_tpu_torch.slam import frame as tframe, realtime as trt
from coebslam_tpu_torch.utils import replica as trep, synthetic as tsyn
from chip_smoke import stereo_scene
from test_torch_realtime import CAM, LIM, assert_states_close

torch.set_num_threads(1)

JCFG = jcfg.SystemConfig(camera=jcfg.CameraConfig(**CAM),
                         orb=jcfg.OrbConfig(n_levels=4, max_keypoints=1024),
                         tracking=jcfg.TrackingConfig(max_frames_between_kf=3),
                         sensor="stereo")
TCFG = tcfg.config_from_dict(dataclasses.asdict(JCFG))
N_STEPS = 7


def _pairs(n, cam, radius=0.35):
    """(left, right) float32 grey images of the first n poses of the orbit."""
    planes = jsyn.make_room(seed=0)
    poses = jsyn.camera_trajectory(40, radius=radius)
    shift = np.asarray([cam.baseline, 0.0, 0.0], np.float32)
    out = []
    for p in poses[:n]:
        gl = jsyn.render(cam, p, planes, None, 0)[0]
        gr = jsyn.render(cam, JSE3(p.R, jnp.asarray(np.asarray(p.t) - shift)),
                         planes, None, 0)[0]
        out.append((np.asarray(gl, np.float32), np.asarray(gr, np.float32)))
    return out


@pytest.fixture(scope="module")
def pair():
    return _pairs(1, JCFG.camera)[0]


def test_process_stereo_matches(pair):
    """Features equal (valid, uv within 1e-4, descriptors bit-equal on
    >= 99.5 % of keypoints), match validity equal on >= 99.5 % of
    keypoints, depth within 1e-4 relative
    and ur within 1e-4 where both matched."""
    gl, gr = pair
    fdj = jax.jit(lambda a, b: jframe.process_stereo(
        a, b, JCFG.camera, JCFG.orb))(jnp.asarray(gl), jnp.asarray(gr))
    fdt = tframe.process_stereo(torch.from_numpy(gl), torch.from_numpy(gr),
                                TCFG.camera, TCFG.orb)
    vj = np.asarray(fdj.feats.valid)
    np.testing.assert_array_equal(fdt.feats.valid.numpy(), vj)
    assert np.abs(fdt.feats.uv.numpy() - np.asarray(fdj.feats.uv))[vj].max() \
        <= 1e-4
    # Orientations differ by up to ~4e-5 rad (atan2 of two libraries),
    # which can move one steered BRIEF sample across a pixel boundary: on
    # this pair one bit of one descriptor of 1002.
    same = (fdt.feats.desc.numpy() == np.asarray(fdj.feats.desc)).all(1)
    assert same[vj].mean() >= 0.995
    mj, mt = np.asarray(fdj.depth) > 0, fdt.depth.numpy() > 0
    assert mj.sum() > 200
    assert (mj == mt).mean() >= 0.995
    both = mj & mt
    np.testing.assert_allclose(fdt.depth.numpy()[both],
                               np.asarray(fdj.depth)[both], rtol=1e-4)
    np.testing.assert_allclose(fdt.ur.numpy()[both], np.asarray(fdj.ur)[both],
                               atol=1e-4)
    np.testing.assert_allclose(fdt.inv_sigma2.numpy(),
                               np.asarray(fdj.inv_sigma2), rtol=1e-6)


def test_match_stereo_matches_on_the_same_features(pair):
    """The matcher alone, fed the JAX package's own left and right
    features: the same matches, depth and ur."""
    gl, gr = pair
    ext = jax.jit(lambda a: jframe.extractor.extract(a, JCFG.orb))
    fl, fr = ext(jnp.asarray(gl)), ext(jnp.asarray(gr))
    dj, urj = jframe.match_stereo(fl, fr, JCFG.camera, JCFG.orb)
    conv = lambda f: TFeatures(**{k: trt._to_tensor(getattr(f, k), "cpu")
                                  for k in TFeatures._fields})
    dt, urt = tframe.match_stereo(conv(fl), conv(fr), TCFG.camera, TCFG.orb)
    np.testing.assert_array_equal(dt.numpy() > 0, np.asarray(dj) > 0)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)
    np.testing.assert_allclose(urt.numpy(), np.asarray(urj), atol=1e-5)
    assert (np.asarray(dj) > 0).sum() > 200


def test_rt_step_stereo_state_by_state():
    """Seven stereo frames, each from the reference's state before it:
    the checks of ``test_rt_step_state_by_state``."""
    jlim, tlim = jrt.RTLimits(**LIM), trt.RTLimits(**LIM)
    step = jax.jit(lambda g, d, b, s, st: jrt.rt_step(g, d, b, s, st, JCFG,
                                                      jlim))
    no_boxes = np.full((16, 4), -1.0, np.float32)
    st_np = jax.tree.map(np.asarray, jrt.init_state(JCFG, jlim))
    n_kf_seen = []
    for i, (gl, gr) in enumerate(_pairs(N_STEPS, JCFG.camera)):
        st_t = trt.rt_step(torch.from_numpy(gl), torch.from_numpy(gr),
                           torch.from_numpy(no_boxes),
                           trt.state_from_numpy(st_np, "cpu"), TCFG, tlim,
                           generator=torch.Generator().manual_seed(i))
        st_np = jax.tree.map(np.asarray, step(
            jnp.asarray(gl), jnp.asarray(gr), jnp.asarray(no_boxes),
            np.uint32(i), jax.tree.map(jnp.asarray, st_np)))
        # Frame 3 holds three keypoints that tie in the extractor's slot
        # order: the port lists them in another order, and their spawned
        # points in other rows.
        assert_states_close(st_np, st_t, i, permuted=True)
        same = np.abs(st_t.fr_uv.numpy() - st_np.fr_uv).max(1) <= 1e-4
        assert same.mean() >= 0.99
        np.testing.assert_allclose(st_t.fr_depth.numpy()[same],
                                   st_np.fr_depth[same], rtol=1e-4)
        n_kf_seen.append(int(st_np.n_kf))
    assert n_kf_seen[0] == 1 and n_kf_seen[-1] >= 3


def test_replica_trajectory_and_blur_match():
    """The walking trajectory and the box blur are the JAX package's."""
    from coebslam_tpu.utils import replica as jrep
    for pj, pt in zip(jrep.walking_trajectory(40, seed=3),
                      trep.walking_trajectory(40, seed=3)):
        np.testing.assert_array_equal(pt.R.numpy(), np.asarray(pj.R))
        np.testing.assert_array_equal(pt.t.numpy(), np.asarray(pj.t))
    img = np.random.RandomState(0).rand(48, 64).astype(np.float32) * 255
    for k in (1, 4, 9):
        np.testing.assert_array_equal(trep.box_blur(img, k),
                                      jrep._box_blur(img, k))


@pytest.mark.slow
class TestStereoGates:
    """The JAX package's realtime stereo gates on the port, on the CPU."""

    def test_realtime_stereo_tracks(self):
        """tests/test_realtime.py::test_realtime_stereo_tracks: 24 frames
        at full width, every frame tracked, > 150 points, ATE < 3 cm."""
        cfg = tcfg.SystemConfig(sensor="stereo")
        planes = tsyn.make_room(seed=0, device="cpu")
        poses = tsyn.camera_trajectory(24, radius=0.3)
        shift = torch.tensor([cfg.camera.baseline, 0.0, 0.0])
        rt = trt.RealtimeSlam(cfg, trt.RTLimits(max_kf=16, local_window=6,
                                                ba_window=6, max_frames=64),
                              device="cpu")
        for i, p in enumerate(poses):
            gl = tsyn.render(cfg.camera, p, planes, None, i)[0]
            gr = tsyn.render(cfg.camera, type(p)(p.R, p.t - shift), planes,
                             None, i)[0]
            rt.track_stereo(gl, gr, stamp=i / 30.0)
        res = rt.finish()
        assert res["ok"].all(), f"{int(res['ok'].sum())}/24"
        assert res["pt_valid"].sum() > 150
        est = np.asarray([-R.T @ t for R, t in zip(res["R"], res["t"])])
        gt = np.asarray([-p.R.numpy().T @ p.t.numpy() for p in poses])
        stamps = np.arange(24) / 30.0
        assert tate.ate_rmse(stamps, est, stamps, gt)["rmse"] < 0.03

    def test_wide_baseline_stereo_realtime(self):
        """tests/test_stereo_wide.py: bf 160, the walker and its boxes, a
        blur window; >= 115 of 120 frames tracked, ATE < 5 cm."""
        cfg = tcfg.SystemConfig(
            camera=tcfg.CameraConfig(bf=160.0),
            orb=tcfg.OrbConfig(max_keypoints=1024, n_levels=4,
                               n_features=1000),
            tracking=tcfg.TrackingConfig(max_frames_between_kf=10),
            sensor="stereo")
        frames, gt = stereo_scene(torch, tsyn, trep, cfg.camera, "cpu")
        lim = trt.RTLimits(max_kf=32, spawn_per_kf=256, ba_window=6,
                           local_window=6, max_frames=256)
        rt = trt.RealtimeSlam(cfg, lim, device="cpu")
        for i, (gl, gr, boxes) in enumerate(frames):
            rt.track_stereo(gl, gr, stamp=i / 30.0, boxes=boxes)
        res = rt.finish()
        n = len(frames)
        assert res["ok"].sum() >= n - 5, f"{int(res['ok'].sum())}/{n}"
        est = np.asarray([-R.T @ t for R, t in zip(res["R"], res["t"])])
        r = tate.ate_rmse(res["stamps"], est, np.arange(n) / 30.0, gt)
        assert r["rmse"] < 0.05, r["rmse"]

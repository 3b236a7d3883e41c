"""Parity of the port's host ``System`` (RGB-D) with the JAX package on the
CPU: the walker scene of ``tests/test_dynamic_e2e.py`` through
``track_rgbd`` with the walker's boxes, from the conservative
initialisation on, with the reference's F-RANSAC draws injected through
``System(sampler=)`` (a torch generator cannot reproduce ``jax.random``);
held frame by frame by the rules of ``tests/test_torch_host_tracking.py``.
Also the trajectory writers, localization mode, the reset after an early
loss and the wiring of the BoW half (``vocabulary=``)."""
import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from coebslam_tpu.slam import vocabulary as jvoc
from coebslam_tpu.slam.system import System as JSystem
from coebslam_tpu.utils import synthetic as jsyn
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.slam import system as tsys
from test_dynamic_e2e import dyn_config
from test_torch_dynamic import _jax_indices
from test_torch_host_tracking import (assert_arenas_close,
                                      assert_tracker_states_equal)

torch.set_num_threads(2)

N_FRAMES = 10


def jax_sampler(seed, valid):
    """The reference's draws of the frame seeded ``seed``."""
    return _jax_indices(valid.cpu().numpy(), jax.random.PRNGKey(seed))


def walker_frames(cfg, n):
    planes = jsyn.make_room(seed=0)
    quad = jsyn.make_walker(start=(-0.6, -0.15, 1.6),
                            velocity=(0.04, 0.025, 0.0),
                            half_w=0.3, half_h=0.65)
    poses = jsyn.camera_trajectory(2 * 25, radius=0.35)[:n]
    render = jax.jit(lambda p, i: jsyn.render(cfg.camera, p, planes, quad,
                                              i)[:3])
    out = []
    for i, p in enumerate(poses):
        g, d, b = render(p, jnp.asarray(i, jnp.float32))
        out.append((np.asarray(g), np.asarray(d), np.asarray(b)[None]))
    return out


@pytest.fixture(scope="module")
def walker_run():
    cfg = dyn_config(True)
    tc = tcfg.config_from_dict(dataclasses.asdict(cfg))
    js = JSystem(cfg)
    ts = tsys.System(tc, device="cpu", sampler=jax_sampler)
    frames = walker_frames(cfg, N_FRAMES)
    dyn = []
    for i, (g, d, b) in enumerate(frames):
        rj = js.track_rgbd(g, d, stamp=i / 30.0, boxes=b)
        rt = ts.track_rgbd(g, d, stamp=i / 30.0, boxes=b)
        assert rt == rj, (i, rj, rt)
        assert_tracker_states_equal(js.tracker.state, ts.tracker.state, i)
        assert ts.tracker.ref_kf == js.tracker.ref_kf
        assert_arenas_close(js.map, ts.map, i)
        if i == 0:
            assert ts.last_dynamic is None     # conservative initialisation
            continue
        a, b_ = js.last_dynamic, ts.last_dynamic
        np.testing.assert_array_equal(b_.box_dynamic, a.box_dynamic)
        np.testing.assert_array_equal(b_.box_blurred, a.box_blurred)
        assert abs(b_.n_outliers - a.n_outliers) <= 2, i
        assert abs(b_.n_culled - a.n_culled) <= 2, i
        assert (b_.mask != a.mask).mean() <= 1e-3, i
        dyn.append(bool(a.box_dynamic[0]))
    return js, ts, dyn


def test_walker_scene_frame_by_frame(walker_run):
    js, ts, dyn = walker_run
    assert any(dyn), "the walker is never classified dynamic"
    assert js.map.n_kf >= 2
    assert ts.metrics.summary()["lost_frames"] == 0
    np.testing.assert_array_equal(ts.get_tracked_map_points().shape,
                                  js.get_tracked_map_points().shape)


def test_trajectory_writers_same_text(walker_run, tmp_path):
    """The same trajectory records and keyframe poses give the same TUM,
    keyframe-TUM and KITTI text."""
    js, ts, _ = walker_run
    ts.tracker.traj_relative = list(js.tracker.traj_relative)
    for k in ("kf_R", "kf_t", "kf_seq", "kf_valid", "kf_stamp"):
        getattr(ts.map, k)[:] = getattr(js.map, k)
    for name in ("save_trajectory_tum", "save_keyframe_trajectory_tum",
                 "save_trajectory_kitti"):
        pj, pt = tmp_path / f"j_{name}.txt", tmp_path / f"t_{name}.txt"
        getattr(js, name)(str(pj))
        getattr(ts, name)(str(pt))
        assert pt.read_text() == pj.read_text(), name
    from coebslam_tpu_torch.io import trajectory
    stamps, xyzq = trajectory.load_tum(str(tmp_path / "t_save_trajectory_tum"
                                               ".txt"))
    assert len(stamps) == N_FRAMES
    M = trajectory.tum_to_matrices(xyzq)
    for (_, R, t), m in zip(js.tracker.export_trajectory(), M):
        np.testing.assert_allclose(m[:3, :3], R.T, atol=1e-5)
        np.testing.assert_allclose(m[:3, 3], -R.T @ t, atol=1e-5)


def _static_frames(cfg, n):
    planes = jsyn.make_room(seed=0)
    poses = jsyn.camera_trajectory(30, radius=0.35)[:n]
    render = jax.jit(lambda p: jsyn.render(cfg.camera, p, planes)[:2])
    return [tuple(np.asarray(x) for x in render(p)) for p in poses]


def test_localization_mode_inserts_no_keyframe():
    cfg = dyn_config(False)
    tc = tcfg.config_from_dict(dataclasses.asdict(cfg))
    ts = tsys.System(tc, device="cpu")
    frames = _static_frames(cfg, 6)
    for i, (g, d) in enumerate(frames[:3]):
        ts.track_rgbd(g, d, stamp=i / 30.0)
    n_kf, n_pt = ts.map.n_kf, len(ts.map.valid_points())
    ts.activate_localization_mode()
    for i, (g, d) in enumerate(frames[3:], start=3):
        assert ts.track_rgbd(g, d, stamp=i / 30.0)[0] == "OK"
    assert (ts.map.n_kf, len(ts.map.valid_points())) == (n_kf, n_pt)
    assert ts.get_tracking_state() == "OK"
    ts.deactivate_localization_mode()
    assert not ts.tracker.localization_only


def test_reset_after_early_loss():
    """Lost with fewer than ``reset_if_lost_with_kfs_below`` keyframes: the
    map is cleared and the system initialises again, as in the reference;
    the trajectory keeps every frame."""
    cfg = dyn_config(False)
    tc = tcfg.config_from_dict(dataclasses.asdict(cfg))
    frames = _static_frames(cfg, 2)
    black = (np.zeros_like(frames[0][0]), np.zeros_like(frames[0][1]))
    seq = [frames[0], black, frames[1]]
    js, ts = JSystem(cfg), tsys.System(tc, device="cpu")
    out_j, out_t = [], []
    for i, (g, d) in enumerate(seq):
        out_j.append(js.track_rgbd(g, d, stamp=i / 30.0))
        out_t.append(ts.track_rgbd(g, d, stamp=i / 30.0))
    assert out_t == out_j
    assert out_t[1][0] == "LOST"
    assert ts.map.n_kf == js.map.n_kf == 1       # re-initialised on frame 2
    assert len(ts.tracker.trajectory) == len(js.tracker.trajectory) == 3


def test_vocabulary_wires_the_bow_half():
    """``vocabulary=`` makes the keyframe database (its eraser listening
    to the arena), the relocalizer as the tracker's ``reloc_fn`` and the
    loop closer with the mapper, all on the System's arena and device, as
    the JAX System wires them; without it all three are None."""
    from coebslam_tpu_torch.slam import vocabulary as tvoc
    cfg = dyn_config(False)
    tc = tcfg.config_from_dict(dataclasses.asdict(cfg))
    rng = np.random.RandomState(0)
    voc = tvoc.train(rng.randint(0, 256, (400, 32)).astype(np.uint8),
                     branching=4, depth=2)
    ts = tsys.System(tc, device="cpu", vocabulary=voc)
    js = JSystem(cfg, vocabulary=jvoc.Vocabulary(*voc))
    for s in (js, ts):
        assert s.kf_db.map is s.map and s.kf_db.voc.n_words == voc.n_words
        assert s.kf_db.erase in s.map.on_keyframe_removed
        assert s.relocalizer.map is s.map and s.relocalizer.db is s.kf_db
        assert s.loop_closer.map is s.map and s.loop_closer.db is s.kf_db
        assert s.loop_closer.mapper is s.mapper
        assert s.tracker.reloc_fn is not None
    assert ts.relocalizer.device == ts.loop_closer.device == ts.device
    frames = _static_frames(cfg, 3)
    for i, (g, d) in enumerate(frames):
        assert ts.track_rgbd(g, d, stamp=i / 30.0)[0] == "OK"
    assert ts.kf_db.registered.sum() == ts.map.n_kf >= 1
    bare = tsys.System(tc, device="cpu")
    assert (bare.kf_db, bare.relocalizer, bare.loop_closer) == (None,) * 3

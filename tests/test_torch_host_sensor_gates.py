"""The JAX package's end-to-end gates of the host stereo and monocular
entries and of the flow motion check, on the port (CPU, the tests' ORB
cut of 1024 keypoints on 4 levels): ``tests/test_stereo_checkpoint.py::
test_stereo_tracking_e2e``, ``tests/test_monocular.py::TestMonocularE2E``
and ``TestMonocularRelocalization``, ``tests/test_dynamic_ops.py::
TestDynamicFrontend`` and ``tests/test_dynamic_e2e.py`` with
``motion_check="flow"``. The port draws its own RANSAC samples (but for
the single flow-check call, which takes the reference's), so these hold
the gates, not the JAX package's values. Slow: minutes on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch
import jax

from host_sensor_scenes import (HOST_MONO_ORBIT, HOST_MONO_TRACK,
                                HOST_MONO_VOCAB, HOST_MONO_VOCAB_FRAMES,
                                host_mono_config, host_mono_failures,
                                host_stereo_config, pose_centres,
                                run_host_mono, traj_ate)
from host_bow_scenes import scene_vocabulary
from coebslam_tpu_torch import config
from coebslam_tpu_torch.eval import ate
from coebslam_tpu_torch.ops import extractor
from coebslam_tpu_torch.slam import dynamic, vocabulary
from coebslam_tpu_torch.slam.system import System
from coebslam_tpu_torch.utils import synthetic
from test_torch_dynamic import _jax_indices

pytestmark = pytest.mark.slow

torch.set_num_threads(2)


def test_stereo_tracking_e2e():
    cfg = host_stereo_config(config, full=False)
    planes = synthetic.make_room(seed=0, device="cpu")
    poses = synthetic.camera_trajectory(40, radius=0.35)[:12]
    shift = torch.tensor([cfg.camera.baseline, 0.0, 0.0])
    sysm = System(cfg, device="cpu")
    states = []
    for i, p in enumerate(poses):
        gl = synthetic.render(cfg.camera, p, planes)[0]
        gr = synthetic.render(cfg.camera, p._replace(t=p.t - shift),
                              planes)[0]
        states.append(sysm.track_stereo(gl, gr, stamp=i / 30.0)[0])
    assert states[0] == "OK"
    assert states.count("OK") >= len(states) - 1, states


def _mono_frames(cfg, n):
    planes = synthetic.make_room(seed=0, device="cpu")
    poses = synthetic.camera_trajectory(**HOST_MONO_ORBIT)[:n]
    return [synthetic.render(cfg.camera, p, planes)[0] for p in poses], poses


class TestMonocularE2E:
    def test_tracks_and_maps(self):
        cfg = dataclasses.replace(
            host_mono_config(config, full=False),
            tracking=config.TrackingConfig(max_frames_between_kf=10))
        frames, poses = _mono_frames(cfg, 25)
        sysm = System(cfg, device="cpu")
        states = [sysm.track_monocular(g, stamp=i / 30.0)[0]
                  for i, g in enumerate(frames)]
        assert "OK" in states, states
        first = states.index("OK")
        assert first <= 10, states
        assert states[first:].count("OK") >= len(states[first:]) - 3
        assert len(sysm.map.valid_points()) > 100
        rmse = traj_ate(ate, sysm.tracker.trajectory, pose_centres(poses),
                        first, with_scale=True)
        assert rmse < 0.25, rmse


class TestMonocularRelocalization:
    def test_kidnap_and_relocalize_depth_free(self):
        """Initialise and map, go LOST on black frames, come back to frame
        12: OK within 15 cm of where the System had it, with no depth
        anywhere."""
        cfg = host_mono_config(config, full=False)
        frames, poses = _mono_frames(cfg, HOST_MONO_TRACK)
        descs = []
        for i in HOST_MONO_VOCAB_FRAMES:
            f = extractor.extract(frames[i], cfg.orb)
            descs.append(f.desc[f.valid].numpy())
        voc = scene_vocabulary(vocabulary, descs, **HOST_MONO_VOCAB)
        sysm = System(cfg, device="cpu", vocabulary=voc)
        s = run_host_mono(sysm, frames, torch.zeros_like(frames[0]),
                          pose_centres(poses), ate)
        assert not host_mono_failures(s), s


def test_flow_frontend_flags_walker():
    """TestDynamicFrontend: a quad walking in the room at 320x240, its box
    dynamic and a static decoy not; the mask covers the dynamic box. This
    is one call, so it takes the reference's F-RANSAC draws (its key 0):
    the T_M count sits at the gate's edge in both packages (over the seeds
    0-7, 5 outliers on one and 6 on the others, in each), and the test
    holds the reference's own case."""
    cfg = config.SystemConfig(
        camera=config.CameraConfig(width=320, height=240, fx=267.7,
                                   fy=269.6, cx=160.0, cy=120.0),
        dynamic=config.DynamicConfig(n_flow_points=512))
    planes = synthetic.make_room(seed=0, device="cpu")
    quad = synthetic.make_walker(start=(0.3, 0.0, 1.4),
                                 velocity=(0.03, 0.03, 0.0), device="cpu")
    poses = synthetic.camera_trajectory(60, radius=0.2)
    g0 = synthetic.render(cfg.camera, poses[0], planes, quad, 0)[0]
    g1, _, b1, _ = synthetic.render(cfg.camera, poses[1], planes, quad, 1)
    boxes = torch.stack([b1, torch.tensor([20.0, 20.0, 90.0, 100.0]),
                         torch.full((4,), -1.0)])
    key = jax.random.PRNGKey(0)
    res = dynamic.dynamic_frontend(
        g0, g1, boxes, cfg,
        idx=lambda valid: _jax_indices(valid.numpy(), key))
    assert int(res.n_outliers) > 5
    assert res.box_dynamic.tolist() == [True, False, False]
    bb = b1.numpy().astype(int)
    assert bool(res.mask[(bb[1] + bb[3]) // 2, (bb[0] + bb[2]) // 2])
    assert not bool(res.mask[30, 30])


@pytest.fixture(scope="module")
def flow_run():
    """tests/test_dynamic_e2e.py's run_sequence with the flow check."""
    cfg = config.SystemConfig(
        camera=config.CameraConfig(),
        orb=config.OrbConfig(max_keypoints=1024, n_levels=4,
                             n_features=1000),
        map=config.MapConfig(max_keyframes=64, max_points=16384),
        tracking=config.TrackingConfig(max_frames_between_kf=10),
        dynamic=config.DynamicConfig(n_flow_points=512, motion_check="flow"),
        use_dynamic_filtering=True)
    planes = synthetic.make_room(seed=0, device="cpu")
    quad = synthetic.make_walker(start=(-0.6, -0.15, 1.6),
                                 velocity=(0.04, 0.025, 0.0), half_w=0.3,
                                 half_h=0.65, device="cpu")
    poses = synthetic.camera_trajectory(50, radius=0.35)[:25]
    sysm = System(cfg, device="cpu")
    states = []
    for i, p in enumerate(poses):
        g, d, box, _ = synthetic.render(cfg.camera, p, planes, quad, i)
        states.append(sysm.track_rgbd(g, d, stamp=i / 30.0,
                                      boxes=box[None])[0])
    rmse = traj_ate(ate, sysm.tracker.trajectory, pose_centres(poses))
    return rmse, states, sysm


def test_flow_filtered_tracks_accurately(flow_run):
    rmse, states, _ = flow_run
    assert rmse < 0.02, rmse
    assert states.count("LOST") <= 2


def test_flow_mask_excludes_walker_keypoints(flow_run):
    _, _, sysm = flow_run
    dres = sysm.last_dynamic
    lf = sysm.tracker.last_frame
    m = dres.mask
    if m.any():
        uv = lf.uv[lf.valid]
        inside = m[np.clip(uv[:, 1].astype(int), 0, 479),
                   np.clip(uv[:, 0].astype(int), 0, 639)]
        assert inside.mean() < 0.05

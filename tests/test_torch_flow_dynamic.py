"""Parity of the port's flow motion check (``motion_check="flow"``) with the
JAX package on the CPU: ``moving_object_check`` and ``dynamic_frontend`` on
the scene of ``tests/test_dynamic_ops.py::TestDynamicFrontend`` with the
reference's F-RANSAC draws injected (a torch generator cannot reproduce
``jax.random``), ``BlurGate`` as ``tests/test_io_viz.py::TestBlurGate``
drives it and on a pair pushed through both packages, and ``System``
with the flow check frame by frame on the walker scene of
``tests/test_dynamic_e2e.py``.

Tolerances: tracked points within 1e-2 px, the T_M set, masks, box flags
and area flags equal; BlurGate's emits equal and its motion and sharpness
within 1e-3 relative; the System held by the rules of
``tests/test_torch_host_tracking.py``."""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from coebslam_tpu.config import CameraConfig, DynamicConfig, SystemConfig
from coebslam_tpu.models.detector import BlurGate as JBlurGate
from coebslam_tpu.slam import dynamic as jdyn
from coebslam_tpu.slam.system import System as JSystem
from coebslam_tpu.utils import synthetic as jsyn
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.models.detector import BlurGate
from coebslam_tpu_torch.slam import dynamic as tdyn
from coebslam_tpu_torch.slam import system as tsys
from test_dynamic_e2e import dyn_config
from test_torch_dynamic import _jax_indices
from test_torch_host_tracking import (assert_arenas_close,
                                      assert_tracker_states_equal)
from test_torch_system import walker_frames

torch.set_num_threads(2)


def flow_key(k):
    """The key of the JAX System's k-th flow check (k >= 1): splits of
    PRNGKey(0)."""
    rng = jax.random.PRNGKey(0)
    for _ in range(k):
        rng, key = jax.random.split(rng)
    return key


def flow_sampler(seed, valid):
    return _jax_indices(valid.cpu().numpy(), flow_key(seed))


@pytest.fixture(scope="module")
def walker_pair():
    """TestDynamicFrontend's pair: a quad walking in the room at 320x240,
    its box, a static decoy box and an absent one."""
    cfg = SystemConfig(
        camera=CameraConfig(width=320, height=240, fx=267.7, fy=269.6,
                            cx=160.0, cy=120.0),
        dynamic=DynamicConfig(n_flow_points=512))
    planes = jsyn.make_room(seed=0)
    quad = jsyn.make_walker(start=(0.3, 0.0, 1.4), velocity=(0.03, 0.03, 0.0))
    poses = jsyn.camera_trajectory(60, radius=0.2)
    g0, _, _, _ = jsyn.render(cfg.camera, poses[0], planes, quad, 0)
    g1, _, b1, _ = jsyn.render(cfg.camera, poses[1], planes, quad, 1)
    boxes = np.stack([np.asarray(b1), [20.0, 20.0, 90.0, 100.0],
                      np.full(4, -1.0)]).astype(np.float32)
    return cfg, np.asarray(g0), np.asarray(g1), boxes


def _t(x):
    return torch.from_numpy(np.array(x))


def test_moving_object_check_matches(walker_pair):
    cfg, g0, g1, _ = walker_pair
    key = jax.random.PRNGKey(3)
    pj, vj = jdyn.moving_object_check(jnp.asarray(g0), jnp.asarray(g1), key,
                                      cfg)
    tc = tcfg.config_from_dict(dataclasses.asdict(cfg))
    pt, vt = tdyn.moving_object_check(
        _t(g0), _t(g1), tc,
        idx=lambda valid: _jax_indices(valid.numpy(), key))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert int(vt.sum()) > 5
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-2)


def test_dynamic_frontend_matches(walker_pair):
    """The walker's box dynamic, the decoy not, in both packages; mask,
    flags and T_M equal."""
    cfg, g0, g1, boxes = walker_pair
    key = jax.random.PRNGKey(0)
    a = jdyn.dynamic_frontend(jnp.asarray(g0), jnp.asarray(g1),
                              jnp.asarray(boxes), key, cfg)
    tc = tcfg.config_from_dict(dataclasses.asdict(cfg))
    b = tdyn.dynamic_frontend(
        _t(g0), _t(g1), _t(boxes), tc,
        idx=lambda valid: _jax_indices(valid.numpy(), key))
    for f in ("mask", "area_flag", "box_dynamic", "box_blurred",
              "outlier_valid", "n_outliers"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)), f)
    assert b.box_dynamic.tolist() == [True, False, False]
    np.testing.assert_allclose(b.outliers.numpy(), np.asarray(a.outliers),
                               rtol=0, atol=1e-2)


def _gate_runs(kw, frames):
    out = []
    for gate in (JBlurGate(**kw), BlurGate(device="cpu", **kw)):
        out.append([(e, None if o is None else o[0])
                    for e, o in (gate.push(f, stamp=float(i))
                                 for i, f in enumerate(frames))])
    return out


def test_blur_gate_static_frames_pass():
    rng = np.random.RandomState(0)
    img = rng.rand(48, 64).astype(np.float32) * 255
    gate = BlurGate(flow_threshold=500.0, n_track_points=32, device="cpu")
    for i in range(4):
        emit, out = gate.push(img, stamp=float(i))
        assert emit and out is not None


def test_blur_gate_fast_motion_emits_sharpest():
    """Shifted frames (nonzero flow), the middle one sharp and the others
    box-blurred: one emit, the sharp frame's, in both packages."""
    rng = np.random.RandomState(0)
    base = rng.rand(48, 64).astype(np.float32) * 255
    blur = 0.25 * (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)
                   + np.roll(np.roll(base, 1, 0), 1, 1))
    frames = [base, np.roll(blur, 3, 1), np.roll(base, 6, 1),
              np.roll(blur, 9, 1)]
    frames = [f.astype(np.float32) for f in frames]
    j, t = _gate_runs(dict(flow_threshold=0.5, buffer_size=3,
                           n_track_points=32), frames)
    assert t == j
    assert [o for e, o in t if e] == [0.0, 2.0]


def test_blur_gate_measure_matches(walker_pair):
    """One rendered pair: the motion statistic and the Laplacian variance
    of both packages within 1e-3 relative."""
    _, g0, g1, _ = walker_pair
    gate = JBlurGate(n_track_points=256)
    mj = [float(x) for x in gate._jit_measure(jnp.asarray(g0),
                                              jnp.asarray(g1))]
    mt = BlurGate(n_track_points=256, device="cpu").measure(
        _t(g0), _t(g1)).tolist()
    np.testing.assert_allclose(mt, mj, rtol=1e-3)
    assert mt[0] > 0


N_FLOW = 4


def test_system_flow_frame_by_frame():
    """``System(motion_check="flow")`` on the walker scene: the first frame
    masks every box (no previous image), then the flow check runs every
    frame; states, arenas and the dynamic results equal frame by frame."""
    cfg = dyn_config(True)
    cfg = dataclasses.replace(cfg, dynamic=dataclasses.replace(
        cfg.dynamic, motion_check="flow"))
    tc = tcfg.config_from_dict(dataclasses.asdict(cfg))
    js = JSystem(cfg)
    ts = tsys.System(tc, device="cpu", sampler=flow_sampler)
    for i, (g, d, b) in enumerate(walker_frames(cfg, N_FLOW)):
        rj = js.track_rgbd(g, d, stamp=i / 30.0, boxes=b)
        rt = ts.track_rgbd(g, d, stamp=i / 30.0, boxes=b)
        assert rt == rj, (i, rj, rt)
        assert_tracker_states_equal(js.tracker.state, ts.tracker.state, i)
        assert_arenas_close(js.map, ts.map, i)
        if i == 0:
            assert ts.last_dynamic is None
            continue
        a, c = js.last_dynamic, ts.last_dynamic
        np.testing.assert_array_equal(c.box_dynamic, np.asarray(a.box_dynamic))
        np.testing.assert_array_equal(c.mask, np.asarray(a.mask))
        np.testing.assert_array_equal(c.outlier_valid,
                                      np.asarray(a.outlier_valid))
        assert c.n_outliers == int(a.n_outliers) > 0
    assert ts._prev_gray is not None and ts._flow_seed == N_FLOW - 1

"""Parity of the port's detector (``coebslam_tpu_torch/models/detector.py``)
with the JAX package's on the committed walker detector
(``artifacts/detector_walker.npz``, bench.py's self-detect settings) and
rendered orbit frames; and the detector inside the port's realtime loop.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from chip_smoke import walker_detector
from coebslam_tpu import config as jcfg
from coebslam_tpu.models import detector as jdet
from coebslam_tpu.utils import synthetic as jsyn
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.models import detector as tdet
from coebslam_tpu_torch.slam import realtime as trt

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _box_iou(a, b):
    inter = np.prod(np.maximum(np.minimum(a[2:], b[2:])
                               - np.maximum(a[:2], b[:2]), 0))
    return inter / (np.prod(a[2:] - a[:2]) + np.prod(b[2:] - b[:2]) - inter)


@pytest.fixture(scope="module")
def orbit_frames():
    """Frames 0, 40 and 80 of the dynamic orbit (the walker in view), as
    uint8 grey, with the renderer's walker boxes."""
    cam = jcfg.CameraConfig()
    planes = jsyn.make_room(seed=0)
    walker = jsyn.make_walker(start=(-0.9, -0.2, 1.8),
                              velocity=(0.012, 0.004, 0.0),
                              half_w=0.3, half_h=0.65)
    poses = jsyn.camera_trajectory(150, radius=0.35)
    out = []
    for i in (0, 40, 80):
        g, _, b, _ = jsyn.render(cam, poses[i], planes, walker,
                                 jnp.float32(i))
        out.append((np.clip(np.asarray(g), 0, 255).astype(np.uint8),
                    np.asarray(b)))
    return out


@pytest.fixture(scope="module")
def detectors():
    j = walker_detector(jcfg, jdet, jcfg.DynamicConfig())
    t = walker_detector(tcfg, tdet, tcfg.DynamicConfig(), device="cpu")
    return j, t


def test_load_variables_npz_matches(detectors):
    path = os.path.join(ROOT, "artifacts", "detector_walker.npz")
    jv, jmeta = jdet.load_variables_npz(path)
    tv, tmeta = tdet.load_variables_npz(path)
    jflat = dict(jax.tree_util.tree_leaves_with_path(jv))
    tflat = dict(jax.tree_util.tree_leaves_with_path(tv))
    assert jflat.keys() == tflat.keys()
    for k in jflat:
        np.testing.assert_array_equal(np.asarray(jflat[k]), tflat[k])
    assert float(tmeta["width"]) == float(jmeta["width"]) == 0.25


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_detect_device_matches_jax(detectors, orbit_frames, frame):
    """Padded device boxes: the same valid rows (x1 >= 0; a coordinate
    below 0 is -1, as in the reference), each within 0.5 px or IoU >= 0.99
    of the JAX package's; the walker is found."""
    jd, td = detectors
    gray, gt = orbit_frames[frame]
    jb = np.asarray(jd.detect_device(gray))
    tb = td.detect_device(torch.from_numpy(gray)).numpy()
    assert tb.shape == jb.shape == (16, 4)
    np.testing.assert_array_equal(tb >= 0, jb >= 0)
    valid = jb[:, 0] >= 0
    assert valid.any()
    for a, b, v in zip(tb, jb, valid):
        assert np.abs(a - b).max() <= 0.5 \
            or (v and _box_iou(a, b) >= 0.99), (a, b)
    assert max(_box_iou(b, gt) for b in tb[valid]) > 0.3
    np.testing.assert_array_equal(td.detect(gray), tb[valid])


def test_heads_match_jax_forward(detectors, orbit_frames):
    """The raw heads of one frame, resize included."""
    jd, td = detectors
    gray = orbit_frames[1][0]
    size = jd.cfg.input_size
    img = jnp.stack([jnp.asarray(gray)] * 3, -1) / 255.0
    inp = jax.image.resize(img, (size, size, 3), "linear")[None]
    j_raw = jd.model.apply(jd.variables, inp)
    t_raw = td.heads(torch.from_numpy(gray))
    for j, t in zip(j_raw, t_raw):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-3)


CAM = dict(width=320, height=240, fx=267.7, fy=269.6, cx=160.05, cy=123.8)
JCFG = jcfg.SystemConfig(camera=jcfg.CameraConfig(**CAM),
                         orb=jcfg.OrbConfig(n_levels=4, max_keypoints=1024),
                         tracking=jcfg.TrackingConfig(max_frames_between_kf=3))
LIM = dict(max_kf=8, spawn_per_kf=256, ba_window=4, local_window=3,
           max_frames=64, seed_slots=64)


def test_realtime_detector_feeds_dynamic_step():
    """A session whose detector runs every 2nd frame ends in the same
    state as one given those boxes explicitly; caller boxes win."""
    tc = tcfg.config_from_dict(dataclasses.asdict(JCFG))
    planes = jsyn.make_room(seed=0)
    walker = jsyn.make_walker(start=(-0.5, -0.1, 1.5),
                              velocity=(0.02, 0.0, 0.0),
                              half_w=0.3, half_h=0.65)
    poses = jsyn.camera_trajectory(40, radius=0.35)
    frames = []
    for i in range(5):
        g, d, b, _ = jsyn.render(JCFG.camera, poses[i], planes, walker,
                                 jnp.float32(i))
        frames.append((np.clip(np.asarray(g), 0, 255).astype(np.uint8),
                       (np.asarray(d) * 5000).astype(np.uint16),
                       np.asarray(b)[None]))
    caller = np.array([[10.0, 10.0, 60.0, 90.0]], np.float32)
    fake = tdet.FakeDetector([f[2] for f in frames[0::2]])
    a = trt.RealtimeSlam(tc, trt.RTLimits(**LIM), device="cpu",
                         detector=fake, detect_every=2)
    b = trt.RealtimeSlam(tc, trt.RTLimits(**LIM), device="cpu")
    for i, (g, d, box) in enumerate(frames):
        given = caller if i == 3 else None
        a.track(g, d, stamp=i / 30.0, boxes=given)
        b.track(g, d, stamp=i / 30.0,
                boxes=given if given is not None else frames[i - i % 2][2])
    assert fake._i == 3
    for name, x, y in zip(a.state._fields, a.state, b.state):
        for u, v in zip(jax.tree.leaves(x), jax.tree.leaves(y)):
            assert torch.equal(u, v), name

"""Parity of the port's LK flow, corner selection and Laplacian blur score
with the JAX package on the CPU (``coebslam_tpu/ops/lk_flow.py``,
``ops/blur.py``, ``ops/fast.py::subpixel_refine``), on the textured
images of ``tests/test_dynamic_ops.py`` and on a rendered pair of the
room.

Tolerances: the structure tensor, the Harris map, the pyramid and the
Laplacian map equal to float32 rounding (1e-6 relative); corners with
equal validity and positions within 1e-4 px; patches within 1e-4; LK
flow with equal validity and points within 1e-2 px of the JAX result
(the measured gap is printed: 3-4e-4 px on the known shift)."""
import cv2
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from coebslam_tpu.ops import blur as jblur
from coebslam_tpu.ops import fast as jfast
from coebslam_tpu.ops import lk_flow as jlk
from coebslam_tpu.utils import synthetic as jsyn
from coebslam_tpu_torch.ops import blur as tblur
from coebslam_tpu_torch.ops import fast as tfast
from coebslam_tpu_torch.ops import lk_flow as tlk
from test_dynamic_ops import texture

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, rel=1e-6):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(b, a, rtol=0,
                               atol=rel * max(np.abs(a).max(), 1.0))


@pytest.fixture(scope="module")
def shifted():
    """texture(seed=2) and its copy shifted by (7.3, -4.6) px."""
    img = texture(seed=2)
    M = np.float32([[1, 0, 7.3], [0, 1, -4.6]])
    return img, cv2.warpAffine(img, M, (320, 240))


@pytest.fixture(scope="module")
def rendered():
    """Frames 0 and 1 of the room's 0.2 m orbit of 60 frames at 320x240."""
    from coebslam_tpu.config import CameraConfig
    cam = CameraConfig(width=320, height=240, fx=267.7, fy=269.6, cx=160.0,
                       cy=120.0)
    planes = jsyn.make_room(seed=0)
    poses = jsyn.camera_trajectory(60, radius=0.2)
    return [np.asarray(jsyn.render(cam, poses[i], planes)[0])
            for i in (0, 1)]


def test_structure_tensor_matches(shifted):
    img = shifted[0]
    for a, b in zip(jlk._structure_tensor(jnp.asarray(img)),
                    tlk._structure_tensor(_t(img))):
        _close(a, b.numpy())


def test_response_maps_match(shifted):
    img = shifted[0]
    _close(jlk.harris_response(jnp.asarray(img)),
           tlk.harris_response(_t(img)).numpy())


def test_good_features_match(shifted):
    img = shifted[0]
    uj, vj = jlk.good_features(jnp.asarray(img), 300)
    ut, vt = tlk.good_features(_t(img), 300)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert int(vt.sum()) > 100
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=1e-4)


def test_subpixel_refine_matches():
    rng = np.random.RandomState(0)
    strength = rng.rand(40, 50).astype(np.float32) * 50
    yx = np.stack([rng.randint(0, 40, 64), rng.randint(0, 50, 64)], -1)
    a = jfast.subpixel_refine(jnp.asarray(strength), jnp.asarray(yx))
    b = tfast.subpixel_refine(_t(strength), _t(yx).to(torch.int64))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)


def test_bilinear_gather_matches(shifted):
    """Centres inside, on and beyond the border (edge-clamped)."""
    img = shifted[0]
    rng = np.random.RandomState(1)
    c = np.concatenate([rng.uniform(-15, 335, (60, 1)),
                        rng.uniform(-15, 255, (60, 1))], 1).astype(np.float32)
    for size in (3, 21):
        a = jlk.bilinear_gather(jnp.asarray(img), jnp.asarray(c), size)
        b = tlk.bilinear_gather(_t(img), _t(c), size)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-4)


def test_flow_pyramid_matches(shifted):
    img = shifted[0][:239, :317]      # odd sizes: the levels round down
    for a, b in zip(jlk.build_flow_pyramid(jnp.asarray(img)),
                    tlk.build_flow_pyramid(_t(img))):
        assert tuple(b.shape) == a.shape
        _close(a, b.numpy())


def _flow_pair(img1, img2, n):
    uj, _ = jlk.good_features(jnp.asarray(img1), n)
    j = jlk.lk_flow(jlk.build_flow_pyramid(jnp.asarray(img1)),
                    jlk.build_flow_pyramid(jnp.asarray(img2)), uj)
    t = tlk.lk_flow(tlk.build_flow_pyramid(_t(img1)),
                    tlk.build_flow_pyramid(_t(img2)), _t(uj))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    ok = np.asarray(j.valid)
    gap = float(np.abs(t.points.numpy() - np.asarray(j.points))[ok].max())
    err_gap = float(np.abs(t.error.numpy() - np.asarray(j.error))[ok].max())
    print(f"LK: {int(ok.sum())} points, max gap {gap:.3g} px, error gap "
          f"{err_gap:.3g}")
    assert gap < 1e-2 and err_gap < 1e-2
    return np.asarray(uj), t


def test_lk_flow_known_shift_matches(shifted):
    uv, t = _flow_pair(*shifted, 200)
    inner = t.valid.numpy() & (uv[:, 0] > 30) & (uv[:, 0] < 280) \
        & (uv[:, 1] > 30) & (uv[:, 1] < 200)
    med = np.median(t.points.numpy()[inner] - uv[inner], axis=0)
    np.testing.assert_allclose(med, (7.3, -4.6), atol=0.25)


def test_lk_flow_rendered_pair_matches(rendered):
    _flow_pair(*rendered, 512)


def test_blur_metrics_match():
    img = texture(seed=4)
    blurred = cv2.GaussianBlur(img, (21, 21), 6.0)
    img[60:180, 40:150] = blurred[60:180, 40:150]
    _close(jblur.laplacian_map(jnp.asarray(img)),
           tblur.laplacian_map(_t(img)).numpy())
    boxes = np.asarray([[40.0, 60.0, 150.0, 180.0],
                        [180.0, 60.0, 300.0, 180.0],
                        [-1.0, -1.0, -1.0, -1.0]], np.float32)
    a = np.asarray(jblur.box_blur_scores(jnp.asarray(img),
                                         jnp.asarray(boxes)))
    b = tblur.box_blur_scores(_t(img), _t(boxes)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5)
    assert np.isinf(b[2]) and b[0] < b[1]

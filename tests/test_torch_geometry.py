"""Parity of the port's geometry, configuration and BRIEF pattern with the
JAX package, plus the port's import boundary.

Same numpy inputs go to both packages (JAX on the CPU, the port with
``device="cpu"``); tolerances are float32 rounding of the same formulas.
"""
import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from coebslam_tpu import config as jcfg
from coebslam_tpu.geometry import camera as jcam, se3 as jse3, so3 as jso3
from coebslam_tpu.ops import brief as jbrief
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.geometry import camera as tcam, se3 as tse3, \
    so3 as tso3
from coebslam_tpu_torch.ops import brief as tbrief

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _rotvecs(rng, n):
    """Rotation vectors with angles log-spaced over [1e-8, 1e-2] (the f32
    Taylor band) plus a spread up to 3.0 rad."""
    axes = rng.randn(n, 3)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    ang = np.concatenate([np.logspace(-8, -2, n // 2),
                          rng.uniform(1e-2, 3.0, n - n // 2)])
    return (axes * ang[:, None]).astype(np.float32)


def _jac_tol(w):
    """Per-vector tolerance of quantities built on ``left_jacobian``: for
    theta in [1e-4, 1e-2] both packages evaluate (1 - cos t) / t^2 in
    float32 (its series branch starts below 1e-4), which carries an error
    of up to ulp(1) / t^2 in each, i.e. ~1.2e-7 / t on the Jacobian."""
    theta = np.linalg.norm(w, axis=-1)
    return 1e-5 + 3e-7 / np.maximum(theta, 1e-4)


def _close_rows(a, b, tol):
    err = np.abs(np.asarray(a) - np.asarray(b)).reshape(len(tol), -1).max(1)
    assert (err <= tol).all(), (err / tol).max()


def test_so3_exp_log_jacobians_match():
    w = _rotvecs(np.random.RandomState(0), 64)
    t = torch.from_numpy(w)
    np.testing.assert_allclose(tso3.exp(t).numpy(),
                               np.asarray(jso3.exp(jnp.asarray(w))), atol=1e-6)
    R = np.array(jso3.exp(jnp.asarray(w)))
    np.testing.assert_allclose(tso3.log(torch.from_numpy(R)).numpy(),
                               np.asarray(jso3.log(jnp.asarray(R))), atol=2e-6)
    for tf, jf in ((tso3.left_jacobian, jso3.left_jacobian),
                   (tso3.left_jacobian_inv, jso3.left_jacobian_inv)):
        _close_rows(tf(t).numpy(), jf(jnp.asarray(w)), _jac_tol(w))
    Rn = R + 1e-3 * np.random.RandomState(1).randn(*R.shape).astype(np.float32)
    np.testing.assert_allclose(
        tso3.orthonormalize(torch.from_numpy(Rn)).numpy(),
        np.asarray(jso3.orthonormalize(jnp.asarray(Rn))), atol=1e-6)


def test_se3_exp_log_compose_retract_match():
    rng = np.random.RandomState(2)
    xi = np.concatenate([_rotvecs(rng, 32),
                         rng.randn(32, 3).astype(np.float32)], axis=1)
    Tj = jse3.exp(jnp.asarray(xi))
    Tt = tse3.exp(torch.from_numpy(xi))
    np.testing.assert_allclose(Tt.R.numpy(), np.asarray(Tj.R), atol=1e-6)
    tol = _jac_tol(xi[:, :3]) * np.abs(xi[:, 3:]).sum(1)
    _close_rows(Tt.t.numpy(), Tj.t, tol)
    np.testing.assert_allclose(tse3.log(Tt)[:, :3].numpy(),
                               np.asarray(jse3.log(Tj))[:, :3], atol=2e-6)
    Cj = Tj.compose(jse3.SE3(Tj.R[::-1], Tj.t[::-1]).inverse())
    Ct = Tt.compose(tse3.SE3(Tt.R.flip(0), Tt.t.flip(0)).inverse())
    np.testing.assert_allclose(Ct.R.numpy(), np.asarray(Cj.R), atol=1e-6)
    _close_rows(Ct.t.numpy(), Cj.t, 2 * (tol + tol[::-1]))
    d = (0.01 * rng.randn(32, 6)).astype(np.float32)
    Rj = jse3.retract(Tj, jnp.asarray(d))
    Rt = tse3.retract(Tt, torch.from_numpy(d))
    np.testing.assert_allclose(Rt.R.numpy(), np.asarray(Rj.R), atol=1e-6)
    _close_rows(Rt.t.numpy(), Rj.t, tol + 1e-5)
    pts = rng.randn(32, 3).astype(np.float32)
    _close_rows(tse3.transform_points(Tt, torch.from_numpy(pts)).numpy(),
                jse3.transform_points(Tj, jnp.asarray(pts)), tol + 1e-5)
    # log of the same transform: identical inputs, so only the rotation
    # part's rounding and the inverse-Jacobian band above differ.
    Tn = jse3.SE3(jnp.asarray(Tt.R.numpy()), jnp.asarray(Tt.t.numpy()))
    _close_rows(tse3.log(Tt)[:, 3:].numpy(), jse3.log(Tn)[:, 3:],
                _jac_tol(xi[:, :3]) * np.abs(Tt.t.numpy()).sum(1))


@pytest.mark.parametrize("distorted", [False, True])
def test_camera_project_frustum_undistort_match(distorted):
    kw = dict(k1=0.1, k2=-0.05, p1=1e-3, p2=-2e-3, k3=0.01) if distorted else {}
    cj, ct = jcfg.CameraConfig(**kw), tcfg.CameraConfig(**kw)
    rng = np.random.RandomState(3)
    pts = np.concatenate([rng.uniform(-2, 2, (200, 2)),
                          rng.uniform(-0.5, 5, (200, 1))], 1).astype(np.float32)
    for tf, jf in ((tcam.project, jcam.project),
                   (tcam.project_stereo, jcam.project_stereo)):
        np.testing.assert_allclose(tf(ct, torch.from_numpy(pts)).numpy(),
                                   np.asarray(jf(cj, jnp.asarray(pts))),
                                   rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(
        tcam.in_frustum(ct, torch.from_numpy(pts), margin=5.0).numpy(),
        np.asarray(jcam.in_frustum(cj, jnp.asarray(pts), margin=5.0)))
    uv = rng.uniform(0, 640, (100, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tcam.undistort_points(ct, torch.from_numpy(uv)).numpy(),
        np.asarray(jcam.undistort_points(cj, jnp.asarray(uv))), atol=1e-3)


def test_config_from_dict_matches_jax_config():
    """Defaults are the JAX package's, and config_from_dict carries a
    non-default JAX configuration over field for field."""
    jc = jcfg.SystemConfig(
        camera=jcfg.CameraConfig(width=320, height=240, fx=300.0),
        orb=jcfg.OrbConfig(n_levels=4, max_keypoints=1024),
        tracking=jcfg.TrackingConfig(max_frames_between_kf=3),
        ransac=jcfg.RansacConfig(init_iterations=64, init_sigma=1.5),
        sensor="monocular")
    for j, t in ((jcfg.SystemConfig(), tcfg.SystemConfig()),
                 (jc, tcfg.config_from_dict(dataclasses.asdict(jc)))):
        for sec in ("camera", "orb", "dynamic", "matcher", "optimizer",
                    "tracking", "loop", "map", "ransac", "detector"):
            tsec = dataclasses.asdict(getattr(t, sec))
            jsec = dataclasses.asdict(getattr(j, sec))
            assert tsec == {k: jsec[k] for k in tsec}, sec
        assert t.sensor == j.sensor


def test_brief_pattern_bit_identical():
    np.testing.assert_array_equal(tbrief.brief_pattern(),
                                  jbrief.brief_pattern())
    assert tbrief.brief_pattern().dtype == jbrief.brief_pattern().dtype


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "coebslam_tpu_torch").rglob("*.py"))
    assert ROOT / "coebslam_tpu_torch" / "models" / "yolov5.py" in files
    for new in ("ops/initializer_ops.py", "ops/triangulation.py",
                "utils/replica.py", "slam/system.py", "slam/local_mapping.py",
                "slam/tracking.py", "slam/map.py", "slam/map_device.py",
                "io/trajectory.py", "utils/metrics.py", "ops/pnp.py",
                "optim/sim3_opt.py", "slam/keyframe_db.py",
                "slam/relocalization.py", "slam/loop_closing.py",
                "slam/vocabulary.py", "ops/lk_flow.py", "io/checkpoint.py"):
        assert ROOT / "coebslam_tpu_torch" / new in files
    files += [ROOT / "chip_smoke.py", ROOT / "host_bow_scenes.py",
              ROOT / "host_sensor_scenes.py"]
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|coebslam_tpu\b(?!_torch))",
                     re.M)
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert not bad, f"imports of jax / coebslam_tpu in {bad}"
    assert len(files) > 20

"""Parity of the port's EPnP and RANSAC EPnP (``ops/pnp.py``) with the JAX
package on the CPU, on the scenes of ``tests/test_pnp.py``.

The null space comes from a 12x12 ``eigh`` whose basis is defined only up
to sign and rotation inside near-degenerate eigenspaces, so the packages
are held on what they share: the pose, its error and the inlier set.
Measured on these scenes: R and t agree within 5.3e-6 for the full and the
RANSAC solves, err2 within 1.2e-6 relative; the tolerances below are 5e-5
and 1e-4. Single 6-point hypotheses agree less (up to 2.6e-3 on outlier-free
samples, as float32 EPnP itself deviates from float64 by that much), which
is why RANSAC is compared through its final solve. The RANSAC draws are
the reference's ``jax.random.categorical`` indices, injected (``idx``).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from coebslam_tpu.ops import pnp as jpnp
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.ops import fundamental, pnp as tpnp
from test_pnp import CAM, _pose_err, _scene

torch.set_num_threads(2)
TCAM = tcfg.CameraConfig(**dataclasses.asdict(CAM))
POSE_TOL = 5e-5
ERR2_RTOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _epnp_case(case):
    """(X, uv, w, R, t) of test_pnp.py's exact, noisy and weighted scenes."""
    if case == "exact":
        X, uv, R, t = _scene(0)
        return X, uv, np.ones(len(X), np.float32), R, t
    if case == "noisy":
        X, uv, R, t = _scene(1, noise_px=0.5)
        return X, uv, np.ones(len(X), np.float32), R, t
    X, uv, R, t = _scene(2)
    uv = uv.copy()
    uv[60:] = 0.0
    w = np.ones(len(X), np.float32)
    w[60:] = 0.0
    return X, uv, w, R, t


GATES = {"exact": (1e-3, 1e-3), "noisy": (0.01, 0.02),
         "weighted": (1e-3, 1e-2)}


@pytest.mark.parametrize("case", ["exact", "noisy", "weighted"])
def test_epnp_matches_jax(case):
    X, uv, w, R, t = _epnp_case(case)
    rj = jpnp.epnp(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(w), CAM)
    rt = tpnp.epnp(_t(X), _t(uv), _t(w), TCAM)
    ang, dt = _pose_err(rt.R.numpy(), rt.t.numpy(), R, t)
    max_ang, max_dt = GATES[case]
    assert ang < max_ang and dt < max_dt, (ang, dt)
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=POSE_TOL)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=POSE_TOL)
    np.testing.assert_allclose(float(rt.err2), float(rj.err2),
                               rtol=ERR2_RTOL, atol=1e-5)


def test_epnp_batched_equals_one_by_one():
    """The batch over hypotheses gives each problem's own solution."""
    cases = [_epnp_case(c) for c in ("exact", "noisy", "weighted")]
    X, uv, w = (np.stack([c[i] for c in cases]) for i in range(3))
    rb = tpnp.epnp(_t(X), _t(uv), _t(w), TCAM)
    for b in range(3):
        r1 = tpnp.epnp(_t(X[b]), _t(uv[b]), _t(w[b]), TCAM)
        np.testing.assert_allclose(rb.R[b].numpy(), r1.R.numpy(), atol=1e-5)
        np.testing.assert_allclose(rb.t[b].numpy(), r1.t.numpy(), atol=1e-5)


def _jax_idx(valid, key, n_hyp=64, k=6):
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    return _t(np.asarray(jax.random.categorical(
        key, logits[None, :], shape=(n_hyp, k)))).to(torch.int64)


def _own_idx(valid, seed, n_hyp=64, k=6):
    """The port's own draws: ``sample_indices`` from a seeded generator."""
    return fundamental.sample_indices(
        valid, n_hyp, torch.Generator().manual_seed(seed), k=k)


def _ransac_case(case):
    if case == "mask":
        X, uv, R, t = _scene(20)
        valid = np.ones(len(X), bool)
        valid[::2] = False
        uv = uv.copy()
        uv[::2] = -1000.0
        return X, uv, valid, R, t, 0
    seed = int(case[-1])
    X, uv, R, t = _scene(10 + seed, noise_px=0.3, outlier_frac=0.3)
    return X, uv, np.ones(len(X), bool), R, t, seed


@pytest.mark.parametrize("case", ["outliers0", "outliers1", "outliers2",
                                  "mask"])
def test_ransac_epnp_matches_jax_with_its_draws(case):
    X, uv, valid, R, t, seed = _ransac_case(case)
    key = jax.random.PRNGKey(seed)
    rj = jpnp.ransac_epnp(jnp.asarray(X), jnp.asarray(uv),
                          jnp.asarray(valid), key, CAM)
    rt = tpnp.ransac_epnp(_t(X), _t(uv), _t(valid), TCAM,
                          _jax_idx(valid, key))
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers)
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=POSE_TOL)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=POSE_TOL)
    ang, dt = _pose_err(rt.R.numpy(), rt.t.numpy(), R, t)
    assert ang < 0.02 and dt < 0.05, (ang, dt)


@pytest.mark.slow
class TestRansacEPnPPort:
    """tests/test_pnp.py::TestRansacEPnP's gates on the port, with draws
    from its own generator (64 hypotheses of 6, as the reference's
    default)."""

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_outlier_rejection(self, seed):
        X, uv, R, t = _scene(10 + seed, noise_px=0.3, outlier_frac=0.3)
        valid = torch.ones(len(X), dtype=bool)
        res = tpnp.ransac_epnp(_t(X), _t(uv), valid, TCAM,
                               _own_idx(valid, seed))
        ang, dt = _pose_err(res.R.numpy(), res.t.numpy(), R, t)
        assert int(res.n_inliers) > 60, int(res.n_inliers)
        assert ang < 0.02 and dt < 0.05, (ang, dt)
        inl = res.inliers.numpy()
        assert inl[: int(0.3 * len(X))].mean() < 0.2

    def test_respects_valid_mask(self):
        X, uv, valid, R, t, _ = _ransac_case("mask")
        res = tpnp.ransac_epnp(_t(X), _t(uv), _t(valid), TCAM,
                               _own_idx(_t(valid), 0))
        ang, dt = _pose_err(res.R.numpy(), res.t.numpy(), R, t)
        assert ang < 0.01 and dt < 0.02, (ang, dt)
        assert not res.inliers.numpy()[::2].any()

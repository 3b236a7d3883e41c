"""Parity of the port's Schur-complement local BA with the JAX package.

The reference assembles lane-major with one-hot matmuls; the port uses
index_add_ and batched einsums, so sums run in another order. Tolerances
are set from float32 rounding of the reduced camera system (relative 1e-4
of its largest entry) and its effect on the solution after 15 iterations.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from coebslam_tpu import config as jcfg
from coebslam_tpu.optim import local_ba as jba
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.geometry import so3 as tso3
from coebslam_tpu_torch.optim import local_ba as tba

torch.set_num_threads(1)


def _problem(seed=0, K=5, P=96, M=5):
    """A noisy window: K keyframes (the last one invalid), P points, mono
    and stereo observations, a few gross outliers; poses and points start
    perturbed from the truth."""
    rng = np.random.RandomState(seed)
    cam = jcfg.CameraConfig()
    X = np.concatenate([rng.uniform(-1.5, 1.5, (P, 2)),
                        rng.uniform(2.0, 5.0, (P, 1))], 1)
    w = rng.randn(K, 3) * 0.05
    R = tso3.exp(torch.from_numpy(w)).numpy()
    t = rng.randn(K, 3) * 0.1
    R[0], t[0] = np.eye(3), 0.0
    obs_kf = np.full((P, M), -1, np.int32)
    obs = np.zeros((P, M, 3))
    ow = np.ones((P, M))
    ov = np.zeros((P, M), bool)
    for p in range(P):
        for m in range(M):
            k = m
            if k >= K - 1 or rng.rand() < 0.2:
                continue
            pc = R[k] @ X[p] + t[k]
            u = cam.fx * pc[0] / pc[2] + cam.cx + rng.randn() * 0.5
            v = cam.fy * pc[1] / pc[2] + cam.cy + rng.randn() * 0.5
            ur = u - cam.bf / pc[2] if rng.rand() < 0.7 else -1.0
            obs[p, m] = (u, v, ur)
            lvl = rng.randint(0, 4)
            ow[p, m] = 1.0 / 1.2 ** (2 * lvl)
            ov[p, m] = True
            obs_kf[p, m] = k
    out = rng.rand(P, M) < 0.03
    obs[out, :2] += 25.0
    Rn = R.copy()
    for k in range(1, K):
        Rn[k] = tso3.exp(torch.from_numpy(rng.randn(3) * 0.01)).numpy() @ R[k]
    tn = t + np.concatenate([np.zeros((1, 3)), rng.randn(K - 1, 3) * 0.02])
    Xn = X + rng.randn(P, 3) * 0.02
    f = np.float32
    return dict(kf_R=Rn.astype(f), kf_t=tn.astype(f),
                kf_fixed=np.arange(K) == 0, kf_valid=np.arange(K) < K - 1,
                pt_pos=Xn.astype(f), pt_valid=rng.rand(P) > 0.05,
                obs_kf=obs_kf, obs_uvr=obs.astype(f), obs_w=ow.astype(f),
                obs_valid=ov)


def _jprob(d):
    return jba.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()})


def _tprob(d):
    conv = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    conv["obs_kf"] = conv["obs_kf"].to(torch.int64)
    return tba.BAProblem(**conv)


@pytest.mark.parametrize("use_huber", [False, True])
def test_assemble_matches(use_huber):
    d = _problem(1)
    Sj, bj, _ = jba._assemble(_jprob(d), jcfg.CameraConfig(),
                              jnp.bool_(use_huber), 5.991, 7.815, 1e-5)
    St, bt, _ = tba._assemble(_tprob(d), tcfg.CameraConfig(), use_huber,
                              5.991, 7.815, 1e-5)
    Sj, bj = np.asarray(Sj), np.asarray(bj)
    np.testing.assert_allclose(St.numpy(), Sj, atol=1e-4 * np.abs(Sj).max())
    np.testing.assert_allclose(bt.numpy(), bj, atol=1e-4 * np.abs(bj).max())


def test_optimize_local_ba_matches():
    d = _problem(0)
    rj = jax.jit(lambda p: jba.optimize_local_ba(p, jcfg.CameraConfig(),
                                                 jcfg.OptimizerConfig()))(
        _jprob(d))
    rt = tba.optimize_local_ba(_tprob(d), tcfg.CameraConfig(),
                               tcfg.OptimizerConfig())
    np.testing.assert_allclose(rt.kf_R.numpy(), np.asarray(rj.kf_R), atol=2e-5)
    np.testing.assert_allclose(rt.kf_t.numpy(), np.asarray(rj.kf_t), atol=5e-5)
    np.testing.assert_allclose(rt.pt_pos.numpy(), np.asarray(rj.pt_pos),
                               atol=5e-4)
    np.testing.assert_array_equal(rt.obs_valid.numpy(),
                                  np.asarray(rj.obs_valid))
    ok = np.asarray(rj.obs_valid)
    np.testing.assert_allclose(rt.chi2.numpy()[ok], np.asarray(rj.chi2)[ok],
                               atol=1e-2)
    # The solve moved the window toward the truth and dropped the outliers.
    assert (~ok & d["obs_valid"]).sum() >= 1


def test_inv3x3_matches():
    rng = np.random.RandomState(3)
    H = rng.randn(50, 3, 3).astype(np.float32)
    H = H @ H.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(tba._inv3x3(torch.from_numpy(H)).numpy(),
                               np.asarray(jba._inv3x3(jnp.asarray(H))),
                               rtol=1e-5, atol=1e-5)

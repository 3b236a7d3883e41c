"""Parity of the port's loop-closing building blocks with the JAX package:
Sim3, Umeyama and the alignment RANSAC, the Sim3 pose graph, and the
vocabulary (load, descent, scoring).

Same numpy inputs go to both packages (JAX on the CPU, the port with CPU
tensors). RANSAC draws cannot be reproduced by a torch generator, so the
reference's ``jax.random.categorical`` indices are injected (``idx``).
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from coebslam_tpu import config as jcfg
from coebslam_tpu.geometry import camera as jcam, sim3 as jsim3, \
    so3 as jso3
from coebslam_tpu.ops import extractor as jext, procrustes as jpro
from coebslam_tpu.optim import pose_graph as jpg
from coebslam_tpu.slam import vocabulary as jvoc
from coebslam_tpu.utils import synthetic as jsyn
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.geometry import sim3 as tsim3
from coebslam_tpu_torch.ops import procrustes as tpro
from coebslam_tpu_torch.optim import pose_graph as tpg
from coebslam_tpu_torch.slam import vocabulary as tvoc

torch.set_num_threads(1)
VOCAB = pathlib.Path(__file__).resolve().parents[1] / "artifacts" / \
    "vocab_1e5.npz"


def _xi(rng, n):
    """sim(3) tangents: theta and sigma log-spaced over [1e-8, 1e-2] (the
    f32 Taylor bands) in half the rows, ordinary values in the rest."""
    axes = rng.randn(n, 3)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    h = n // 2
    theta = np.concatenate([np.logspace(-8, -2, h), rng.uniform(0.02, 2.5,
                                                                n - h)])
    sigma = np.concatenate([np.logspace(-8, -2, h) * np.sign(rng.randn(h)),
                            rng.uniform(-0.5, 0.5, n - h)])
    return np.concatenate([axes * theta[:, None], rng.randn(n, 3),
                           sigma[:, None]], 1).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_sim3_exp_log_compose_inverse_match():
    rng = np.random.RandomState(0)
    xa, xb = _xi(rng, 64), _xi(rng, 64)
    Ja, Jb = jsim3.exp(jnp.asarray(xa)), jsim3.exp(jnp.asarray(xb))
    Ta, Tb = tsim3.exp(_t(xa)), tsim3.exp(_t(xb))
    for j, t in ((Ja, Ta), (Ja.compose(Jb.inverse()),
                            Ta.compose(Tb.inverse())),
                 (Jb.inverse(), Tb.inverse())):
        for a, b in zip(j, t):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    np.testing.assert_allclose(tsim3.log(Ta).numpy(),
                               np.asarray(jsim3.log(Ja)), atol=1e-5)
    pts = rng.randn(64, 3).astype(np.float32)
    np.testing.assert_allclose(Ta.apply(_t(pts)).numpy(),
                               np.asarray(Ja.apply(jnp.asarray(pts))),
                               atol=1e-5)
    np.testing.assert_allclose(Ta.to_se3_matrix().numpy(),
                               np.asarray(Ja.to_se3_matrix()), atol=1e-5)


def test_sim3_log_of_singular_w_is_nan_not_an_error():
    """log solves W u = t with solve_ex: a singular W (scale 0) gives
    non-finite values, as the reference does, and raises nothing."""
    S = tsim3.Sim3(torch.zeros(()), torch.eye(3), torch.ones(3))
    assert not torch.isfinite(tsim3.log(S)).all()


def _rigid(rng, n, noise):
    src = rng.randn(n, 3).astype(np.float32)
    R = np.asarray(jso3.exp(jnp.asarray([0.3, -0.2, 0.5], jnp.float32)))
    t = np.asarray([0.4, -1.0, 2.0], np.float32)
    dst = src @ R.T + t + noise * rng.randn(n, 3).astype(np.float32)
    return src, dst.astype(np.float32)


@pytest.mark.parametrize("noise", [0.0, 0.01])
@pytest.mark.parametrize("with_scale", [False, True])
def test_umeyama_matches(noise, with_scale):
    rng = np.random.RandomState(1)
    src, dst = _rigid(rng, 40, noise)
    dst = dst * (1.7 if with_scale else 1.0)
    w = rng.uniform(0.2, 1.0, 40).astype(np.float32)
    for weights in (None, w):
        js, jR, jt = jpro.umeyama(jnp.asarray(src), jnp.asarray(dst),
                                  None if weights is None
                                  else jnp.asarray(weights), with_scale)
        ts, tR, tt = tpro.umeyama(_t(src), _t(dst), None if weights is None
                                  else _t(weights), with_scale)
        np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


@pytest.mark.parametrize("final", [None, 0.03])
def test_ransac_alignment_injected_draws_match(final):
    """Outliers, invalid rows and the annealed refit: with the reference's
    draws injected, R and t within 1e-4, inliers and counts equal."""
    rng = np.random.RandomState(2)
    src, dst = _rigid(rng, 300, 0.005)
    out = rng.rand(300) < 0.4
    dst[out] += rng.uniform(-1, 1, (out.sum(), 3)).astype(np.float32)
    valid = rng.rand(300) < 0.9
    key = jax.random.PRNGKey(7)
    j = jpro.ransac_alignment(jnp.asarray(src), jnp.asarray(dst),
                              jnp.asarray(valid), key, n_hypotheses=256,
                              threshold=0.08, final_threshold=final)
    idx = jax.random.categorical(
        key, jnp.where(jnp.asarray(valid), 0.0, -1e9)[None, :],
        shape=(256, 3))
    t = tpro.ransac_alignment(_t(src), _t(dst), _t(valid),
                              idx=_t(np.asarray(idx)).long(),
                              threshold=0.08, final_threshold=final)
    np.testing.assert_allclose(t.R.numpy(), np.asarray(j.R), atol=1e-4)
    np.testing.assert_allclose(t.t.numpy(), np.asarray(j.t), atol=1e-4)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert int(t.n_inliers) == int(j.n_inliers) > 100
    assert int(t.n_consensus) == int(j.n_consensus)


def test_ransac_alignment_reprojection_scored_matches():
    rng = np.random.RandomState(3)
    cam_j, cam_t = jcfg.CameraConfig(), tcfg.CameraConfig()
    pc = np.concatenate([rng.uniform(-1, 1, (200, 2)),
                         rng.uniform(1.5, 4, (200, 1))], 1).astype(np.float32)
    R = np.asarray(jso3.exp(jnp.asarray([0.1, 0.2, -0.1], jnp.float32)))
    src = ((pc - 0.1) @ R).astype(np.float32)       # pc = R src + 0.1
    uv = np.array(jcam.project(cam_j, jnp.asarray(pc)))
    uv[:50] += 30.0
    valid = np.ones(200, bool)
    key = jax.random.PRNGKey(3)
    j = jpro.ransac_alignment(jnp.asarray(src), jnp.asarray(pc),
                              jnp.asarray(valid), key, cam=cam_j,
                              obs_uv=jnp.asarray(uv))
    idx = jax.random.categorical(key, jnp.zeros((1, 200)), shape=(256, 3))
    t = tpro.ransac_alignment(_t(src), _t(pc), _t(valid),
                              idx=_t(np.asarray(idx)).long(), cam=cam_t,
                              obs_uv=_t(uv))
    np.testing.assert_allclose(t.R.numpy(), np.asarray(j.R), atol=1e-4)
    np.testing.assert_allclose(t.t.numpy(), np.asarray(j.t), atol=1e-4)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert int(t.n_inliers) == int(j.n_inliers) == 150


def _drifted_chain(K=12, drift_deg=1.5):
    """A circle of K poses with a yaw drift per edge, its chain edges from
    the drifted estimate and a ground-truth loop edge K-1 -> 0."""
    def pose(a, r=2.0):
        Rwc = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]], np.float32)
        c = np.array([r * np.sin(a), 0.1 * np.cos(3 * a), -r * np.cos(a)],
                     np.float32)
        return Rwc.T, -Rwc.T @ c
    gt = [pose(a) for a in np.linspace(0, 2 * np.pi, K, endpoint=False)]
    d = np.deg2rad(drift_deg)
    pert = np.array([[np.cos(d), 0, np.sin(d)], [0, 1, 0],
                     [-np.sin(d), 0, np.cos(d)]], np.float32)
    est = [gt[0]]
    for i in range(1, K):
        Rr = gt[i][0] @ gt[i - 1][0].T
        tr = gt[i][1] - Rr @ gt[i - 1][1]
        Rp, tp = est[-1]
        est.append((pert @ Rr @ Rp, pert @ (Rr @ tp + tr) + 0.01))
    R = np.stack([e[0] for e in est]).astype(np.float32)
    t = np.stack([e[1] for e in est]).astype(np.float32)
    ei = list(range(1, K)) + [K - 1]
    ej = list(range(0, K - 1)) + [0]
    eR, et = [], []
    for i, j in zip(ei[:-1], ej[:-1]):
        Rm = R[i] @ R[j].T
        eR.append(Rm), et.append(t[i] - Rm @ t[j])
    Rl = gt[K - 1][0] @ gt[0][0].T
    eR.append(Rl), et.append(gt[K - 1][1] - Rl @ gt[0][1])
    E = len(ei)
    return dict(s=np.ones(K, np.float32), R=R, t=t,
                fixed=np.arange(K) == 0, valid=np.ones(K, bool),
                edge_i=np.asarray(ei), edge_j=np.asarray(ej),
                edge_s=np.ones(E, np.float32),
                edge_R=np.stack(eR).astype(np.float32),
                edge_t=np.stack(et).astype(np.float32),
                edge_valid=np.ones(E, bool),
                edge_weight=np.r_[np.ones(E - 1), 3.0].astype(np.float32))


@pytest.mark.parametrize("fix_scale", [True, False])
def test_pose_graph_matches(fix_scale):
    p = _drifted_chain()
    jp = jpg.PoseGraphProblem(**{k: jnp.asarray(
        v.astype(np.int32) if k.startswith("edge_") and v.dtype == np.int64
        else v) for k, v in p.items()})
    tp = tpg.PoseGraphProblem(**{k: _t(v) for k, v in p.items()})
    opt_j = jcfg.OptimizerConfig()
    opt_t = tcfg.config_from_dict(
        {"optimizer": dataclasses.asdict(opt_j)}).optimizer
    js = jpg.optimize_pose_graph(jp, opt_j, fix_scale=fix_scale)
    ts = tpg.optimize_pose_graph(tp, opt_t, fix_scale=fix_scale)
    for k in ("s", "R", "t"):
        np.testing.assert_allclose(getattr(ts, k).numpy(),
                                   np.asarray(getattr(js, k)), atol=1e-4)
    moved = np.abs(ts.t.numpy() - p["t"]).max()
    assert moved > 0.05                     # the loop edge did pull
    # The distributed-assembly hook: an identity reduction (one rank)
    # leaves the result bit for bit as it is without the hook.
    ts_hook = tpg.optimize_pose_graph(tp, opt_t, fix_scale=fix_scale,
                                      reduce_fn=lambda H, b: (H, b))
    for k in ("s", "R", "t"):
        assert torch.equal(getattr(ts_hook, k), getattr(ts, k)), k


@pytest.fixture(scope="module")
def vocab_and_frame():
    voc_j = jvoc.load(str(VOCAB))
    cfg = jcfg.SystemConfig()
    pose = jsyn.camera_trajectory(10, radius=0.35)[3]
    g = jsyn.render(cfg.camera, pose, jsyn.make_room(seed=0))[0]
    f = jext.extract(jnp.clip(g, 0, 255), cfg.orb)
    return voc_j, np.asarray(f.desc), np.asarray(f.valid)


def test_vocabulary_carries_over_and_loads(vocab_and_frame):
    voc_j, _, _ = vocab_and_frame
    voc_t = tvoc.load(str(VOCAB))
    voc_c = tvoc.Vocabulary(*voc_j)
    for v in (voc_t, voc_c):
        for a, b in zip(v[:5], voc_j[:5]):
            np.testing.assert_array_equal(a, b)
        assert (v.depth, v.branching, v.n_words) == (6, 10, 244951)
        assert len(v.node_desc) == 272614


def test_vocabulary_descent_matches(vocab_and_frame):
    """The 2048 descriptor slots of a rendered 640x480 frame: word and
    group ids equal to the JAX descent and to the host descent, and the
    BoW vector within 1e-6."""
    voc_j, desc, valid = vocab_and_frame
    assert desc.shape == (2048, 32) and valid.sum() > 500
    voc_t = tvoc.Vocabulary(*voc_j)
    dv = tvoc.to_device(voc_t, "cpu")
    wj, gj, bj = jvoc.transform(voc_j, jnp.asarray(desc), jnp.asarray(valid))
    wt, gt, bt = tvoc.transform(dv, _t(desc), _t(valid))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-6)
    wh, gh = tvoc.transform_host(voc_t, desc)
    np.testing.assert_array_equal(wt.numpy()[valid], wh[valid])
    np.testing.assert_array_equal(gt.numpy()[valid], gh[valid])
    ww, gw = tvoc.transform_words(dv, _t(desc), _t(valid))
    assert torch.equal(ww, wt) and torch.equal(gw, gt)
    assert float(tvoc.l1_score(bt, bt)) == pytest.approx(1.0, abs=1e-6)
    np.testing.assert_allclose(
        float(tvoc.l1_score(bt, bt.flip(0))),
        float(jvoc.l1_score(bj, bj[::-1])), atol=1e-6)

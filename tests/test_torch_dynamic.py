"""Parity of the port's matching, F-RANSAC and realtime dynamic front-end
with the JAX package on the CPU.

A torch generator cannot reproduce ``jax.random`` draws, so the RANSAC
tests hand the port the sample indices the reference draws from its key.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from coebslam_tpu import config as jcfg
from coebslam_tpu.ops import brief as jbrief, fundamental as jfund, \
    matching as jmatch
from coebslam_tpu.ops.extractor import Features as JFeatures
from coebslam_tpu.slam import dynamic as jdyn
from coebslam_tpu.slam.frame import FrameData as JFrameData
from coebslam_tpu.utils import synthetic as jsyn
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.ops import fundamental as tfund, matching as tmatch
from coebslam_tpu_torch.slam import dynamic as tdyn, frame as tframe

torch.set_num_threads(1)


def _jax_indices(valid, key, n_hyp=256):
    """The [H, 8] sample indices the reference's find_fundamental_ransac
    draws from ``key``, as an int64 tensor."""
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    return torch.from_numpy(np.asarray(jax.random.categorical(
        key, logits[None, :], shape=(n_hyp, 8)))).to(torch.int64)


@pytest.mark.parametrize("ratio,mutual", [(None, False), (0.9, True),
                                          (0.75, False)])
def test_match_identical_on_integer_distances(ratio, mutual):
    """Integer distances with many ties: argmin takes the first index in
    both; idx, dist and valid are equal."""
    rng = np.random.RandomState(0)
    d = rng.randint(0, 60, size=(300, 400)).astype(np.float32)
    rv = rng.rand(300) > 0.1
    cv = rng.rand(400) > 0.1
    rj = jmatch.match(jnp.asarray(d), max_distance=40.0, ratio=ratio,
                      mutual=mutual, row_valid=jnp.asarray(rv),
                      col_valid=jnp.asarray(cv))
    rt = tmatch.match(torch.from_numpy(d), max_distance=40.0, ratio=ratio,
                      mutual=mutual, row_valid=torch.from_numpy(rv),
                      col_valid=torch.from_numpy(cv))
    np.testing.assert_array_equal(rt.idx.numpy(), np.asarray(rj.idx))
    np.testing.assert_array_equal(rt.valid.numpy(), np.asarray(rj.valid))
    np.testing.assert_array_equal(rt.dist.numpy(), np.asarray(rj.dist))
    # Rotation-histogram filter on the same match.
    aq = rng.uniform(-np.pi, np.pi, 300).astype(np.float32)
    at = rng.uniform(-np.pi, np.pi, 400).astype(np.float32)
    at[:200] = aq[:200] + 0.3            # a dominant rotation bin
    fj = jmatch.rotation_consistency(jnp.asarray(aq), jnp.asarray(at), rj)
    ft = tmatch.rotation_consistency(torch.from_numpy(aq),
                                     torch.from_numpy(at), rt)
    np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
    np.testing.assert_array_equal(ft.idx.numpy(), np.asarray(fj.idx))


def test_hamming_matrix_exact():
    rng = np.random.RandomState(1)
    a = rng.randint(0, 256, (64, 32)).astype(np.uint8)
    b = rng.randint(0, 256, (80, 32)).astype(np.uint8)
    sj = lambda x: jbrief.to_signed(jbrief.unpack_bits(jnp.asarray(x)))
    from coebslam_tpu_torch.ops import brief as tbrief
    st = lambda x: tbrief.to_signed(tbrief.unpack_bits(torch.from_numpy(x)))
    np.testing.assert_array_equal(tmatch.hamming_matrix(st(a), st(b)).numpy(),
                                  np.asarray(jmatch.hamming_matrix(sj(a), sj(b))))


def test_fundamental_ransac_with_injected_indices():
    """Same hypotheses (the reference's draws), same best hypothesis and
    inlier set; F agrees up to sign within 1e-4 (LAPACK SVDs of the refit
    differ in rounding)."""
    rng = np.random.RandomState(2)
    X = np.concatenate([rng.uniform(-2, 2, (300, 2)),
                        rng.uniform(2, 6, (300, 1))], 1)
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    a = 0.05
    R2 = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                   [-np.sin(a), 0, np.cos(a)]])
    t2 = np.array([0.2, 0.05, 0.02])
    p1 = (X @ K.T)[:, :2] / X[:, 2:]
    Xc = X @ R2.T + t2
    p2 = (Xc @ K.T)[:, :2] / Xc[:, 2:]
    p2 = p2 + rng.randn(*p2.shape) * 0.3
    p2[:40] += rng.uniform(-30, 30, (40, 2))          # movers
    p1, p2 = p1.astype(np.float32), p2.astype(np.float32)
    valid = rng.rand(300) > 0.05
    rj = jfund.find_fundamental_ransac(jnp.asarray(p1), jnp.asarray(p2),
                                       jnp.asarray(valid),
                                       jax.random.PRNGKey(5))
    idx = _jax_indices(valid, jax.random.PRNGKey(5))
    rt = tfund.find_fundamental_ransac(torch.from_numpy(p1),
                                       torch.from_numpy(p2),
                                       torch.from_numpy(valid), idx=idx)
    Fj, Ft = np.asarray(rj.F), rt.F.numpy()
    Ft = Ft * np.sign((Ft * Fj).sum())
    np.testing.assert_allclose(Ft, Fj, atol=1e-4)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert 200 < int(rt.n_inliers) < 270


def test_sample_indices_uniform_over_valid():
    valid = torch.zeros(50, dtype=torch.bool)
    valid[[3, 7, 20, 41]] = True
    g = torch.Generator().manual_seed(0)
    idx = tfund.sample_indices(valid, 256, g)
    assert set(idx.unique().tolist()) == {3, 7, 20, 41}
    idx0 = tfund.sample_indices(torch.zeros(50, dtype=torch.bool), 256, g)
    assert idx0.min() >= 0 and idx0.max() < 50


def _to_jax_fd(fd):
    f = fd.feats
    a = lambda t: jnp.asarray(t.numpy())
    feats = JFeatures(uv=a(f.uv), level=a(f.level.to(torch.int32)),
                      score=a(f.score), angle=a(f.angle), desc=a(f.desc),
                      valid=a(f.valid))
    return JFrameData(feats=feats, depth=a(fd.depth), ur=a(fd.ur),
                      inv_sigma2=a(fd.inv_sigma2), obs=a(fd.obs))


def test_dynamic_step_matches_on_walker_frames():
    """One dynamic step on two walker frames from the same features and
    state: equal cull mask, spawn gate, sticky mask, area flag and box
    classification."""
    cam_kw = dict(width=320, height=240, fx=267.7, fy=269.6, cx=160.05,
                  cy=123.8)
    orb_kw = dict(n_levels=4, max_keypoints=1024)
    jc = jcfg.SystemConfig(camera=jcfg.CameraConfig(**cam_kw),
                           orb=jcfg.OrbConfig(**orb_kw))
    tc = tcfg.SystemConfig(camera=tcfg.CameraConfig(**cam_kw),
                           orb=tcfg.OrbConfig(**orb_kw))
    planes = jsyn.make_room(seed=0)
    walker = jsyn.make_walker(start=(-0.6, -0.1, 1.6),
                              velocity=(0.08, 0.0, 0.0), half_w=0.3,
                              half_h=0.6)
    poses = jsyn.camera_trajectory(40, radius=0.35)
    fds, grays, boxes = [], [], []
    for i in (0, 1):
        g, d, b, _ = jsyn.render(jc.camera, poses[i], planes, walker, i)
        g = np.clip(np.asarray(g), 0, 255).astype(np.float32)
        fds.append(tframe.process_rgbd(torch.from_numpy(g),
                                       torch.from_numpy(np.asarray(d)),
                                       tc.camera, tc.orb))
        grays.append(g)
        boxes.append(np.asarray(b))
    box = np.full((16, 4), -1.0, np.float32)
    box[0] = boxes[1]
    box[1] = [10.0, 10.0, 60.0, 200.0]                 # a second box
    prev = fds[0].feats
    st_t = tdyn.init_dyn_state(tc, "cpu")._replace(
        prev_uv=prev.uv, prev_desc=prev.desc, prev_valid=prev.valid)
    st_j = jdyn.init_dyn_state(jc)._replace(
        prev_uv=jnp.asarray(prev.uv.numpy()),
        prev_desc=jnp.asarray(prev.desc.numpy()),
        prev_valid=jnp.asarray(prev.valid.numpy()))
    fd_j = _to_jax_fd(fds[1])
    key = jax.random.PRNGKey(7)
    out_j = jax.jit(lambda fd, g, s, b: jdyn.dynamic_step(fd, g, s, b, key,
                                                          jc))(
        fd_j, jnp.asarray(grays[1]), st_j, jnp.asarray(box))

    # The reference's RANSAC draws, from its own correspondence mask.
    fe = fd_j.feats
    d = jmatch.hamming_matrix(jbrief.to_signed(jbrief.unpack_bits(
        st_j.prev_desc)), fe.signed_desc())
    du = jnp.abs(st_j.prev_uv[:, None, 0] - fe.uv[None, :, 0])
    dv = jnp.abs(st_j.prev_uv[:, None, 1] - fe.uv[None, :, 1])
    r = jc.dynamic.match_radius
    d = d + jnp.where((du <= r) & (dv <= r), 0.0, jmatch.BIG)
    good = jmatch.match(d, max_distance=jc.matcher.th_high,
                        ratio=jc.matcher.nn_ratio_tracking, mutual=True,
                        row_valid=st_j.prev_valid, col_valid=fe.valid).valid
    idx = _jax_indices(good, key)
    out_t = tdyn.dynamic_step(fds[1], torch.from_numpy(grays[1]), st_t,
                              torch.from_numpy(box), tc, idx=idx)

    (fdc_j, spawn_j, ns_j, info_j), (fdc_t, spawn_t, ns_t, info_t) = \
        out_j, out_t
    np.testing.assert_array_equal(info_t.box_dynamic.numpy(),
                                  np.asarray(info_j.box_dynamic))
    assert bool(info_t.box_dynamic[0])            # the walker is caught
    assert int(info_t.n_outliers) == int(info_j.n_outliers)
    np.testing.assert_array_equal(fdc_t.feats.valid.numpy(),
                                  np.asarray(fdc_j.feats.valid))
    np.testing.assert_array_equal(spawn_t.numpy(), np.asarray(spawn_j))
    np.testing.assert_array_equal(ns_t.sticky.numpy(),
                                  np.asarray(ns_j.sticky))
    assert bool(ns_t.area_flag) == bool(ns_j.area_flag)
    np.testing.assert_array_equal(info_t.box_blurred.numpy(),
                                  np.asarray(info_j.box_blurred))

"""Parity of the port's ``Relocalizer`` with the JAX package on the CPU.

One map (the JAX System after 10 frames of the relocalization world) and
its keyframe database serve both relocalizers; the query is a frame of the
same world through the JAX RGB-D front-end, given to both (the port's
front-end is held elsewhere; here its slot-order ties would only blur what
is compared), as it is (the depth branch: 3-point Horn RANSAC) and with
its depth removed (the depth-free branch: EPnP RANSAC), plus a black frame
(no candidate). The port draws
the reference's ``jax.random`` indices (``JaxDraws``, injected as
``sampler``). Held: ``ok`` equal, the pose within 1e-4 (measured: 6.6e-7
at most on these queries), ``point_ids`` equal on >= 99 % of keypoints
and the inlier count within 1 % (measured: all equal).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from coebslam_tpu.slam import frame as jframe
from coebslam_tpu.slam import vocabulary as jvoc
from coebslam_tpu.slam.relocalization import Relocalizer as JReloc
from coebslam_tpu.slam.system import System as JSystem
from coebslam_tpu_torch.ops.extractor import Features
from coebslam_tpu_torch.slam import frame as tframe
from coebslam_tpu_torch.slam import vocabulary as tvoc
from coebslam_tpu_torch.slam.relocalization import Relocalizer as TReloc
from test_torch_host_tracking import room_frames
from test_torch_keyframe_db import port_db_of, reloc_world

torch.set_num_threads(2)
N_MAP = 10
POSE_TOL = 1e-4


class JaxDraws:
    """The reference's RANSAC draws for a port object: one key split per
    RANSAC call (``self._rng, key = split(self._rng)``), then
    ``categorical`` over the valid rows."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)
        self.calls = 0

    def __call__(self, valid, n, k):
        self.key, sub = jax.random.split(self.key)
        self.calls += 1
        logits = jnp.where(jnp.asarray(valid.cpu().numpy()), 0.0, -1e9)
        return torch.from_numpy(np.asarray(jax.random.categorical(
            sub, logits[None, :], shape=(n, k)))).to(torch.int64)


def _t(x):
    return torch.from_numpy(np.array(x))


def depth_free(fd, zeros, full):
    """A FrameData with no depth and no virtual right coordinate."""
    obs = fd.obs
    return fd._replace(depth=zeros(fd.depth), ur=full(fd.ur, -1.0),
                       obs=obs.at[:, 2].set(-1.0) if hasattr(obs, "at")
                       else torch.cat([obs[:, :2], full(obs[:, 2:], -1.0)],
                                      1))


@pytest.fixture(scope="module")
def reloc_map():
    cfg, tc, frames, poses, voc, tv = reloc_world(N_MAP)
    js = JSystem(cfg, vocabulary=voc)
    for i, (g, d, _) in enumerate(frames):
        js.track_rgbd(g, d, stamp=i / 30.0)
    assert js.kf_db.registered.sum() >= 3
    return cfg, tc, js, voc, tv, room_frames(30, cfg)[0]


def _queries(cfg, tc, voc, tv, g, d):
    fj = jframe.process_rgbd(jnp.asarray(g), jnp.asarray(d), cfg.camera,
                             cfg.orb)
    ft = tframe.FrameData(Features(*(_t(x) for x in fj.feats)),
                          *(_t(x) for x in fj[1:]))
    ft = ft._replace(feats=ft.feats._replace(level=ft.feats.level.long()))
    wj = np.asarray(jvoc.transform_words(voc, fj.feats.desc,
                                         fj.feats.valid)[0])
    wt = tvoc.transform_words(tvoc.to_device(tv, "cpu"), ft.feats.desc,
                              ft.feats.valid)[0].numpy()
    np.testing.assert_array_equal(wt, wj)
    return fj, ft, wj


@pytest.mark.parametrize("frame,branch", [(8, "horn"), (8, "epnp"),
                                          (3, "horn"), (14, "epnp"),
                                          (None, "black")])
def test_relocalizer_matches_jax_with_its_draws(reloc_map, frame, branch):
    cfg, tc, js, voc, tv, frames = reloc_map
    if frame is None:
        g = np.zeros_like(frames[0][0])
        d = np.ones_like(frames[0][1])
    else:
        g, d, _ = frames[frame]
    fj, ft, words = _queries(cfg, tc, voc, tv, g, d)
    if branch == "epnp":
        fj = depth_free(fj, jnp.zeros_like, jnp.full_like)
        ft = depth_free(ft, torch.zeros_like, torch.full_like)
    jr = JReloc(cfg, js.map, js.kf_db)
    draws = JaxDraws(7)
    tr = TReloc(tc, js.map, port_db_of(js.kf_db, tv, js.map), device="cpu",
                sampler=draws)
    tried = []
    attempt = tr._attempt_pnp if branch == "epnp" else tr._attempt
    setattr(tr, attempt.__name__,
            lambda *a: tried.append(1) or attempt(*a))
    a = jr.relocalize(fj, words)
    b = tr.relocalize(ft, words)
    assert b.ok == a.ok, (a.n_inliers, b.n_inliers)
    if branch == "black":
        assert not b.ok and draws.calls == 0
        return
    assert tried and b.ok, b.n_inliers
    np.testing.assert_allclose(b.R, a.R, atol=POSE_TOL)
    np.testing.assert_allclose(b.t, a.t, atol=POSE_TOL)
    assert float((b.point_ids == a.point_ids).mean()) >= 0.99
    assert abs(b.n_inliers - a.n_inliers) <= 0.01 * a.n_inliers

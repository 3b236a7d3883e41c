"""Parity of the JAX package's last functions that the port had lacked
with their counterparts in the port, on the CPU, on inputs made from a
numpy seed:

- the blur metrics (``brenner_map``, ``tenengrad_map``, ``energy_map``,
  ``box_blur_scores(metric=)``), ``min_eig_response``,
  ``good_features(use_harris=)``, ``fast_score_map``, ``rgb_to_gray``;
- ``initializer_ops.reconstruct`` (the host route: one read of the RH
  choice, then that model only) with the reference's draws, held as
  ``tests/test_torch_host_sensors.py::test_reconstruct_matches`` holds
  ``reconstruct_graph``;
- ``level_penalty``, ``stereo_penalty``, the ``SE3`` methods,
  ``se3.relative``, ``so3.normalize_matrix``, ``camera.intrinsic_matrix``;
- ``OrbConfig.scale_factors``, ``DEFAULT_CONFIG``, the ``SENSOR_*`` names;
- ``LocalMapper.create_new_map_points``, ``fuse_neighbors`` and
  ``run_local_ba`` on one JAX arena copied into the port.

Tolerances: bit-equal where the result is integer or boolean (and the
penalties, whose values are 0 or BIG); 1e-5 relative for float maps and
poses, with an absolute floor of 1e-5 x the map's largest magnitude where
a map cancels to near zero (``min_eig_response``: a square root of a
difference); the selected corners of ``good_features`` equal, their
sub-pixel positions within 1e-4 px. ``reconstruct``: the same model and
``ok``, R within 1e-4 (1e-3 on the planar scene, where the pixel DLT is
ill-conditioned in float32), t within 1e-4 (1e-2), the triangulated sets
equal on >= 99 %. A rotation projected by SVD (``normalize_matrix``,
``SE3.normalize``): entries within 1e-5, as two SVD libraries give them
in float32. The mapper stages: keyframes and observations as
``tests/test_torch_host_tracking.py::assert_arenas_close`` holds them,
points within 1e-3 relative, as the triangulation's own parity test
holds them.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from coebslam_tpu import config as jcfg
from coebslam_tpu.geometry import camera as jcam, se3 as jse3, so3 as jso3
from coebslam_tpu.ops import blur as jblur, fast as jfast, \
    initializer_ops as jinit, lk_flow as jlk, matching as jmatch, \
    pyramid as jpyr
from coebslam_tpu.slam import system as jsys
from coebslam_tpu.slam.local_mapping import LocalMapper as JMapper
from coebslam_tpu.slam.tracking import Tracker as JTracker
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.geometry import camera as tcam, se3 as tse3, \
    so3 as tso3
from coebslam_tpu_torch.ops import blur as tblur, fast as tfast, \
    initializer_ops as tinit, lk_flow as tlk, matching as tmatch, \
    pyramid as tpyr
from coebslam_tpu_torch.slam import system as tsys
from coebslam_tpu_torch.slam.local_mapping import LocalMapper as TMapper
from test_torch_host_tracking import room_frames
from test_torch_loop_closing import _copying_views, port_arena_of
from test_torch_mono import JCAM, TCAM, jax_draws, two_view_scene
from test_tracking_e2e import small_config

torch.set_num_threads(2)
RTOL = 1e-5
ROT_TOL = 1e-5     # an SVD projection's entries (of unit scale), two libraries


def _t(x):
    return torch.from_numpy(np.array(x))


def _image(seed, h=96, w=128):
    """A textured grey image in [0, 255] (float32) with smooth parts."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    img = 120 + 60 * np.sin(xx / 7.0) * np.cos(yy / 5.0) \
        + rng.uniform(-40, 40, (h, w))
    img[20:50, 30:70] = rng.randint(0, 256, (30, 40))
    return np.clip(img, 0, 255).astype(np.float32)


def _boxes(seed):
    rng = np.random.RandomState(seed)
    b = np.stack([rng.uniform(0, 60, 4), rng.uniform(0, 40, 4),
                  rng.uniform(70, 127, 4), rng.uniform(50, 95, 4)], -1)
    b[2] = -1.0                                  # an absent box
    return b.astype(np.float32)


def _close_map(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=RTOL,
                               atol=RTOL * max(float(np.abs(j).max()), 1.0))


@pytest.mark.parametrize("name", ["brenner_map", "tenengrad_map",
                                  "energy_map", "laplacian_map"])
def test_blur_maps(name):
    img = _image(0)
    _close_map(getattr(tblur, name)(_t(img)),
               getattr(jblur, name)(jnp.asarray(img)))


@pytest.mark.parametrize("metric", ["laplacian", "brenner", "tenengrad",
                                    "energy"])
def test_box_blur_scores(metric):
    img, boxes = _image(1), _boxes(1)
    j = np.asarray(jblur.box_blur_scores(jnp.asarray(img),
                                         jnp.asarray(boxes), metric=metric))
    t = tblur.box_blur_scores(_t(img), _t(boxes), metric=metric).numpy()
    np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
    assert np.isinf(t[2]) and np.isfinite(t).sum() == 3
    fin = np.isfinite(j)
    np.testing.assert_allclose(t[fin], j[fin], rtol=RTOL)
    if metric == "laplacian":                   # the default, as before
        np.testing.assert_array_equal(
            tblur.box_blur_scores(_t(img), _t(boxes)).numpy(), t)


def test_min_eig_response():
    img = _image(2)
    _close_map(tlk.min_eig_response(_t(img)),
               jlk.min_eig_response(jnp.asarray(img)))


@pytest.mark.parametrize("use_harris", [True, False],
                         ids=["harris", "shi_tomasi"])
def test_good_features(use_harris):
    img = _image(3)
    juv, jv = jlk.good_features(jnp.asarray(img), 64, use_harris=use_harris)
    tuv, tv = tlk.good_features(_t(img), 64, use_harris=use_harris)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.sum() >= 16
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), atol=1e-4)


@pytest.mark.parametrize("threshold", [7.0, 20.0])
def test_fast_score_map(threshold):
    img = np.round(_image(4))                   # integer scores, ties
    j = np.asarray(jfast.fast_score_map(jnp.asarray(img), threshold))
    t = tfast.fast_score_map(_t(img), threshold).numpy()
    np.testing.assert_array_equal(t, j)
    assert (t > 0).sum() > 50


def test_rgb_to_gray():
    rgb = np.random.RandomState(5).randint(0, 256, (24, 32, 3)).astype(
        np.uint8)
    j = np.asarray(jpyr.rgb_to_gray(jnp.asarray(rgb)))
    t = tpyr.rgb_to_gray(_t(rgb))
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, rtol=RTOL)


def test_system_to_gray_uses_rgb_to_gray():
    """The System's colour conversion is ``rgb_to_gray``'s, bit for bit."""
    rgb = np.random.RandomState(6).randint(0, 256, (24, 32, 3)).astype(
        np.uint8)
    s = tsys.System(tcfg.SystemConfig(), device="cpu")
    np.testing.assert_array_equal(s._to_gray(rgb).numpy(),
                                  tpyr.rgb_to_gray(_t(rgb)).numpy())
    gray = rgb[..., 0]
    np.testing.assert_array_equal(s._to_gray(gray).numpy(),
                                  gray.astype(np.float32))
    # A frame buffer refilled in place gives the new frame's grey image.
    buf = _t(rgb)
    first = s._to_gray(buf).clone()
    buf.copy_(_t(255 - rgb))
    second = s._to_gray(buf)
    assert not torch.equal(first, second)
    np.testing.assert_array_equal(second.numpy(),
                                  tpyr.rgb_to_gray(_t(255 - rgb)).numpy())


@pytest.mark.parametrize("planar", [False, True], ids=["general", "planar"])
def test_reconstruct(planar):
    uv1, uv2, inb, T2 = two_view_scene(4 if planar else 0, planar=planar)
    key = jax.random.PRNGKey(1)
    jr = jinit.reconstruct(jnp.asarray(uv1), jnp.asarray(uv2),
                           jnp.asarray(inb), JCAM, key)
    idx_h, idx_f = jax_draws(key, inb)
    tr = tinit.reconstruct(_t(uv1), _t(uv2), _t(inb), TCAM, idx_h, idx_f)
    assert tr.used_homography is jr.used_homography is planar
    assert bool(tr.ok) and bool(jr.ok)
    tol_R, tol_t = (1e-3, 1e-2) if planar else (1e-4, 1e-4)
    np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=tol_R)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=tol_t)
    gj, gt = np.asarray(jr.good), tr.good.numpy()
    assert (gj == gt).mean() >= 0.99
    # The host route and the graph route agree on the same draws.
    tg = tinit.reconstruct_graph(_t(uv1), _t(uv2), _t(inb), TCAM, idx_h,
                                 idx_f)
    assert bool(tg.used_homography) == planar
    np.testing.assert_allclose(tr.R.numpy(), tg.R.numpy(), atol=1e-6)


def test_level_and_stereo_penalties():
    rng = np.random.RandomState(7)
    lq, lt = rng.randint(0, 8, 40), rng.randint(0, 8, 50)
    for lo, hi in ((-1, 1), (0, 2), (-2, 0)):
        np.testing.assert_array_equal(
            tmatch.level_penalty(_t(lq), _t(lt), lo, hi).numpy(),
            np.asarray(jmatch.level_penalty(jnp.asarray(lq),
                                            jnp.asarray(lt), lo, hi)))
    up = rng.uniform(0, 640, 40).astype(np.float32)
    ut = rng.uniform(0, 640, 50).astype(np.float32)
    ut[::5] = -1.0                              # no depth there
    up[:20] = ut[:20] + rng.uniform(-4, 4, 20).astype(np.float32)
    for r in (3.0, rng.uniform(1, 6, 40).astype(np.float32)):
        rt = r if np.ndim(r) == 0 else _t(r)
        j = np.asarray(jmatch.stereo_penalty(jnp.asarray(up),
                                             jnp.asarray(ut),
                                             jnp.asarray(r)))
        t = tmatch.stereo_penalty(_t(up), _t(ut), rt).numpy()
        np.testing.assert_array_equal(t, j)
        assert 0 < (t == 0).sum() < t.size


def _poses(seed, n=5):
    rng = np.random.RandomState(seed)
    R = np.asarray(jso3.exp(jnp.asarray(rng.randn(n, 3).astype(np.float32))))
    t = rng.randn(n, 3).astype(np.float32)
    return R, t


def test_se3_methods():
    R, t = _poses(8)
    Ra, ta = _poses(9)
    J, T = jse3.SE3(jnp.asarray(R), jnp.asarray(t)), tse3.SE3(_t(R), _t(t))
    Ja, Ta = jse3.SE3(jnp.asarray(Ra), jnp.asarray(ta)), \
        tse3.SE3(_t(Ra), _t(ta))
    M = T.as_matrix()
    np.testing.assert_array_equal(M.numpy(), np.asarray(J.as_matrix()))
    back = tse3.SE3.from_matrix(M)
    np.testing.assert_array_equal(back.R.numpy(), R)
    np.testing.assert_array_equal(back.t.numpy(), t)
    pts = np.random.RandomState(10).randn(5, 7, 3).astype(np.float32)
    np.testing.assert_allclose(T.apply(_t(pts)).numpy(),
                               np.asarray(J.apply(jnp.asarray(pts))),
                               rtol=RTOL, atol=1e-6)
    one = tse3.SE3(_t(R[0]), _t(t[0]))
    np.testing.assert_allclose(
        one.apply(_t(pts[0, 0])).numpy(),
        np.asarray(jse3.SE3(jnp.asarray(R[0]), jnp.asarray(t[0])).apply(
            jnp.asarray(pts[0, 0]))), rtol=RTOL, atol=1e-6)
    rel_t, rel_j = tse3.relative(T, Ta), jse3.relative(J, Ja)
    np.testing.assert_allclose(rel_t.R.numpy(), np.asarray(rel_j.R),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(rel_t.t.numpy(), np.asarray(rel_j.t),
                               rtol=RTOL, atol=1e-6)
    drift = R + 1e-3 * np.random.RandomState(11).randn(5, 3, 3).astype(
        np.float32)
    nt = tse3.SE3(_t(drift), _t(t)).normalize()
    nj = jse3.SE3(jnp.asarray(drift), jnp.asarray(t)).normalize()
    np.testing.assert_allclose(nt.R.numpy(), np.asarray(nj.R), rtol=0,
                               atol=ROT_TOL)
    np.testing.assert_array_equal(nt.t.numpy(), t)


def test_normalize_matrix():
    R, _ = _poses(12, 8)
    rng = np.random.RandomState(12)
    drift = (R + 1e-2 * rng.randn(8, 3, 3)).astype(np.float32)
    drift[0] = -drift[0]                        # a reflection: det -1
    t = tso3.normalize_matrix(_t(drift)).numpy()
    j = np.asarray(jso3.normalize_matrix(jnp.asarray(drift)))
    np.testing.assert_allclose(t, j, rtol=0, atol=ROT_TOL)
    np.testing.assert_allclose(np.linalg.det(t), 1.0, atol=1e-5)


def test_intrinsic_matrix():
    cam = dict(width=320, height=240, fx=267.7, fy=269.6, cx=160.05,
               cy=123.8)
    for jc, tc in ((jcfg.CameraConfig(), tcfg.CameraConfig()),
                   (jcfg.CameraConfig(**cam), tcfg.CameraConfig(**cam))):
        np.testing.assert_array_equal(tcam.intrinsic_matrix(tc).numpy(),
                                      np.asarray(jcam.intrinsic_matrix(jc)))


def test_config_and_sensor_names():
    for kw in ({}, dict(n_levels=4, scale_factor=1.5)):
        assert tcfg.OrbConfig(**kw).scale_factors \
            == jcfg.OrbConfig(**kw).scale_factors
    assert tcfg.config_from_dict(dataclasses.asdict(jcfg.DEFAULT_CONFIG)) \
        == tcfg.DEFAULT_CONFIG == tcfg.SystemConfig()
    for name in ("SENSOR_RGBD", "SENSOR_MONOCULAR", "SENSOR_STEREO"):
        assert getattr(tsys, name) == getattr(jsys, name)


@pytest.fixture(scope="module")
def unmapped_arena():
    """The JAX Tracker's arena over the room's first frames with no mapper:
    keyframes and their own points, nothing triangulated between them; and
    its keyframes in the order they were made."""
    cfg = small_config()
    frames, _ = room_frames(5, cfg)       # a keyframe on each frame
    jt = JTracker(cfg)
    for i, (g, d, _) in enumerate(frames):
        jt.process_frame(g, d, stamp=i / 30.0)
    kfs = jt.map.valid_keyframes()
    assert len(kfs) >= 3
    return cfg, jt.map, [int(k) for k in kfs[np.argsort(jt.map.kf_seq[kfs])]]


def _assert_mapped_close(j, t, where):
    """Keyframes equal in number, validity and ids, poses within 1e-4,
    observations equal on >= 99 % of slots, live points equal on >= 99.5 %
    of rows and, where live in both, within 1e-3 of their distance from
    the origin (the triangulation's tolerance,
    tests/test_torch_mono.py::test_triangulate_pair_matches)."""
    assert (t.n_kf, t.n_pt) == (j.n_kf, j.n_pt), where
    np.testing.assert_array_equal(t.kf_valid, j.kf_valid)
    np.testing.assert_array_equal(t.kf_seq, j.kf_seq)
    np.testing.assert_allclose(t.kf_R, j.kf_R, atol=1e-4)
    np.testing.assert_allclose(t.kf_t, j.kf_t, atol=1e-4)
    assert (t.kf_obs_pt == j.kf_obs_pt).mean() >= 0.99, where
    assert (t.pt_valid == j.pt_valid).mean() >= 0.995, where
    both = t.pt_valid & j.pt_valid
    gap = np.linalg.norm(t.pt_pos[both] - j.pt_pos[both], axis=1)
    assert (gap <= 1e-3 * np.linalg.norm(j.pt_pos[both], axis=1)).all(), \
        (where, float(gap.max()))


def test_local_mapper_stage_wrappers(unmapped_arena):
    """Each keyframe through the three stages in turn, as the mapper takes
    them, on both packages' copies of one arena."""
    cfg, arena, kfs = unmapped_arena
    tc = tcfg.config_from_dict(dataclasses.asdict(cfg))
    jm = copy.deepcopy(arena)
    jm.on_keyframe_removed = []
    jm.kf_R, jm.kf_t = _copying_views(jm.kf_R), _copying_views(jm.kf_t)
    tm = port_arena_of(jm, tc)
    jmap, tmap = JMapper(cfg, jm), TMapper(tc, tm, device="cpu")
    added = 0
    for kf in kfs:
        for stage in ("create_new_map_points", "fuse_neighbors",
                      "run_local_ba"):
            n_pt = len(jm.valid_points())
            getattr(jmap, stage)(kf)
            getattr(tmap, stage)(kf)
            _assert_mapped_close(jm, tm, (kf, stage))
            if stage == "create_new_map_points":
                added += len(jm.valid_points()) - n_pt
    assert added > 0                            # triangulation added points

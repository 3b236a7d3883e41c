"""Parity of the port's realtime monocular path with the JAX package on the
CPU: the two-view initializer (H/F fit, decompositions, hypothesis choice),
two-keyframe triangulation, the monocular ``rt_step`` state by state
through initialisation and the first triangulating keyframe, and (slow
tier) the JAX package's end-to-end monocular gates on the port.

A torch generator cannot reproduce ``jax.random`` draws, so the tests
compute the reference's RANSAC samples from its key and inject them into
the port (``idx_h``, ``idx_f``; ``rt_step(init_idx=)``).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from coebslam_tpu import config as jcfg
from coebslam_tpu.geometry import se3 as jse3
from coebslam_tpu.ops import extractor as jex, initializer_ops as jinit, \
    triangulation as jtri
from coebslam_tpu.slam import realtime as jrt
from coebslam_tpu.utils import synthetic as jsyn
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.eval import ate as tate
from coebslam_tpu_torch.geometry.se3 import SE3 as TSE3
from coebslam_tpu_torch.ops import brief as tbrief, \
    initializer_ops as tinit, triangulation as ttri
from coebslam_tpu_torch.slam import realtime as trt
from coebslam_tpu_torch.utils import synthetic as tsyn
from chip_smoke import mono_scene, mono_summary
from test_torch_realtime import CAM, LIM, assert_states_close

torch.set_num_threads(1)

JCAM = jcfg.CameraConfig()
TCAM = tcfg.CameraConfig()
XI = np.asarray([0.02, -0.04, 0.01, 0.3, 0.05, 0.02], np.float32)


def two_view_scene(seed, n=300, planar=False):
    """The scenes of tests/test_monocular.py, drawn from a numpy seed:
    points in front of camera 1 (on the plane z = 4 when ``planar``), camera
    2 at exp(XI), pixel noise 0.3; returns uv1, uv2, in-bounds mask, T2."""
    rng = np.random.RandomState(seed)
    z = np.full(n, 4.0) if planar else rng.uniform(2.5, 7.0, n)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), z],
                 -1).astype(np.float32)
    T2 = jse3.exp(jnp.asarray(XI))
    R2, t2 = np.asarray(T2.R), np.asarray(T2.t)

    def project(P):
        return np.stack([JCAM.fx * P[:, 0] / P[:, 2] + JCAM.cx,
                         JCAM.fy * P[:, 1] / P[:, 2] + JCAM.cy], -1)

    uv1, uv2 = project(X), project(X @ R2.T + t2)
    noise = (0.3 * rng.randn(n, 2)).astype(np.float32)
    inb = ((uv1 > 5) & (uv1 < [635.0, 475.0])).all(1) \
        & ((uv2 > 5) & (uv2 < [635.0, 475.0])).all(1)
    return ((uv1 + noise).astype(np.float32), (uv2 + noise).astype(np.float32),
            inb, T2)


def jax_draws(key, valid, n_hypotheses=200):
    """The samples the reference's fit_models draws from ``key``."""
    k1, k2 = jax.random.split(key)
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    idx_h = jax.random.categorical(k1, logits[None], shape=(n_hypotheses, 4))
    idx_f = jax.random.categorical(k2, logits[None], shape=(n_hypotheses, 8))
    return (torch.from_numpy(np.asarray(idx_h, np.int64)),
            torch.from_numpy(np.asarray(idx_f, np.int64)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _models(uv1, uv2, inb, seed):
    key = jax.random.PRNGKey(seed)
    jm = jinit.fit_models(jnp.asarray(uv1), jnp.asarray(uv2),
                          jnp.asarray(inb), key)
    jr = jinit.reconstruct_graph(jnp.asarray(uv1), jnp.asarray(uv2),
                                 jnp.asarray(inb), JCAM, key)
    return jm, jr, jax_draws(key, inb)


@pytest.mark.parametrize("planar", [False, True], ids=["general", "planar"])
def test_reconstruct_graph_matches(planar):
    """fit_models and reconstruct_graph with the reference's draws: the
    same model choice, scores within 1e-3 relative, F within 1e-3
    relative, inlier sets equal on >= 99 %.

    H (scaled to H[2, 2] = 1) agrees only within 5e-2 of its largest
    entry: the pixel-coordinate DLT is ill-conditioned in float32 (see
    ``initializer_ops``; 4.5 % on the general scene's chosen H, 0.6 % on
    the planar one's). On the planar scene two hypotheses tie in score
    (the reference's #59 at 3594.49 against the port's #88 at 3594.50),
    so R agrees within 1e-3 and the unit t within 1e-2 there; on the
    general scene F is used and R and t agree within 1e-4. Both recover the
    true rotation within 1 degree."""
    uv1, uv2, inb, T2 = two_view_scene(4 if planar else 0, planar=planar)
    jm, jr, (idx_h, idx_f) = _models(uv1, uv2, inb, 1)
    tm = tinit.fit_models(_t(uv1), _t(uv2), _t(inb), idx_h, idx_f)
    tr = tinit.reconstruct_graph(_t(uv1), _t(uv2), _t(inb), TCAM, idx_h,
                                 idx_f)

    assert bool(tr.used_homography) == bool(jr.used_homography) == planar
    assert bool(tr.ok) and bool(jr.ok)
    for a, b in ((tm.score_h, jm.score_h), (tm.score_f, jm.score_f)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-3)
    Hj, Ht = np.asarray(jm.H), tm.H.numpy()
    Hj, Ht = Hj / Hj[2, 2], Ht / Ht[2, 2]
    assert np.abs(Ht - Hj).max() <= 5e-2 * np.abs(Hj).max()
    np.testing.assert_allclose(tm.F.numpy(), np.asarray(jm.F), rtol=1e-3,
                               atol=1e-3 * np.abs(np.asarray(jm.F)).max())
    assert (tm.inliers_h.numpy() == np.asarray(jm.inliers_h)).mean() >= 0.99
    assert (tm.inliers_f.numpy() == np.asarray(jm.inliers_f)).mean() >= 0.99
    tol_R, tol_t = (1e-3, 1e-2) if planar else (1e-4, 1e-4)
    np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=tol_R)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=tol_t)
    gj, gt = np.asarray(jr.good), tr.good.numpy()
    assert gj.sum() >= 200 and (gj == gt).mean() >= 0.99
    dR = tr.R.numpy() @ np.asarray(T2.R).T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert ang < 1.0


@pytest.mark.parametrize("planar", [False, True], ids=["general", "planar"])
def test_recover_motion_matches(planar):
    """Given the reference's fitted models, motion recovery (both
    decompositions, CheckRT on 8 hypotheses, the RH rule and the choice)
    matches: R and t within 1e-4, good equal on >= 99 % and points within
    1e-3 relative where good on both."""
    uv1, uv2, inb, _ = two_view_scene(4 if planar else 0, planar=planar)
    jm, jr, _ = _models(uv1, uv2, inb, 1)
    models = tinit.TwoViewModels(*[_t(x) for x in jm])
    tr = tinit.recover_motion(models, _t(uv1), _t(uv2), TCAM)
    assert bool(tr.used_homography) == bool(jr.used_homography) == planar
    assert bool(tr.ok) == bool(jr.ok)
    np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=1e-4)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=1e-4)
    gj, gt = np.asarray(jr.good), tr.good.numpy()
    assert gj.sum() >= 200 and (gj == gt).mean() >= 0.99
    both = gj & gt
    np.testing.assert_allclose(tr.points.numpy()[both],
                               np.asarray(jr.points)[both], rtol=1e-3)


def _as_set(Rs_a, ts_a, Rs_b, ts_b, atol):
    """Each hypothesis of a has one of b within atol (R and t)."""
    for R, t in zip(Rs_a, ts_a):
        d = np.maximum(np.abs(Rs_b - R).max((1, 2)), np.abs(ts_b - t).max(1))
        assert d.min() <= atol, d.min()


def test_decompositions_match_as_sets():
    """decompose_essential and decompose_homography give the reference's
    hypotheses, possibly in another order (LAPACK's SVD signs), and the
    pixel-to-normalized homography conversion is the reference's."""
    T2 = jse3.exp(jnp.asarray(XI))
    R, t = np.asarray(T2.R), np.asarray(T2.t)
    tx = np.asarray([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]],
                    np.float32)
    E = (tx @ R).astype(np.float32)
    jh = jinit.decompose_essential(jnp.asarray(E))
    Rt, tt = tinit.decompose_essential(_t(E))
    Rj = np.stack([np.asarray(h[0]) for h in jh])
    tj = np.stack([np.asarray(h[1]) for h in jh])
    _as_set(Rj, tj, Rt.numpy(), tt.numpy(), 1e-4)
    _as_set(Rt.numpy(), tt.numpy(), Rj, tj, 1e-4)

    n = np.asarray([0.1, -0.2, 1.0], np.float32)
    H_px = (np.asarray([[JCAM.fx, 0, JCAM.cx], [0, JCAM.fy, JCAM.cy],
                        [0, 0, 1]], np.float32)
            @ (R + np.outer(t, n) / 4.0)
            @ np.linalg.inv(np.asarray([[JCAM.fx, 0, JCAM.cx],
                                        [0, JCAM.fy, JCAM.cy], [0, 0, 1]],
                                       np.float32))).astype(np.float32)
    Hn_j = np.asarray(jinit._pixels_to_normalized_h(jnp.asarray(H_px), JCAM))
    Hn_t = tinit._pixels_to_normalized_h(_t(H_px), TCAM).numpy()
    np.testing.assert_allclose(Hn_t, Hn_j, rtol=1e-5, atol=1e-6)
    jh = jinit.decompose_homography(jnp.asarray(Hn_j))
    Rt, tt, nt = tinit.decompose_homography(_t(Hn_j))
    Rj = np.stack([np.asarray(h[0]) for h in jh])
    tj = np.stack([np.asarray(h[1]) for h in jh])
    assert Rt.shape == (8, 3, 3) and nt.shape == (8, 3)
    _as_set(Rj, tj, Rt.numpy(), tt.numpy(), 1e-4)
    _as_set(Rt.numpy(), tt.numpy(), Rj, tj, 1e-4)


def test_triangulate_pair_matches():
    """Two rendered keyframes of the 0.8 m orbit, the reference's features
    and ground-truth poses: the same epipolar matches and gates, points
    within 1e-3 relative; fundamental_from_poses within 1e-5 relative
    (1e-8 absolute, for an entry that cancels to 6e-4)."""
    cfg = jcfg.SystemConfig(orb=jcfg.OrbConfig(n_levels=4,
                                               max_keypoints=1024))
    tc = tcfg.config_from_dict(dataclasses.asdict(cfg))
    planes = jsyn.make_room(seed=0)
    poses = jsyn.camera_trajectory(60, radius=0.8)
    ext = jax.jit(lambda a: jex.extract(a, cfg.orb))
    f1, f2 = (ext(jsyn.render(cfg.camera, poses[i], planes)[0])
              for i in (1, 0))
    T1, T2 = poses[1], poses[0]
    lvl2 = f2.level.astype(jnp.float32)
    ur2 = jnp.full(lvl2.shape, -1.0)
    jres = jtri.triangulate_pair(
        f1.uv, f1.signed_desc(), f1.valid, f1.level, f2.uv, f2.signed_desc(),
        f2.valid, lvl2, ur2, T1, T2, cfg.camera, cfg.orb, cfg.matcher)
    sd = lambda f: tbrief.to_signed(tbrief.unpack_bits(_t(f.desc)))
    tT1 = TSE3(_t(T1.R), _t(T1.t))
    tT2 = TSE3(_t(T2.R), _t(T2.t))
    tres = ttri.triangulate_pair(
        _t(f1.uv), sd(f1), _t(f1.valid), _t(f1.level).long(), _t(f2.uv),
        sd(f2), _t(f2.valid), _t(lvl2), _t(ur2), tT1, tT2, tc.camera, tc.orb,
        tc.matcher)
    np.testing.assert_allclose(
        ttri.fundamental_from_poses(tT1, tT2, tc.camera).numpy(),
        np.asarray(jtri.fundamental_from_poses(T1, T2, cfg.camera)),
        rtol=1e-5, atol=1e-8)
    gj = np.asarray(jres.good)
    assert gj.sum() > 100
    np.testing.assert_array_equal(tres.good.numpy(), gj)
    np.testing.assert_array_equal(tres.idx2.numpy(), np.asarray(jres.idx2))
    np.testing.assert_allclose(tres.points.numpy()[gj],
                               np.asarray(jres.points)[gj], rtol=1e-3)


def test_nanmedian_interpolates_like_jax():
    rng = np.random.RandomState(0)
    for n, n_nan in ((10, 3), (11, 3), (7, 0), (4, 4), (1, 0)):
        z = rng.rand(n).astype(np.float32)
        z[rng.permutation(n)[:n_nan]] = np.nan
        a = float(trt.nanmedian(torch.from_numpy(z)))
        b = float(jnp.nanmedian(jnp.asarray(z)))
        assert (np.isnan(a) and np.isnan(b)) or a == b, (n, n_nan, a, b)


JMONO = jcfg.SystemConfig(
    camera=jcfg.CameraConfig(**CAM),
    orb=jcfg.OrbConfig(n_levels=4, max_keypoints=1024),
    tracking=jcfg.TrackingConfig(max_frames_between_kf=3),
    sensor="monocular", use_dynamic_filtering=False)
N_MONO_STEPS = 7


def test_rt_step_mono_state_by_state(monkeypatch):
    """Monocular frames of the 0.8 m orbit, each from the reference's state
    before it. At an initialisation attempt both packages match the same
    correspondences; the port fits its models with the reference's draws
    (scores within 1e-3 relative of the reference's) and then goes on from
    the reference's models, since the float32 DLT gives H only to its
    conditioning (``test_reconstruct_graph_matches``). Both initialise on
    the same frame at the same map scale (median depth, 1e-4 relative) and
    then agree as in ``test_rt_step_state_by_state`` through the first
    triangulating keyframe."""
    tc = tcfg.config_from_dict(dataclasses.asdict(JMONO))
    jlim, tlim = jrt.RTLimits(**LIM), trt.RTLimits(**LIM)
    seen = {"mask": [], "models": [], "port_mask": []}
    orig_rg, orig_fit, orig_tfit = (jinit.reconstruct_graph,
                                    jinit.fit_models, tinit.fit_models)

    def logged_rg(p1, p2, valid, *a, **kw):
        jax.debug.callback(lambda v: seen["mask"].append(np.asarray(v)),
                           valid)
        return orig_rg(p1, p2, valid, *a, **kw)

    def logged_fit(*a, **kw):
        m = orig_fit(*a, **kw)
        jax.debug.callback(lambda *x: seen["models"].append(
            jinit.TwoViewModels(*[np.asarray(v) for v in x])), *m)
        return m

    def port_fit(p1, p2, valid, *a, **kw):
        seen["port_mask"].append(valid.numpy().copy())
        m = orig_tfit(p1, p2, valid, *a, **kw)
        ref = seen["models"][-1]
        for x, y in ((m.score_h, ref.score_h), (m.score_f, ref.score_f)):
            np.testing.assert_allclose(float(x), float(y), rtol=1e-3)
        return tinit.TwoViewModels(*[_t(x) for x in ref])

    monkeypatch.setattr(jinit, "reconstruct_graph", logged_rg)
    monkeypatch.setattr(jinit, "fit_models", logged_fit)
    monkeypatch.setattr(tinit, "fit_models", port_fit)
    step = jax.jit(lambda g, d, b, s, st: jrt.rt_step(g, d, b, s, st, JMONO,
                                                      jlim))
    planes = jsyn.make_room(seed=0)
    poses = jsyn.camera_trajectory(60, radius=0.8)
    zero = np.zeros((CAM["height"], CAM["width"]), np.uint16)
    no_boxes = np.full((16, 4), -1.0, np.float32)
    st_np = jax.tree.map(np.asarray, jrt.init_state(JMONO, jlim))
    init_frame, n_kf_seen = {}, []
    for i in range(N_MONO_STEPS):
        g = np.asarray(jsyn.render(JMONO.camera, poses[i], planes)[0])
        prev = st_np
        st_np = jax.tree.map(np.asarray, step(
            jnp.asarray(g), jnp.asarray(zero), jnp.asarray(no_boxes),
            np.uint32(i), jax.tree.map(jnp.asarray, prev)))
        init_idx = None
        if len(seen["mask"]) > len(seen["port_mask"]):
            key = jax.random.fold_in(jax.random.PRNGKey(np.uint32(i)), 7)
            init_idx = jax_draws(key, seen["mask"][-1])
        st_t, n_new, attempt = trt._rt_step(
            torch.from_numpy(g), torch.from_numpy(zero),
            torch.from_numpy(no_boxes), trt.state_from_numpy(prev, "cpu"),
            tc, tlim, generator=torch.Generator().manual_seed(i),
            init_idx=init_idx)
        assert len(seen["mask"]) == len(seen["port_mask"]), i
        if init_idx is not None:
            np.testing.assert_array_equal(seen["port_mask"][-1],
                                          seen["mask"][-1])
        for name, st_n in (("jax", st_np.n_kf), ("port", st_t.n_kf)):
            if int(st_n) >= 2 and name not in init_frame:
                init_frame[name] = i
        if init_frame.get("port") == i:
            assert n_new >= 2 and bool(attempt.ok)
            scale_j = 1.0 / np.linalg.norm(st_np.kf_t[1])
            scale_t = 1.0 / float(torch.linalg.norm(st_t.kf_t[1]))
            # The median point sits ~35 baselines deep: the triangulation's
            # 3x3 normal equations amplify float32 rounding (sums in
            # another order) to 4.3e-5 here.
            np.testing.assert_allclose(scale_t, scale_j, rtol=1e-4)
        assert_states_close(st_np, st_t, i, permuted=True)
        n_kf_seen.append(int(st_np.n_kf))
    assert init_frame["jax"] == init_frame["port"] <= 2
    assert n_kf_seen[-1] >= 3                # a triangulating keyframe
    S = tlim.spawn_per_kf
    assert int(st_np.pt_valid[2 * S:3 * S].sum()) > 20


@pytest.mark.slow
class TestMonoGates:
    """tests/test_realtime_mono.py's gates on the port, on the CPU, with the
    reference's initialisation draws (the JAX package's key for each
    frame's seed) injected.

    At this cut (4 levels, 1024 keypoints) the gates hinge on the
    initialisation's draws in both packages: the JAX package misses them
    at two of five seed offsets (3000: 22 frames lost; 4000: 19), and the
    port with its own generator misses them at seed 0 (12 lost). With the
    same draws the port tracks 59 of 60 frames (Sim3 ATE 0.99 cm; the JAX
    package 2.36 cm). At full width ([12] of chip_smoke.py) the port meets
    them with its own draws."""

    def test_zero_sync_monocular_tracks_and_maps(self, monkeypatch):
        cfg = tcfg.SystemConfig(
            orb=tcfg.OrbConfig(max_keypoints=1024, n_levels=4,
                               n_features=1000),
            tracking=tcfg.TrackingConfig(max_frames_between_kf=10),
            sensor="monocular", use_dynamic_filtering=False)
        frames, gt = mono_scene(tsyn, cfg.camera, "cpu")
        lim = trt.RTLimits(max_kf=16, spawn_per_kf=256, ba_window=6,
                           local_window=6, max_frames=128)
        rt = trt.RealtimeSlam(cfg, lim, device="cpu")
        fit = tinit.fit_models

        def reference_draws(p1, p2, valid, idx_h=None, idx_f=None, **kw):
            key = jax.random.fold_in(
                jax.random.PRNGKey(np.uint32(rt._seed)), 7)
            return fit(p1, p2, valid, *jax_draws(key, valid.numpy()), **kw)

        monkeypatch.setattr(tinit, "fit_models", reference_draws)
        for i, g in enumerate(frames):
            rt.track_mono(g, stamp=i / 30.0)
        res = rt.finish()
        est = np.asarray([-R.T @ t for R, t in zip(res["R"], res["t"])])
        s = mono_summary(res["ok"], est, gt, tate)
        assert res["n_kf"] >= 3, res["n_kf"]
        assert s["first_ok"] <= 10, s
        assert s["lost_after"] <= 3, s
        assert s["ate_sim3_m"] < 0.05, s

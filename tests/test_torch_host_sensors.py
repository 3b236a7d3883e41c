"""Parity of the port's host stereo and monocular entries with the JAX
package on the CPU: the JAX host two-view ``reconstruct`` against its
counterpart in the port, ``reconstruct_graph``, on the scenes of
``tests/test_monocular.py`` with the reference's draws injected (a torch
generator cannot reproduce ``jax.random``), a few frames of
``System.track_stereo`` on the stereo room of
``tests/test_stereo_checkpoint.py``, and the monocular initialisation of
``System.track_monocular`` on the 0.8 m orbit of
``tests/test_monocular.py::TestMonocularE2E`` with the initializer's draws
injected through ``System(init_sampler=)``.

Tolerances: ``reconstruct`` at the initializer's (the same model and
``ok``; R within 1e-3 and the unit t within 1e-2 on the planar scene,
where the pixel DLT is ill-conditioned in float32, 1e-4 on the general
one; triangulated sets equal on >= 99 %). The Systems by the rules of
``tests/test_torch_host_tracking.py`` (states equal, poses within 1e-4,
arenas close). The monocular initialisation's homography comes from a
DLT that is ill-conditioned in float32 (``ops/initializer_ops.py``), so
its recovered pose differs by ~1e-4 and one of ~570 points may fall on
the other side of the reprojection gate: the initial map's points are
held by their median (1e-3), 99th percentile (5e-3) and largest (5e-2)
gap at median depth 1, and the frame tracked after it with poses within
1e-3.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from coebslam_tpu.config import (CameraConfig, MapConfig, OrbConfig,
                                 SystemConfig, TrackingConfig)
from coebslam_tpu.ops import initializer_ops as jinit
from coebslam_tpu.slam.system import System as JSystem
from coebslam_tpu.utils import synthetic as jsyn
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.ops import initializer_ops as tinit
from coebslam_tpu_torch.slam import system as tsys
from test_stereo_checkpoint import render_stereo, stereo_config
from test_torch_host_tracking import (assert_arenas_close,
                                      assert_tracker_states_equal)
from test_torch_mono import JCAM, TCAM, jax_draws, two_view_scene

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("planar", [False, True], ids=["general", "planar"])
def test_reconstruct_matches(planar):
    uv1, uv2, inb, T2 = two_view_scene(4 if planar else 0, planar=planar)
    key = jax.random.PRNGKey(1)
    jr = jinit.reconstruct(jnp.asarray(uv1), jnp.asarray(uv2),
                           jnp.asarray(inb), JCAM, key)
    idx_h, idx_f = jax_draws(key, inb)
    tr = tinit.reconstruct_graph(_t(uv1), _t(uv2), _t(inb), TCAM, idx_h,
                                 idx_f)
    assert bool(tr.used_homography) == bool(jr.used_homography) == planar
    assert bool(tr.ok) and bool(jr.ok)
    tol_R, tol_t = (1e-3, 1e-2) if planar else (1e-4, 1e-4)
    np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=tol_R)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=tol_t)
    gj, gt = np.asarray(jr.good), tr.good.numpy()
    assert (gj == gt).mean() >= 0.99
    both = gj & gt
    Xj, Xt = np.asarray(jr.points)[both], tr.points.numpy()[both]
    np.testing.assert_allclose(Xt, Xj, rtol=0,
                               atol=(1e-1 if planar else 1e-3)
                               * np.abs(Xj).max())
    # Both recover the true rotation within a degree.
    dR = tr.R.numpy() @ np.asarray(T2.R).T
    assert np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))) < 1


def test_reconstruct_draws_from_generator():
    """Without given samples, the generator draws them: the same seed gives
    the same result."""
    uv1, uv2, inb, _ = two_view_scene(0)
    runs = [tinit.reconstruct_graph(
        _t(uv1), _t(uv2), _t(inb), TCAM,
        generator=torch.Generator().manual_seed(5)) for _ in range(2)]
    assert bool(runs[0].ok) and not bool(runs[0].used_homography)
    torch.testing.assert_close(runs[0].R, runs[1].R, rtol=0, atol=0)


N_STEREO = 4


def test_host_stereo_frame_by_frame():
    cfg = stereo_config()
    planes = jsyn.make_room(seed=0)
    poses = jsyn.camera_trajectory(40, radius=0.35)[:N_STEREO]
    js = JSystem(cfg)
    ts = tsys.System(tcfg.config_from_dict(dataclasses.asdict(cfg)),
                     device="cpu")
    for i, p in enumerate(poses):
        gl, gr = (np.asarray(x) for x in render_stereo(cfg, p, planes)[:2])
        rj = js.track_stereo(gl, gr, stamp=i / 30.0)
        rt = ts.track_stereo(gl, gr, stamp=i / 30.0)
        assert rt == rj and rt[0] == "OK", (i, rj, rt)
        assert_tracker_states_equal(js.tracker.state, ts.tracker.state, i)
        assert ts.tracker.ref_kf == js.tracker.ref_kf
        assert_arenas_close(js.map, ts.map, i)
    assert ts.map.n_kf >= 1 and ts.metrics.summary()["frames"] == N_STEREO


def mono_config():
    return SystemConfig(
        camera=CameraConfig(),
        orb=OrbConfig(max_keypoints=1024, n_levels=4, n_features=1000),
        map=MapConfig(max_keyframes=64, max_points=16384),
        tracking=TrackingConfig(max_frames_between_kf=10),
        sensor="monocular")


def init_sampler(seed, valid):
    return jax_draws(jax.random.PRNGKey(seed), valid.numpy())


def test_host_mono_initialisation():
    """Frame 0 becomes the reference, frame 1 initialises with H from
    the same correspondences in both packages: two keyframes (identity
    and the recovered pose), the same map size within one point, frame 2
    tracked in both."""
    cfg = mono_config()
    planes = jsyn.make_room(seed=0)
    poses = jsyn.camera_trajectory(60, radius=0.8)[:3]
    render = jax.jit(lambda p: jsyn.render(cfg.camera, p, planes)[0])
    js = JSystem(cfg)
    ts = tsys.System(tcfg.config_from_dict(dataclasses.asdict(cfg)),
                     device="cpu", init_sampler=init_sampler)
    for i, p in enumerate(poses):
        g = np.asarray(render(p))
        rj = js.track_monocular(g, stamp=i / 30.0)
        rt = ts.track_monocular(g, stamp=i / 30.0)
        assert rt == rj, (i, rj, rt)
        # The frame after the initialisation is tracked against (and makes
        # a keyframe of) the initial map: the H's float32 DLT gap (~1e-4
        # in the recovered pose) doubles there.
        tol = 1e-4 if i < 2 else 1e-3
        a, b = js.tracker.state, ts.tracker.state
        for f in dataclasses.fields(a):
            if f.name.startswith("pose_"):
                np.testing.assert_allclose(getattr(b, f.name),
                                           getattr(a, f.name), atol=tol)
            else:
                assert getattr(b, f.name) == getattr(a, f.name), f.name
        jm, tm = js.map, ts.map
        assert tm.n_kf == jm.n_kf and abs(tm.n_pt - jm.n_pt) <= 1, i
        np.testing.assert_allclose(tm.kf_R[:tm.n_kf], jm.kf_R[:jm.n_kf],
                                   atol=tol)
        np.testing.assert_allclose(tm.kf_t[:tm.n_kf], jm.kf_t[:jm.n_kf],
                                   atol=tol)
        if i == 1:
            # The initial map (median depth 1), after the mapper's local
            # BA: each point near one of the other's (measured: median
            # 2.5e-4, 99 % 1.4e-3, the worst 1.8e-2, a point seen at a
            # grazing angle).
            pj = jm.pt_pos[jm.pt_valid]
            pt = tm.pt_pos[tm.pt_valid]
            near = np.abs(pj[:, None] - pt[None]).max(-1).min(1)
            assert len(pj) > 500 and np.median(near) < 1e-3
            assert np.quantile(near, 0.99) < 5e-3 and near.max() < 5e-2
    assert [a["ok"] for a in ts.tracker.init_attempts] == [True]
    assert ts.tracker.init_attempts[0]["homography"]
    assert rt[0] == "OK" and ts.map.n_kf >= 2


def test_host_mono_drops_a_stale_reference(monkeypatch):
    """A next frame with under 100 matches to the reference (a texture,
    then a flat frame holding one small patch of another, > 100
    keypoints) drops the reference before the initializer runs, in both
    packages; the frame after becomes the new reference."""
    import cv2
    from test_dynamic_ops import texture
    calls = {"jax": 0, "port": 0}

    def counted(mod, name, pkg):
        orig = getattr(mod, name)

        def run(*a, **kw):
            calls[pkg] += 1
            return orig(*a, **kw)
        monkeypatch.setattr(mod, name, run)

    counted(jinit, "reconstruct", "jax")
    counted(tinit, "reconstruct_graph", "port")
    cfg = mono_config()
    js = JSystem(cfg)
    ts = tsys.System(tcfg.config_from_dict(dataclasses.asdict(cfg)),
                     device="cpu", init_sampler=init_sampler)
    sparse = np.full((480, 640), 128, np.float32)
    sparse[100:200, 200:300] = texture(h=100, w=100, seed=7)
    frames = [cv2.resize(texture(seed=2), (640, 480)), sparse,
              cv2.resize(texture(seed=9), (640, 480))]
    for i, g in enumerate(frames):
        rj = js.track_monocular(g, stamp=i / 30.0)
        rt = ts.track_monocular(g, stamp=i / 30.0)
        assert rt == rj and rt[0] == "NOT_INITIALIZED", (i, rj, rt)
        assert rt[1] > 100
        held = (js.tracker._mono_ref is not None,
                ts.tracker._mono_ref is not None)
        assert held == ((True, True) if i != 1 else (False, False)), i
    assert ts.tracker._mono_ref_stamp == js.tracker._mono_ref_stamp == 2 / 30
    assert calls == {"jax": 0, "port": 0}
    assert ts.tracker.init_attempts == [] and ts.map.n_kf == 0

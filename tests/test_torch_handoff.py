"""Parity of the port's handoff and offline refinement with the JAX
package: ``optimize_global_ba`` (chunked and not), ``to_arena`` (exact),
``GlobalBA.run``, ``refined_trajectory``, and the device map's row sync;
the slow tier holds the port's own session to the gates of
``tests/test_handoff.py``.

The session is the port's on the CPU; its ``finish()`` dict is fed as
numpy to both packages' ``to_arena`` (a JAX realtime session would cost
its compile time in the fast tier).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from coebslam_tpu import config as jcfg
from coebslam_tpu.optim import local_ba as jba
from coebslam_tpu.slam import handoff as jhand
from coebslam_tpu.slam.global_ba import GlobalBA as JGlobalBA
from coebslam_tpu.utils import synthetic as jsyn
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.eval import ate as tate
from coebslam_tpu_torch.optim import local_ba as tba
from coebslam_tpu_torch.slam import handoff as thand, map_device
from coebslam_tpu_torch.slam import realtime as trt
from coebslam_tpu_torch.slam.global_ba import GlobalBA as TGlobalBA
from test_global_ba import CAM, OPT, make_problem

torch.set_num_threads(1)


def _torch_problem(p):
    t = lambda x, dt=None: torch.tensor(np.asarray(x), dtype=dt)
    return tba.BAProblem(
        kf_R=t(p.kf_R), kf_t=t(p.kf_t), kf_fixed=t(p.kf_fixed),
        kf_valid=t(p.kf_valid), pt_pos=t(p.pt_pos), pt_valid=t(p.pt_valid),
        obs_kf=t(p.obs_kf, torch.int64), obs_uvr=t(p.obs_uvr),
        obs_w=t(p.obs_w, torch.float32), obs_valid=t(p.obs_valid))


def test_optimize_global_ba_matches_jax():
    prob, _, _ = make_problem(noise=0.03)
    tcam = tcfg.config_from_dict(
        {"camera": dataclasses.asdict(CAM)}).camera
    topt = tcfg.OptimizerConfig(**dataclasses.asdict(OPT))
    j = jba.optimize_global_ba(prob, CAM, OPT, n_blocks=4)
    t = tba.optimize_global_ba(_torch_problem(prob), tcam, topt, n_blocks=4)
    np.testing.assert_allclose(t.kf_R.numpy(), np.asarray(j.kf_R), atol=1e-4)
    np.testing.assert_allclose(t.kf_t.numpy(), np.asarray(j.kf_t), atol=1e-4)
    np.testing.assert_allclose(t.pt_pos.numpy(), np.asarray(j.pt_pos),
                               atol=1e-3)
    np.testing.assert_array_equal(t.obs_valid.numpy(),
                                  np.asarray(j.obs_valid))


@pytest.mark.parametrize("n_blocks", [2, 4])
def test_chunked_step_equals_unchunked(n_blocks):
    """Point blocks are exact: one chunked GN step equals one monolithic
    step to float32 rounding (the bound of tests/test_global_ba.py)."""
    prob = _torch_problem(make_problem()[0])
    tcam = tcfg.config_from_dict(
        {"camera": dataclasses.asdict(CAM)}).camera
    args = (tcam, True, OPT.chi2_mono, OPT.chi2_stereo, 1e-5)
    a = tba._gn_iteration(prob, *args)
    b = tba._gn_iteration_chunked(prob, *args, n_blocks=n_blocks)
    for x, y in ((a.kf_R, b.kf_R), (a.kf_t, b.kf_t), (a.pt_pos, b.pt_pos)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=1e-4)


CAMERA = dict(width=320, height=240, fx=267.7, fy=269.6, cx=160.05,
              cy=123.8)
JCFG = jcfg.SystemConfig(camera=jcfg.CameraConfig(**CAMERA),
                         orb=jcfg.OrbConfig(n_levels=4, max_keypoints=1024),
                         tracking=jcfg.TrackingConfig(max_frames_between_kf=3))
LIM = dict(max_kf=16, local_window=6, ba_window=6, max_frames=64)


def _session(jc, n_frames, lim):
    """A port session on the CPU over the first frames of the room orbit
    (the JAX package's renderer), its finish() dict and the ground-truth
    centres."""
    tc = tcfg.config_from_dict(dataclasses.asdict(jc))
    planes = jsyn.make_room(seed=0)
    poses = jsyn.camera_trajectory(36, radius=0.35)[:n_frames]
    rt = trt.RealtimeSlam(tc, trt.RTLimits(**lim), device="cpu")
    for i, p in enumerate(poses):
        g, d, _, _ = jsyn.render(jc.camera, p, planes, None, i)
        rt.track(np.clip(np.asarray(g), 0, 255).astype(np.uint8),
                 (np.asarray(d) * jc.camera.depth_map_factor)
                 .astype(np.uint16), stamp=i / 30.0)
    gt = np.asarray([-np.asarray(p.R).T @ np.asarray(p.t) for p in poses])
    return tc, rt.finish(), gt


@pytest.fixture(scope="module")
def session():
    return _session(JCFG, 12, LIM)


@pytest.fixture(scope="module")
def arenas(session):
    tc, res, _ = session
    return jhand.to_arena(res, JCFG), thand.to_arena(res, tc)


def test_to_arena_equal(session, arenas):
    (jm, jk), (tm, tk) = arenas
    assert tk == jk and len(tk) == session[1]["n_kf_live"] >= 3
    assert len(tm.valid_points()) > 300
    fields = [k for k, v in vars(tm).items() if isinstance(v, np.ndarray)]
    assert len(fields) >= 30
    for k in fields:
        np.testing.assert_array_equal(getattr(tm, k), getattr(jm, k),
                                      err_msg=k)
    assert (tm.n_kf, tm.n_pt) == (jm.n_kf, jm.n_pt)


def test_global_ba_run_matches_jax(session, arenas):
    tc, res, _ = session
    (jm, jk), (tm, tk) = arenas
    jm, tm = _copy(jm), _copy(tm)
    jg, tg = JGlobalBA(JCFG), TGlobalBA(tc, device="cpu")
    assert tg.run(tm) == jg.run(jm) == len(tk)
    assert tg.truncated_obs == jg.truncated_obs
    kf, pts = tm.valid_keyframes(), tm.valid_points()
    np.testing.assert_allclose(tm.kf_R[kf], jm.kf_R[kf], atol=1e-4)
    np.testing.assert_allclose(tm.kf_t[kf], jm.kf_t[kf], atol=1e-4)
    np.testing.assert_allclose(tm.pt_pos[pts], jm.pt_pos[pts], atol=1e-3)
    np.testing.assert_allclose(thand.refined_trajectory(res, tm, tk),
                               jhand.refined_trajectory(res, jm, jk),
                               atol=1e-4)


def _copy(m):
    """A copy of an arena's arrays (runs write in place)."""
    import copy
    c = copy.copy(m)
    for k, v in vars(m).items():
        if isinstance(v, np.ndarray):
            setattr(c, k, v.copy())
    c.__dict__.pop("_devmap", None)
    return c


def test_device_map_row_sync_equals_full_upload(arenas):
    """After row edits, the incremental sync leaves the mirrors equal to a
    fresh full upload."""
    tm = _copy(arenas[1][0])
    dm = map_device.sync(tm, tm.cfg, "cpu")
    pts = tm.valid_points()[:7]
    tm.pt_pos[pts] += 0.5
    tm.pt_desc[pts] ^= 0xFF
    tm.mark_points_dirty(pts)
    tm.kf_ur[1, :5] = 3.0
    tm._dirty_kf[1] = True
    tm.set_keyframe_pose(2, np.eye(3, dtype=np.float32), np.ones(3))
    assert map_device.sync(tm, tm.cfg) is dm
    fresh = map_device.DeviceMap(tm.cfg, "cpu").sync(tm)
    for a, b in zip(dm.points + dm.kf_feats + dm.kf_poses,
                    fresh.points + fresh.kf_feats + fresh.kf_poses):
        assert torch.equal(a, b)
    assert not tm._dirty_pt.any() and not tm._dirty_kf.any()


def test_refine_entry_point(session):
    tc, res, gt = session
    m, kf_ids, n = thand.refine(res, tc, device="cpu")
    assert n == len(kf_ids)
    traj = thand.refined_trajectory(res, m, kf_ids)
    assert traj.shape == (len(res["R"]), 3, 4) and np.isfinite(traj).all()


@pytest.mark.slow
class TestHandoffGates:
    """tests/test_handoff.py's gates on the port's own session (full-size
    frames, 36 of them)."""

    @pytest.fixture(scope="class")
    def full(self):
        return _session(jcfg.SystemConfig(), 36,
                        dict(max_kf=16, local_window=6, ba_window=6,
                             max_frames=64))

    def test_arena_reconstruction(self, full):
        tc, res, _ = full
        m, kf_ids = thand.to_arena(res, tc)
        assert len(kf_ids) == res["n_kf_live"]
        assert len(m.valid_points()) > 300
        obs_counts = [(m.kf_obs_pt[k] >= 0).sum() for k in kf_ids]
        assert np.median(obs_counts) > 100, obs_counts
        assert len(m.best_covisible(kf_ids[-1], 5)) >= 1

    def test_depth_and_level_recovery(self, full):
        tc, res, _ = full
        m, kf_ids = thand.to_arena(res, tc)
        k = kf_ids[0]
        d = m.kf_depth[k][m.kf_kp_valid[k]]
        assert (d[d > 0] > 0.3).all() and (d[d > 0] < 20.0).all()
        lv = m.kf_level[k][m.kf_kp_valid[k]]
        assert lv.min() >= 0 and lv.max() < tc.orb.n_levels
        assert (lv > 0).any()

    def test_global_ba_refines(self, full):
        tc, res, gt = full
        m, kf_ids, n_opt = thand.refine(res, tc, device="cpu")
        assert n_opt == len(kf_ids)
        centers = -np.einsum("kji,kj->ki", m.kf_R[kf_ids], m.kf_t[kf_ids])
        frames = res["kf_frame"]
        stamps = frames / 30.0
        r = tate.ate_rmse(stamps, centers, stamps, gt[frames])
        assert np.isfinite(r["rmse"]) and r["rmse"] < 0.02, r["rmse"]

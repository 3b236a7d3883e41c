"""The JAX package's gates of the host-orchestrated path, run on the port
with ``device="cpu"`` (slow tier, as the JAX twins are):
``tests/test_tracking_e2e.py``'s ``TestTrackingE2E`` and
``TestTrajectoryExport``, ``tests/test_dynamic_e2e.py``'s three gates, and
``tests/test_tum_replica.py::TestReplicaHostPipeline::test_host_path_ate``
(120 frames of the replica, at most 5 lost, ATE < 8 cm). Frames come from
the port's own renderer."""
import dataclasses

import numpy as np
import pytest
import torch

from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.eval import ate
from coebslam_tpu_torch.slam.local_mapping import LocalMapper
from coebslam_tpu_torch.slam.system import System
from coebslam_tpu_torch.slam.tracking import OK, Tracker
from coebslam_tpu_torch.utils import replica, synthetic
from test_dynamic_e2e import dyn_config
from test_tracking_e2e import small_config

pytestmark = pytest.mark.slow

torch.set_num_threads(4)


def port_config(jax_cfg):
    return tcfg.config_from_dict(dataclasses.asdict(jax_cfg))


def centers_from_traj(traj):
    return np.asarray([-R.T @ t for _, R, t in traj])


def gt_centres(poses):
    return np.asarray([-p.R.numpy().T @ p.t.numpy() for p in poses])


@pytest.fixture(scope="module")
def tracked():
    cfg = port_config(small_config())
    planes = synthetic.make_room(seed=0, device="cpu")
    poses = synthetic.camera_trajectory(30, radius=0.35)
    tracker = Tracker(cfg, device="cpu")
    mapper = LocalMapper(cfg, tracker.map, device="cpu")
    tracker.on_keyframe = mapper.process_keyframe
    states = []
    for i, pose in enumerate(poses):
        gray, depth = synthetic.render(cfg.camera, pose, planes)[:2]
        states.append(tracker.process_frame(gray, depth, stamp=i / 30.0))
    return cfg, tracker, poses, states


class TestHostTrackingE2E:
    def test_initializes_and_stays_ok(self, tracked):
        _, tracker, _, states = tracked
        assert states[0][0] == OK
        assert sum(1 for s, _ in states[1:] if s == OK) >= len(states) - 1

    def test_ate_below_threshold(self, tracked):
        _, tracker, poses, _ = tracked
        est = centers_from_traj(tracker.trajectory)
        gt = gt_centres(poses)
        stamps = np.arange(len(gt)) / 30.0
        res = ate.ate_rmse(stamps[:len(est)], est, stamps, gt)
        assert res["rmse"] < 0.02, res

    def test_map_grows(self, tracked):
        _, tracker, _, _ = tracked
        assert tracker.map.n_kf >= 2
        assert len(tracker.map.valid_points()) > 300

    def test_covisibility_connected(self, tracked):
        _, tracker, _, _ = tracked
        m = tracker.map
        valid = m.valid_keyframes()
        assert len(valid) >= 2
        for k in valid:
            if k == 0:
                continue
            assert m.covis[k, :m.n_kf].max() > 0, k
        assert (m.kf_parent[valid[valid > 0]] >= 0).all()


class TestHostTrajectoryExport:
    def test_export_close_to_live_and_accurate(self, tracked):
        _, tracker, poses, _ = tracked
        live = tracker.trajectory
        exported = tracker.export_trajectory()
        assert len(exported) == len(live)
        for (s1, R1, t1), (s2, R2, t2) in zip(live, exported):
            assert s1 == s2
            np.testing.assert_allclose(R1, R2, atol=2e-2)
            np.testing.assert_allclose(t1, t2, atol=2e-2)
        gt = gt_centres(poses)
        stamps = np.arange(len(gt)) / 30.0
        est = centers_from_traj(exported)
        assert ate.ate_rmse(stamps[:len(est)], est, stamps,
                            gt)["rmse"] < 0.02

    def test_export_reflects_post_hoc_correction(self, tracked):
        _, tracker, _, _ = tracked
        m = tracker.map
        saved_R, saved_t = m.kf_R.copy(), m.kf_t.copy()
        before = tracker.export_trajectory()
        c, s = np.cos(0.17), np.sin(0.17)
        Rd = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        td = np.array([0.3, -0.1, 0.2], np.float32)
        try:
            for k in m.valid_keyframes():
                m.kf_t[k] = m.kf_R[k] @ td + m.kf_t[k]
                m.kf_R[k] = m.kf_R[k] @ Rd
            after = tracker.export_trajectory()
            moved = 0
            for (_, R0, t0), (_, R1, t1), rec in zip(
                    before, after, tracker.traj_relative):
                if rec[1] < 0:
                    continue
                np.testing.assert_allclose(R1, R0 @ Rd, atol=1e-4)
                np.testing.assert_allclose(t1, R0 @ td + t0, atol=1e-4)
                moved += 1
            assert moved > len(after) * 0.9, moved
        finally:
            m.kf_R[:], m.kf_t[:] = saved_R, saved_t

    def test_freeze_trajectory_bakes_absolute(self, tracked):
        _, tracker, _, _ = tracked
        m = tracker.map
        saved_R, saved_t = m.kf_R.copy(), m.kf_t.copy()
        saved_rel = list(tracker.traj_relative)
        baseline = tracker.export_trajectory()
        tracker.freeze_trajectory()
        try:
            m.kf_t[m.valid_keyframes()] += 5.0
            frozen = tracker.export_trajectory()
            for (_, _, t0), (_, _, t1) in zip(baseline, frozen):
                np.testing.assert_allclose(t1, t0, atol=1e-5)
        finally:
            m.kf_R[:], m.kf_t[:] = saved_R, saved_t
            tracker.traj_relative = saved_rel


def run_dynamic(use_filtering: bool, n_frames=25):
    """tests/test_dynamic_e2e.py's run_sequence on the port."""
    cfg = port_config(dyn_config(use_filtering))
    planes = synthetic.make_room(seed=0, device="cpu")
    quad = synthetic.make_walker(start=(-0.6, -0.15, 1.6),
                                 velocity=(0.04, 0.025, 0.0),
                                 half_w=0.3, half_h=0.65, device="cpu")
    poses = synthetic.camera_trajectory(n_frames * 2,
                                        radius=0.35)[:n_frames]
    sysm = System(cfg, device="cpu")
    states = []
    for i, pose in enumerate(poses):
        gray, depth, box, _ = synthetic.render(cfg.camera, pose, planes,
                                               quad, i)
        state, _ = sysm.track_rgbd(gray, depth, stamp=i / 30.0,
                                   boxes=box.numpy()[None, :])
        states.append(state)
    R0, t0 = poses[0].R.numpy(), poses[0].t.numpy()
    gt = []
    for p in poses:
        R = p.R.numpy() @ R0.T
        t = p.t.numpy() - R @ t0
        gt.append(-R.T @ t)
    est = centers_from_traj(sysm.tracker.trajectory)
    stamps = np.arange(n_frames) / 30.0
    res = ate.ate_rmse(stamps[:len(est)], est, stamps, np.asarray(gt))
    return res["rmse"], states, sysm


@pytest.fixture(scope="module")
def filtered():
    return run_dynamic(True)


class TestHostDynamicE2E:
    def test_filtered_tracks_accurately(self, filtered):
        rmse, states, _ = filtered
        assert rmse < 0.02, rmse
        assert states.count("LOST") <= 2

    def test_mask_excludes_walker_keypoints(self, filtered):
        _, _, sysm = filtered
        dres = sysm.last_dynamic
        assert bool(dres.box_dynamic[0]) or int(dres.n_outliers) >= 0
        lf = sysm.tracker.last_frame
        m = np.asarray(dres.mask)
        if m.any():
            uv = lf.uv[lf.valid]
            inside = m[np.clip(uv[:, 1].astype(int), 0, 479),
                       np.clip(uv[:, 0].astype(int), 0, 639)]
            assert inside.mean() < 0.05

    def test_filtering_beats_unfiltered(self, filtered):
        rmse_f, _, _ = filtered
        rmse_u, _, _ = run_dynamic(False)
        assert rmse_f <= rmse_u * 1.05, (rmse_f, rmse_u)


class TestHostReplicaPipeline:
    """The host System on the first 120 frames of the 400-frame replica
    (the wire's quantisation, depth in float metres, the walker's boxes
    through the text format)."""

    def test_host_path_ate(self):
        from chip_smoke import host_summary, replica_host_frames, run_host
        frames, gt = replica_host_frames(replica, 120, "cpu")
        sysm = System(tcfg.SystemConfig(), device="cpu")
        states = run_host(sysm, frames)
        hs = host_summary(sysm, states, [f[0] for f in frames], gt, ate)
        assert hs["lost"] <= 5, hs
        assert hs["ate_m"] < 0.08, f"host replica ATE {hs['ate_m']*100:.2f} cm"

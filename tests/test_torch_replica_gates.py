"""The JAX package's replica gates of the realtime path, run on the port
with ``device="cpu"`` (slow tier, as the JAX twins are), on the port's
in-memory replica frames in the wire's dtypes (grey uint8, depth uint16)
with the walker boxes through the text format:

- ``tests/test_tum_replica.py::TestReplicaRealtime``: the first 240 frames
  of the 400-frame replica, >= 235 tracked, ATE < 8 cm; after handoff and
  global BA the refined ATE < 1.5 cm and below the raw one;
- ``TestReplicaTwoWalkers``: 200 frames of the two-walker replica (seed
  1), >= 195 tracked, ATE < 7 cm;
- ``tests/test_replica_closure.py``: the 240-frame out-and-back replica
  with depth x 1.05, maintenance every 4 frames with the committed
  vocabulary: >= 235 tracked, at least one loop closed, ATE < 6 cm and
  below open-loop odometry.
"""
import os

import numpy as np
import pytest
import torch

from coebslam_tpu_torch.config import SystemConfig
from coebslam_tpu_torch.eval import ate
from coebslam_tpu_torch.slam import handoff, vocabulary
from coebslam_tpu_torch.slam.realtime import RealtimeSlam
from coebslam_tpu_torch.utils import replica

pytestmark = pytest.mark.slow

torch.set_num_threads(4)

VOCAB = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts", "vocab_1e5.npz")


def frames_of(**kw):
    frames = list(replica.generate(**kw, device="cpu"))
    gt = np.asarray([[float(x) for x in f.gt_line.split()[1:4]]
                     for f in frames])
    return frames, np.asarray([f.stamp for f in frames]), gt


def track(rt, frames, depth_bias=None):
    for f in frames:
        d = f.depth
        if depth_bias is not None:
            d = (d.astype(np.float32) * depth_bias).astype(d.dtype)
        rt.track(f.gray, d, stamp=f.stamp,
                 boxes=f.boxes if len(f.boxes) else None)
    return rt.finish()


def _ate(res, stamps, gt, R=None, t=None):
    R = res["R"] if R is None else R
    t = res["t"] if t is None else t
    est = np.asarray([-r.T @ x for r, x in zip(R, t)])
    return float(ate.ate_rmse(res["stamps"], est, stamps, gt)["rmse"])


class TestReplicaRealtimePort:
    @pytest.fixture(scope="class")
    def run(self):
        frames, stamps, gt = frames_of(n_frames=400, seed=0,
                                       frames=range(240))
        res = track(RealtimeSlam(SystemConfig(), device="cpu"), frames)
        return res, stamps, gt

    def test_tracks_through_blur_and_walker(self, run):
        res, _, _ = run
        assert res["ok"].sum() >= 235, int(res["ok"].sum())

    def test_ate_regression_gate(self, run):
        res, stamps, gt = run
        rmse = _ate(res, stamps, gt)
        assert rmse < 0.08, f"replica ATE {rmse*100:.2f} cm"

    def test_refined_ate_host_class(self, run):
        res, stamps, gt = run
        m, kf_ids, n_opt = handoff.refine(res, SystemConfig(), device="cpu")
        assert n_opt >= 10
        traj2 = handoff.refined_trajectory(res, m, kf_ids)
        refined = _ate(res, stamps, gt, [P[:, :3] for P in traj2],
                       [P[:, 3] for P in traj2])
        raw = _ate(res, stamps, gt)
        assert refined < 0.015, f"refined {refined*100:.2f} (raw {raw*100:.2f})"
        assert refined < raw


def test_two_walkers_port():
    cfg = SystemConfig()
    frames, stamps, gt = frames_of(n_frames=200, seed=1, walkers=2)
    res = track(RealtimeSlam(cfg, device="cpu"), frames)
    assert res["ok"].sum() >= len(frames) - 5, int(res["ok"].sum())
    rmse = _ate(res, stamps, gt)
    assert rmse < 0.07, f"2-walker ATE {rmse*100:.2f} cm"


def test_closure_fires_and_does_not_hurt_port():
    frames, stamps, gt = frames_of(n_frames=240, seed=0, closure=True)
    voc = vocabulary.load(VOCAB)
    res_loop = track(RealtimeSlam(SystemConfig(), device="cpu",
                                  vocabulary=voc, maintain_every=4),
                     frames, depth_bias=1.05)
    res_odo = track(RealtimeSlam(SystemConfig(), device="cpu"), frames,
                    depth_bias=1.05)
    assert res_loop["ok"].sum() >= 235
    assert res_loop["n_loops_closed"] >= 1, res_loop["loop_events"]
    a_loop, a_odo = _ate(res_loop, stamps, gt), _ate(res_odo, stamps, gt)
    assert a_loop < a_odo, (a_loop, a_odo)
    assert a_loop < 0.06, f"closure-replica ATE {a_loop*100:.2f} cm"

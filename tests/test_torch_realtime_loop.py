"""The JAX package's end-to-end gates of the maintenance program, run on the
port on the CPU (slow tier, like their twins in tests/test_realtime_loop.py
and tests/test_place_bank.py): the drifted circuit must close its loop and
reduce drift, a kidnapped camera must relocalize, and with an 8-row ring
the closure and the relocalization must come from the place bank.

The scene vocabulary is trained by the JAX package exactly as those tests
train it and carried over as ``Vocabulary(*voc)``; the frames are rendered
by the port. The scene builders (the configuration, the ring limits, the
frames and the bank relocalization's drive) are rt_loop_scenes.py's,
shared with chip_smoke.py [6], [7] and [19]. The assertions are the JAX
tests' own.
"""
import numpy as np
import jax
import pytest
import torch

from coebslam_tpu.ops import extractor as jext
from coebslam_tpu.slam import vocabulary as jvoc
from coebslam_tpu.utils import synthetic as jsyn
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.eval import ate
from coebslam_tpu_torch.slam import vocabulary as tvoc
from coebslam_tpu_torch.slam.realtime import RealtimeSlam, RTLimits
from coebslam_tpu_torch.utils import synthetic as tsyn
from rt_loop_scenes import (BANK_LIMITS, CIRCUIT_LIMITS, centres, circuit_config, loop_scene,
                            run_bank_reloc, run_realtime)

from test_loop_e2e import circuit_poses as j_circuit_poses, \
    six_wall_room as j_six_wall_room
from test_realtime_loop import rt_config as j_rt_config

pytestmark = pytest.mark.slow

N_CIRCUIT, N_OVERLAP, DEPTH_BIAS = tsyn.N_CIRCUIT, tsyn.N_OVERLAP, \
    tsyn.DEPTH_BIAS
LIM = RTLimits(**CIRCUIT_LIMITS)
#: Ring of 8 rows vs ~27 keyframes/circuit: wraps >= 3x per lap.
BANK_LIM = RTLimits(**BANK_LIMITS)


def rt_config():
    return circuit_config(tcfg)


def scene_vocabulary(frames):
    """The JAX tests' scene vocabulary: descriptors of the given circuit
    frames, trained with branching 8, depth 3."""
    cfg = j_rt_config()
    planes = j_six_wall_room()
    poses = j_circuit_poses(N_CIRCUIT)
    render = jax.jit(lambda p: jsyn.render(cfg.camera, p, planes)[:2])
    ex = jax.jit(lambda g: jext.extract(g, cfg.orb))
    descs = []
    for i in frames:
        f = ex(render(poses[i])[0])
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    voc = jvoc.train(np.concatenate(descs)[:6000], branching=8, depth=3,
                     seed=0)
    return tvoc.Vocabulary(*voc)


def render_frames(sched, bias=1.0):
    return loop_scene("cpu", sched, bias, tsyn, rt_config().camera)


def _run(frames, lim, voc, every):
    rt = RealtimeSlam(rt_config(), lim, device="cpu", vocabulary=voc,
                      maintain_every=every)
    return run_realtime(rt, frames)


_centers = centres


@pytest.fixture(scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def circuit(torch_threads):
    frames, gt = render_frames(range(N_CIRCUIT + N_OVERLAP), DEPTH_BIAS)
    voc = scene_vocabulary(range(0, N_CIRCUIT, 12))
    return frames, gt, voc


@pytest.fixture(scope="module")
def rt_loop_run(circuit):
    frames, gt, voc = circuit
    return _run(frames, LIM, voc, 1), gt


class TestRealtimeLoop:
    def test_loop_fires_in_graph(self, rt_loop_run):
        res, _ = rt_loop_run
        assert res["n_loops_closed"] >= 1, res["loop_events"]
        ev = [e for e in res["loop_events"] if e["applied"]]
        assert ev and ev[0]["cand_lid"] <= 8, ev
        assert ev[0]["n_inliers"] >= 20, ev

    def test_false_candidates_rejected(self, rt_loop_run):
        res, _ = rt_loop_run
        for e in res["loop_events"]:
            if e["applied"]:
                assert e["cand_lid"] <= 8, e
            else:
                assert e["n_inliers"] < 20, e

    def test_loop_reduces_drift(self, rt_loop_run):
        res, gt = rt_loop_run
        est = _centers(res)
        n = len(est)
        tail = slice(n - 8, n)
        r_tail = ate.ate_rmse(res["stamps"][tail], est[tail],
                              res["stamps"][tail], gt[-len(est):][tail])
        mid = slice(n // 2 - 4, n // 2 + 4)
        r_mid = ate.ate_rmse(res["stamps"][mid], est[mid],
                             res["stamps"][mid], gt[-len(est):][mid])
        r_all = ate.ate_rmse(res["stamps"], est, res["stamps"], gt[-n:])
        assert res["n_loops_closed"] >= 1
        assert r_tail["rmse"] < 0.03, r_tail["rmse"]
        assert r_all["rmse"] < 0.12, (r_all["rmse"], r_mid["rmse"],
                                      r_tail["rmse"])

    def test_no_silent_saturation(self, rt_loop_run):
        res, _ = rt_loop_run
        assert res["n_kf"] >= res["n_kf_live"]
        assert res["kf_evicted"] == max(0, res["n_kf"] - 64)
        assert res["frames_dropped"] == 0


class TestRealtimeReloc:
    @pytest.fixture(scope="class")
    def kidnap_run(self, torch_threads):
        sched = list(range(0, 50)) + list(range(6, 16))
        frames, gt = render_frames(sched)
        voc = scene_vocabulary(range(0, 50, 10))
        return _run(frames, LIM, voc, 2), gt

    def test_relocalizes(self, kidnap_run):
        res, _ = kidnap_run
        assert res["n_relocalizations"] >= 1
        assert res["ok"][-4:].all(), res["ok"][-12:]

    def test_pose_reacquired(self, kidnap_run):
        res, gt = kidnap_run
        est = _centers(res)
        tail = slice(len(est) - 5, len(est))
        r = ate.ate_rmse(res["stamps"][tail], est[tail],
                         res["stamps"][tail], gt[tail])
        assert r["rmse"] < 0.05, r["rmse"]


def test_bank_loop_closure_after_ring_wrap(circuit):
    """A full drifted circuit with an 8-row ring: the closure candidate
    must come from the bank, and applying it must beat the odometry."""
    frames, gt, voc = circuit
    res = _run(frames, BANK_LIM, voc, 1)
    res_odo = _run(frames, BANK_LIM, None, 1)

    n = len(frames)
    assert res["n_kf"] >= 3 * BANK_LIM.max_kf, \
        f"ring only wrapped {res['n_kf']}/{BANK_LIM.max_kf} rows"
    assert res["bank_entries"] > BANK_LIM.max_kf, "bank not accumulating"
    applied = [e for e in res["loop_events"] if e["applied"]]
    assert res["n_bank_loops"] >= 1, \
        f"no bank closure applied; events={res['loop_events']}"
    assert any(e["lid"] - e["cand_lid"] > BANK_LIM.max_kf for e in applied)

    c_loop, c_odo = _centers(res), _centers(res_odo)
    gap_loop = np.linalg.norm(c_loop[N_CIRCUIT:] - c_loop[:N_OVERLAP],
                              axis=1).mean()
    gap_odo = np.linalg.norm(c_odo[N_CIRCUIT:] - c_odo[:N_OVERLAP],
                             axis=1).mean()
    assert gap_loop < 0.6 * gap_odo, (
        f"closure did not close the loop: revisit gap {gap_loop:.3f} m "
        f"vs odometry {gap_odo:.3f} m")
    stamps = np.arange(n) / 30.0
    r_loop = ate.ate_rmse(res["stamps"], _centers(res), stamps, gt)
    r_odo = ate.ate_rmse(res_odo["stamps"], _centers(res_odo), stamps, gt)
    assert r_loop["rmse"] <= r_odo["rmse"] * 1.1 + 0.005, (
        f"closure hurt: {r_loop['rmse']:.3f} vs {r_odo['rmse']:.3f}")


def test_bank_relocalization_to_evicted_place(circuit):
    """Track half the circuit, go dark until lost, then re-show an early
    view: only a bank hit can relocalize."""
    frames, _, voc = circuit
    n_half = N_CIRCUIT // 2
    rt = RealtimeSlam(rt_config(), BANK_LIM, device="cpu", vocabulary=voc,
                      maintain_every=1)
    black = torch.zeros_like(frames[0][0])
    blackd = torch.zeros_like(frames[0][1])
    revisit = list(range(6, 16))
    res = run_bank_reloc(rt, frames, (black, blackd), n_half)

    assert res["n_bank_reloc"] >= 1, "no bank relocalization applied"
    c = _centers(res)
    ok = res["ok"]
    assert ok[-len(revisit):].sum() >= len(revisit) - 2
    err = np.linalg.norm(c[-len(revisit):] - c[revisit], axis=1)
    assert np.median(err) < 0.30, f"reloc pose off: {err}"

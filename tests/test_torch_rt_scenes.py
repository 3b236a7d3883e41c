"""The realtime loop-circuit scenes the port's scripts share
(rt_loop_scenes.py: chip_smoke.py [6], [7] and [19], cpu_reference.py,
tests/test_torch_realtime_loop.py) against the JAX package's tests that
define them: tests/test_realtime_loop.py's configuration and
tests/test_place_bank.py's 8-row ring, their scene vocabulary's frames,
and the circuit's first and last frames (float grey within 1e-2 of the
JAX renderer's; measured 1.7e-3)."""
import dataclasses

import numpy as np
import jax

from coebslam_tpu.slam.realtime import RTLimits as JLimits
from coebslam_tpu.utils import synthetic as jsyn
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.slam.realtime import RTLimits as TLimits
from coebslam_tpu_torch.utils import synthetic as tsyn
from rt_loop_scenes import (BANK_LIMITS, BANK_VOCAB, CIRCUIT_LIMITS,
                            bank_vocab_frames, circuit_config, loop_scene)
from test_loop_e2e import (DEPTH_BIAS, N_CIRCUIT, N_OVERLAP, circuit_poses,
                           six_wall_room)
from test_place_bank import BANK_LIM
from test_realtime_loop import rt_config


def test_configuration_and_limits_are_the_tests():
    assert circuit_config(tcfg) == tcfg.config_from_dict(
        dataclasses.asdict(rt_config()))
    assert TLimits(**BANK_LIMITS)._asdict() == BANK_LIM._asdict()
    assert TLimits(**CIRCUIT_LIMITS)._asdict() == JLimits(
        max_kf=64, spawn_per_kf=256, ba_window=6, local_window=6,
        max_frames=256)._asdict()
    assert (tsyn.N_CIRCUIT, tsyn.N_OVERLAP, tsyn.DEPTH_BIAS) \
        == (N_CIRCUIT, N_OVERLAP, DEPTH_BIAS)
    assert list(bank_vocab_frames(N_CIRCUIT)) == list(range(0, N_CIRCUIT,
                                                            12))
    assert BANK_VOCAB == dict(n_desc=6000, branching=8, depth=3, seed=0)


def test_circuit_frames_match_the_jax_renderer():
    cfg = rt_config()
    sched = [0, N_CIRCUIT + N_OVERLAP - 1]
    frames, gt = loop_scene("cpu", sched, DEPTH_BIAS, tsyn,
                            circuit_config(tcfg).camera)
    planes, poses = six_wall_room(), circuit_poses(max(sched) + 1)
    render = jax.jit(lambda p: jsyn.render(cfg.camera, p, planes)[:2])
    for (g, d), i, c in zip(frames, sched, gt):
        jg, jd = (np.asarray(x) for x in render(poses[i]))
        np.testing.assert_allclose(g.numpy(), jg, atol=1e-2, err_msg=str(i))
        np.testing.assert_allclose(d.numpy(), jd * DEPTH_BIAS, atol=1e-4)
        np.testing.assert_allclose(
            c, -np.asarray(poses[i].R).T @ np.asarray(poses[i].t),
            atol=1e-6)

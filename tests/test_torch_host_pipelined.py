"""Parity of the port's host ``System`` in realtime mode
(``enable_realtime(finalize_batch=4)``: the tracker finalizes four frames
from one transfer, one frame behind, and the mapper advances one stage per
frame) with the JAX package on the CPU, on the static room of
``tests/test_tracking_e2e.py``: every frame's returned state and inlier
count equal, the trajectory within 1e-4 in the same mode, and the map by
the rule of ``tests/test_torch_host_tracking.py``."""
import dataclasses

import numpy as np
import torch

from coebslam_tpu.slam.system import System as JSystem
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.slam import system as tsys
from test_torch_host_tracking import assert_arenas_close, room_frames
from test_tracking_e2e import small_config

torch.set_num_threads(2)

N_FRAMES = 16


def test_realtime_mode_matches_the_reference():
    cfg = small_config()
    tc = tcfg.config_from_dict(dataclasses.asdict(cfg))
    frames, _ = room_frames(N_FRAMES, cfg)
    js = JSystem(cfg)
    ts = tsys.System(tc, device="cpu")
    js.enable_realtime(finalize_batch=4)
    ts.enable_realtime(finalize_batch=4)
    assert ts.tracker.pipelined and ts.mapper.async_mode
    for i, (g, d, _) in enumerate(frames):
        rj = js.track_rgbd(g, d, stamp=i / 30.0)
        rt = ts.track_rgbd(g, d, stamp=i / 30.0)
        assert rt == rj, (i, rj, rt)
        assert len(ts.tracker.trajectory) == len(js.tracker.trajectory)
        assert ts.mapper.idle() == js.mapper.idle(), i
    js.shutdown()
    ts.shutdown()
    assert len(js.tracker.trajectory) == N_FRAMES
    assert js.map.n_kf >= 3
    for (s1, R1, t1), (s2, R2, t2) in zip(js.tracker.trajectory,
                                          ts.tracker.trajectory):
        assert s1 == s2
        np.testing.assert_allclose(R2, R1, atol=1e-4)
        np.testing.assert_allclose(t2, t1, atol=1e-4)
    assert [r[-1] for r in ts.tracker.traj_relative] \
        == [r[-1] for r in js.tracker.traj_relative]
    assert ts.get_tracking_state() == js.get_tracking_state() == "OK"
    assert_arenas_close(js.map, ts.map, "end")

"""The JAX package's end-to-end BoW gates on the port (CPU, its own
generators' draws, its own renderer, extractor and trained vocabulary):

* tests/test_loop_e2e.py: the six-wall room's 1 m circuit with depth
  x 1.06 drift through ``System(vocabulary=)``: a loop closes near the
  end of the circuit, the exported trajectory beats the drifted one, and
  search-and-fuse links the two sides of the loop;
* tests/test_vocabulary.py::TestRelocalizationE2E: track, lose tracking
  on black frames, recover on a frame seen before.

Several minutes each on the CPU (``slow``, as their twins are).
"""

import numpy as np
import pytest
import torch

from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.eval import ate
from coebslam_tpu_torch.ops import extractor
from coebslam_tpu_torch.slam import vocabulary as voc_mod
from coebslam_tpu_torch.slam.system import System
from coebslam_tpu_torch.utils import synthetic
from host_bow_scenes import (HOST_LOOP_VOCAB, HOST_LOOP_VOCAB_FRAMES,
                             HOST_RELOC_ORBIT, HOST_RELOC_RETURN,
                             HOST_RELOC_VOCAB, HOST_RELOC_VOCAB_FRAMES,
                             host_loop_config, host_loop_summary,
                             host_reloc_config, reloc_truth, run_host_loop,
                             run_host_reloc, scene_vocabulary)

pytestmark = pytest.mark.slow
torch.set_num_threads(4)


def _vocabulary(cfg, frames, which, kw):
    descs = []
    for i in which:
        f = extractor.extract(frames[i][0], cfg.orb)
        descs.append(f.desc[f.valid].numpy())
    return scene_vocabulary(voc_mod, descs, **kw)


@pytest.fixture(scope="module")
def loop_run():
    cfg = host_loop_config(tcfg)
    planes = synthetic.six_wall_room(device="cpu")
    poses = synthetic.circuit_poses(synthetic.N_CIRCUIT
                                    + synthetic.N_OVERLAP)
    frames = [synthetic.render(cfg.camera, p, planes)[:2] for p in poses]
    frames = [(g, d * synthetic.DEPTH_BIAS) for g, d in frames]
    voc = _vocabulary(cfg, frames, HOST_LOOP_VOCAB_FRAMES, HOST_LOOP_VOCAB)
    sysm = System(cfg, device="cpu", vocabulary=voc)
    states, pre, closed_at = run_host_loop(sysm, frames)
    gt = np.asarray([-p.R.numpy().T @ p.t.numpy() for p in poses])
    return host_loop_summary(sysm, states, pre, closed_at, gt, ate)


class TestLoopE2EPort:
    def test_loop_fires(self, loop_run):
        assert loop_run["loops"] >= 1
        assert loop_run["closed_at"] is not None \
            and loop_run["closed_at"] >= synthetic.N_CIRCUIT - 20

    def test_drift_reduced(self, loop_run):
        assert loop_run["ate_pre_m"] > 0.02, loop_run
        assert loop_run["ate_post_m"] < loop_run["ate_pre_m"] * 0.8, loop_run

    def test_fused_connections_exist(self, loop_run):
        assert loop_run["fused_edges"] >= 1


class TestRelocalizationE2EPort:
    def test_relocalize_after_blackout(self):
        cfg = host_reloc_config(tcfg)
        planes = synthetic.make_room(seed=0, device="cpu")
        poses = synthetic.camera_trajectory(**HOST_RELOC_ORBIT)
        frames = [synthetic.render(cfg.camera, p, planes)[:2] for p in poses]
        voc = _vocabulary(cfg, frames, HOST_RELOC_VOCAB_FRAMES,
                          HOST_RELOC_VOCAB)
        sysm = System(cfg, device="cpu", vocabulary=voc)
        black = (torch.zeros_like(frames[0][0]),
                 torch.ones_like(frames[0][1]))
        np_pose = lambda p: (p.R.numpy(), p.t.numpy())
        Rg, tg = reloc_truth(*np_pose(poses[0]),
                             *np_pose(poses[HOST_RELOC_RETURN]))
        s = run_host_reloc(sysm, frames, black, Rg, tg)
        assert s["before"] == "OK"
        assert s["n_kf_before"] >= cfg.tracking.reset_if_lost_with_kfs_below
        assert s["after_black"] == "LOST"
        assert s["return"] == "OK", s
        assert s["centre_err_m"] < 0.1, s

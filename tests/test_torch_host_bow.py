"""Parity of the port's ``System(vocabulary=)`` with the JAX package on the
CPU, frame by frame through ``track_rgbd``: the blackout scene of
tests/test_vocabulary.py::TestRelocalizationE2E (its room, orbit and ORB
cut, 12 frames, 3 black frames with flat depth, then frame 8 again) and a
reset after an early loss with the vocabulary wired in. Both Systems
share one vocabulary; the port draws the reference's RANSAC indices
(``reloc_sampler``, ``loop_sampler``). Held at every frame: the returned
state and inliers, the tracker state (poses within 1e-4), the arena by
``tests/test_torch_host_tracking.py``'s rule, and the keyframe
databases' rows.

The reset mirrors the reference: only the tracker and the mapper get the
new arena, while the keyframe database (with its registered keyframes),
the relocalizer and the loop closer keep the old one.
"""
import numpy as np
import pytest
import torch

from coebslam_tpu.slam.system import System as JSystem
from coebslam_tpu_torch.slam.system import System as TSystem
from host_bow_scenes import (HOST_RELOC_BLACK, HOST_RELOC_RETURN,
                             HOST_RELOC_TRACK)
from test_torch_host_tracking import (assert_arenas_close,
                                      assert_tracker_states_equal)
from test_torch_keyframe_db import assert_dbs_equal, reloc_world
from test_torch_relocalization import JaxDraws

torch.set_num_threads(2)


def _systems(cfg, tc, voc, tv):
    return (JSystem(cfg, vocabulary=voc),
            TSystem(tc, device="cpu", vocabulary=tv,
                    reloc_sampler=JaxDraws(7), loop_sampler=JaxDraws(13)))


def _step(js, ts, g, d, i):
    rj = js.track_rgbd(g, d, stamp=i / 30.0)
    rt = ts.track_rgbd(g, d, stamp=i / 30.0)
    assert rt == rj, (i, rj, rt)
    assert_tracker_states_equal(js.tracker.state, ts.tracker.state, i)
    assert_arenas_close(js.map, ts.map, i)
    assert_dbs_equal(js.kf_db, ts.kf_db, i)
    return rt[0]


@pytest.fixture(scope="module")
def world():
    return reloc_world(30)


def test_blackout_scene_frame_by_frame(world):
    cfg, tc, frames, _, voc, tv = world
    js, ts = _systems(cfg, tc, voc, tv)
    calls = []
    reloc = ts.relocalizer.relocalize
    ts.relocalizer.relocalize = lambda *a: calls.append(1) or reloc(*a)
    seq = [(g, d) for g, d, _ in frames[:HOST_RELOC_TRACK]]
    black = (np.zeros_like(frames[0][0]), np.ones_like(frames[0][1]))
    seq += [black] * HOST_RELOC_BLACK
    seq.append(frames[HOST_RELOC_RETURN][:2])
    states = [_step(js, ts, g, d, i) for i, (g, d) in enumerate(seq)]
    assert states[HOST_RELOC_TRACK - 1] == "OK"
    assert states[-2] == "LOST" and states[-1] == "OK"
    assert len(calls) == HOST_RELOC_BLACK     # once per lost frame
    assert ts.loop_closer.n_loops_closed == js.loop_closer.n_loops_closed


def test_reset_keeps_the_bow_half_on_the_old_arena(world):
    """Lost with fewer than ``reset_if_lost_with_kfs_below`` keyframes: the
    System resets; both packages leave the keyframe database, the
    relocalizer and the loop closer on the old arena, keep the old
    keyframes registered, and go on alike."""
    cfg, tc, frames, _, voc, tv = world
    js, ts = _systems(cfg, tc, voc, tv)
    black = (np.zeros_like(frames[0][0]), np.ones_like(frames[0][1]))
    seq = [frames[0][:2], frames[1][:2], black] + \
        [f[:2] for f in frames[2:6]]
    old = None
    for i, (g, d) in enumerate(seq):
        if i == 2:
            old = (js.map, ts.map)
        _step(js, ts, g, d, i)
    for s, arena in zip((js, ts), old):
        assert s.map is not arena
        assert s.tracker.map is s.map and s.mapper.map is s.map
        assert s.kf_db.map is arena
        assert s.relocalizer.map is arena and s.loop_closer.map is arena
        assert s.kf_db.erase not in s.map.on_keyframe_removed
    assert js.kf_db.registered.sum() == ts.kf_db.registered.sum() >= 1

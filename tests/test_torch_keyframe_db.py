"""Parity of the port's keyframe database (``slam/keyframe_db.py``) with the
JAX package on the CPU.

* Both Systems with the same vocabulary over the first 12 frames of the
  relocalization world (tests/test_vocabulary.py's room, orbit and ORB
  cut), frame by frame: tracking held as in
  ``tests/test_torch_host_tracking.py``, the databases' rows equal (word
  ids and registration exactly, tf-idf weights within 1e-6).
* Over one arena, both databases give equal loop and relocalization
  candidate lists (they depend on ``np.unique``, ``nonzero``, ``sorted``
  and their ties, so equal, not close), and ``score``/``score_kf`` agree
  within 1e-6 (measured: equal).
* A synthetic database with many ties (few words, random covisibility),
  over seeds.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax

from coebslam_tpu import config as jcfg
from coebslam_tpu.ops import extractor as jext
from coebslam_tpu.slam import vocabulary as jvoc
from coebslam_tpu.slam.keyframe_db import KeyFrameDatabase as JDB
from coebslam_tpu.slam.map import MapArena as JArena
from coebslam_tpu.slam.system import System as JSystem
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.slam import vocabulary as tvoc
from coebslam_tpu_torch.slam.keyframe_db import KeyFrameDatabase as TDB
from coebslam_tpu_torch.slam.map import MapArena as TArena
from coebslam_tpu_torch.slam.system import System as TSystem
from host_bow_scenes import (HOST_RELOC_VOCAB, HOST_RELOC_VOCAB_FRAMES,
                             host_reloc_config, scene_vocabulary)
from test_torch_host_tracking import (assert_arenas_close,
                                      assert_tracker_states_equal,
                                      room_frames)

torch.set_num_threads(2)
N_FRAMES = 12
SCORE_TOL = 1e-6


def reloc_world(n):
    """The relocalization world's config (both packages), its first n
    rendered frames and the JAX-trained scene vocabulary (both packages'
    types)."""
    cfg = host_reloc_config(jcfg)
    frames, poses = room_frames(30, cfg)
    ex = jax.jit(lambda g: jext.extract(g, cfg.orb))
    descs = []
    for i in HOST_RELOC_VOCAB_FRAMES:
        f = ex(frames[i][0])
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    voc = scene_vocabulary(jvoc, descs, **HOST_RELOC_VOCAB)
    tc = tcfg.config_from_dict(dataclasses.asdict(cfg))
    return cfg, tc, frames[:n], poses, voc, tvoc.Vocabulary(*voc)


def port_db_of(jdb, tv, arena):
    """A port database over ``arena`` with the JAX database's rows
    (erased ones too)."""
    tdb = TDB(tv, arena, jdb.kf_words.shape[0])
    for k in np.nonzero((jdb.kf_words >= 0).any(1))[0]:
        tdb.add(int(k), jdb.kf_words[k])
        if not jdb.registered[k]:
            tdb.erase(int(k))
    return tdb


def assert_dbs_equal(j, t, i=None):
    np.testing.assert_array_equal(t.registered, j.registered)
    np.testing.assert_array_equal(t.kf_words, j.kf_words)
    np.testing.assert_array_equal(t.kf_bow_words, j.kf_bow_words)
    np.testing.assert_allclose(t.kf_bow_vals, j.kf_bow_vals, atol=SCORE_TOL,
                               err_msg=str(i))


@pytest.fixture(scope="module")
def bow_run():
    cfg, tc, frames, _, voc, tv = reloc_world(N_FRAMES)
    js = JSystem(cfg, vocabulary=voc)
    ts = TSystem(tc, device="cpu", vocabulary=tv)
    for i, (g, d, _) in enumerate(frames):
        rj = js.track_rgbd(g, d, stamp=i / 30.0)
        rt = ts.track_rgbd(g, d, stamp=i / 30.0)
        assert rt == rj, (i, rj, rt)
        assert_tracker_states_equal(js.tracker.state, ts.tracker.state, i)
        assert_arenas_close(js.map, ts.map, i)
        assert_dbs_equal(js.kf_db, ts.kf_db, i)
    return js, ts, tv


def test_databases_equal_frame_by_frame(bow_run):
    js, ts, _ = bow_run
    assert js.kf_db.registered.sum() >= 2
    assert ts.loop_closer.n_loops_closed == js.loop_closer.n_loops_closed


def test_candidates_equal_over_one_arena(bow_run):
    """The port's database over the JAX System's arena, given the JAX
    database's rows (erased ones too): the same candidates and scores for
    every keyframe."""
    js, _, tv = bow_run
    jdb = js.kf_db
    tdb = port_db_of(jdb, tv, js.map)
    assert_dbs_equal(jdb, tdb)
    kfs = np.nonzero(jdb.registered)[0]
    n_cands = 0
    for k in kfs:
        k = int(k)
        np.testing.assert_allclose(tdb.score_kf(k, kfs), jdb.score_kf(k, kfs),
                                   atol=SCORE_TOL)
        for min_score in (0.0, 0.05, 0.2):
            a = jdb.detect_loop_candidates(k, min_score)
            np.testing.assert_array_equal(
                tdb.detect_loop_candidates(k, min_score), a)
        # A keyframe's own words and a half of them as queries.
        for q in (jdb.kf_words[k], jdb.kf_words[k][::2]):
            a = jdb.detect_relocalization_candidates(q)
            np.testing.assert_array_equal(
                tdb.detect_relocalization_candidates(q), a)
            n_cands += len(a)
    assert n_cands > 0


class _Stub:
    """Both packages' arenas with the same covisibility, and databases
    over them filled with the same random words (few words, many ties)."""

    def __init__(self, seed, K=24, N=64, n_words=40):
        rng = np.random.RandomState(seed)
        cfg = jcfg.SystemConfig(
            orb=jcfg.OrbConfig(max_keypoints=N),
            map=jcfg.MapConfig(max_keyframes=K, max_points=256))
        tc = tcfg.config_from_dict(dataclasses.asdict(cfg))
        cov = rng.randint(0, 40, (K, K)) * (rng.rand(K, K) < 0.3)
        cov = np.triu(cov, 1)
        cov = (cov + cov.T).astype(np.int32)
        valid = rng.rand(K) < 0.9
        self.arenas = []
        for arena in (JArena(cfg), TArena(tc)):
            arena.covis[:] = cov
            arena.kf_valid[:] = valid
            arena.n_kf = K
            self.arenas.append(arena)
        weights = rng.uniform(0.1, 3.0, n_words).astype(np.float32)
        voc = jvoc.Vocabulary(np.zeros((1, 32), np.uint8),
                              np.full((1, 2), -1, np.int32),
                              np.full(1, -1, np.int32), weights,
                              np.zeros(1, np.int32), 1, 2)
        self.j = JDB(voc, self.arenas[0], K)
        self.t = TDB(tvoc.Vocabulary(*voc), self.arenas[1], K)
        self.words = np.where(rng.rand(K, N) < 0.8,
                              rng.randint(0, n_words, (K, N)), -1)
        self.words = self.words.astype(np.int32)
        for k in np.nonzero(valid)[0]:
            for db in (self.j, self.t):
                db.add(int(k), self.words[k])
        self.valid = valid
        self.rng = rng


@pytest.mark.parametrize("seed", range(4))
def test_candidates_equal_with_ties(seed):
    s = _Stub(seed)
    assert_dbs_equal(s.j, s.t)
    erased = np.nonzero(s.valid)[0][:2]
    for db in (s.j, s.t):
        for k in erased:
            db.erase(int(k))
    for k in np.nonzero(s.valid)[0]:
        k = int(k)
        for min_score in (0.0, 0.3):
            np.testing.assert_array_equal(
                s.t.detect_loop_candidates(k, min_score),
                s.j.detect_loop_candidates(k, min_score))
    for _ in range(8):
        q = s.words[s.rng.randint(len(s.words))][s.rng.rand(64) < 0.6]
        np.testing.assert_array_equal(
            s.t.detect_relocalization_candidates(q),
            s.j.detect_relocalization_candidates(q))
        qw, qv = s.j.sparse_bow(q)
        ids = np.arange(len(s.words))
        np.testing.assert_allclose(s.t.score(qw, qv, ids),
                                   s.j.score(qw, qv, ids), atol=SCORE_TOL)

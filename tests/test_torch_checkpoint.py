"""Parity of the port's map checkpoints (``coebslam_tpu_torch/io/
checkpoint.py``) with the JAX package's: a map that either package saves
loads into the other with every array equal, a port ``System`` resumes in
localization mode against a saved map as
``tests/test_stereo_checkpoint.py::TestCheckpoint`` does, and a
vocabulary saved by either loads into the other. The map is the JAX
System's after the first 8 frames of TestCheckpoint's scene; the keyframe
database's fields ride along on a stand-in object."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax

from coebslam_tpu.io import checkpoint as jck
from coebslam_tpu.slam import vocabulary as jvoc
from coebslam_tpu.slam.system import System as JSystem
from coebslam_tpu.utils import synthetic as jsyn
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.io import checkpoint as tck
from coebslam_tpu_torch.slam import system as tsys
from coebslam_tpu_torch.slam import vocabulary as tvoc
from test_stereo_checkpoint import stereo_config

torch.set_num_threads(2)

N_FRAMES = 8


def rgbd_config():
    return dataclasses.replace(stereo_config(), sensor="rgbd")


def fake_db(seed, max_kf):
    rng = np.random.RandomState(seed)
    return SimpleNamespace(
        kf_words=rng.randint(-1, 50, (max_kf, 64)).astype(np.int32),
        kf_bow_words=rng.randint(-1, 50, (max_kf, 64)).astype(np.int32),
        kf_bow_vals=rng.rand(max_kf, 64).astype(np.float32),
        registered=rng.rand(max_kf) > 0.5)


@pytest.fixture(scope="module")
def jax_map(tmp_path_factory):
    """The JAX System after N_FRAMES of TestCheckpoint's scene, saved with
    its tracker state and a keyframe database."""
    cfg = rgbd_config()
    planes = jsyn.make_room(seed=0)
    poses = jsyn.camera_trajectory(40, radius=0.35)[:N_FRAMES]
    render = jax.jit(lambda p: jsyn.render(cfg.camera, p, planes)[:2])
    frames = [tuple(np.asarray(x) for x in render(p)) for p in poses]
    js = JSystem(cfg)
    for i, (g, d) in enumerate(frames):
        js.track_rgbd(g, d, stamp=i / 30.0)
    assert js.map.n_kf >= 2
    path = str(tmp_path_factory.mktemp("ckpt") / "jax_map.npz")
    db = fake_db(0, cfg.map.max_keyframes)
    jck.save_map(path, js.map, tracker_state=js.tracker.state, kf_db=db)
    return cfg, js, db, path, frames


def assert_maps_equal(a, b):
    for f in jck._ARENA_FIELDS:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
    assert (b.n_kf, b.n_pt, b.kf_seq_counter) == (a.n_kf, a.n_pt,
                                                   a.kf_seq_counter)
    assert list(b._free_pt) == list(a._free_pt)
    assert list(b._free_kf) == list(a._free_kf)
    assert sorted(b.kf_cull_rel) == sorted(a.kf_cull_rel)
    for k, (p, R, t) in a.kf_cull_rel.items():
        q, R2, t2 = b.kf_cull_rel[k]
        assert q == p
        np.testing.assert_array_equal(R2, R)
        np.testing.assert_array_equal(t2, t)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_map_loads_across_packages(jax_map, tmp_path, direction):
    cfg, js, db, path, _ = jax_map
    tc = tcfg.config_from_dict(dataclasses.asdict(cfg))
    db_t = fake_db(1, cfg.map.max_keyframes)
    tmap = tck.load_map(path, tc, kf_db=db_t)
    if direction == "jax_to_port":
        assert_maps_equal(js.map, tmap)
        loaded = db_t
    else:
        path2 = str(tmp_path / "port_map.npz")
        tck.save_map(path2, tmap, tracker_state=js.tracker.state, kf_db=db_t)
        loaded = fake_db(2, cfg.map.max_keyframes)
        assert_maps_equal(js.map, jck.load_map(path2, cfg, kf_db=loaded))
        assert sorted(np.load(path2).files) == sorted(np.load(path).files)
    for f in ("kf_words", "kf_bow_words", "kf_bow_vals", "registered"):
        np.testing.assert_array_equal(getattr(loaded, f), getattr(db, f))


def test_load_refuses_another_shape(jax_map):
    cfg, _, _, path, _ = jax_map
    tc = tcfg.config_from_dict(dataclasses.asdict(cfg))
    small = dataclasses.replace(tc, map=dataclasses.replace(
        tc.map, max_points=1024))
    with pytest.raises(ValueError, match="pt_pos"):
        tck.load_map(path, small)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_localization_resume(jax_map, tmp_path, writer):
    """A fresh port System resumed from the saved map (written by either
    package) through ``checkpoint.resume``: the map in every part, the
    pose restored, localization mode, the last keyframe as the last
    frame, then the last frame tracked: OK with > 100 inliers, no
    keyframe added."""
    cfg, js, _, path, frames = jax_map
    tc = tcfg.config_from_dict(dataclasses.asdict(cfg))
    if writer == "port":
        p2 = str(tmp_path / "port_map.npz")
        tck.save_map(p2, tck.load_map(path, tc), tracker_state=js.tracker.state)
        path = p2
    ts = tsys.System(tc, device="cpu")
    callbacks = list(ts.map.on_keyframe_removed)
    assert tck.resume(path, ts)
    assert ts.tracker.map is ts.map and ts.mapper.map is ts.map
    assert ts.map.on_keyframe_removed == callbacks
    assert_maps_equal(js.map, ts.map)
    np.testing.assert_array_equal(ts.tracker.state.pose_R,
                                  js.tracker.state.pose_R)
    assert ts.localization_only and ts.tracker.state.mode == "OK"
    ref = int(ts.map.valid_keyframes()[-1])
    assert ts.tracker.ref_kf == ref
    np.testing.assert_array_equal(ts.tracker.last_frame.point_ids,
                                  ts.map.kf_obs_pt[ref])
    n_kfs = len(ts.map.valid_keyframes())
    g, d = frames[N_FRAMES - 1]
    state, n = ts.track_rgbd(g, d, stamp=99.0)
    assert state == "OK" and n > 100, (state, n)
    assert len(ts.map.valid_keyframes()) == n_kfs


def test_resume_needs_tracker_state(jax_map, tmp_path):
    """A map saved without the tracker's state is not resumed, and the
    System keeps its own empty map."""
    cfg, js, _, _, _ = jax_map
    tc = tcfg.config_from_dict(dataclasses.asdict(cfg))
    path = str(tmp_path / "map_only.npz")
    jck.save_map(path, js.map)
    ts = tsys.System(tc, device="cpu")
    empty = ts.map
    assert not tck.resume(path, ts)
    assert ts.map is empty and ts.tracker.map is empty and empty.n_kf == 0
    assert ts.tracker.state.mode == "NOT_INITIALIZED"
    assert not ts.localization_only


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_vocabulary_roundtrip(tmp_path, direction):
    rng = np.random.RandomState(0)
    desc = rng.randint(0, 256, (500, 32), dtype=np.uint8)
    voc = tvoc.train(desc, branching=5, depth=2)
    p = str(tmp_path / "voc.npz")
    if direction == "jax_to_port":
        jck.save_vocabulary(p, jvoc.Vocabulary(*voc))
        voc2 = tck.load_vocabulary(p)
    else:
        tck.save_vocabulary(p, voc)
        voc2 = jck.load_vocabulary(p)
    for a, b in zip(voc, voc2):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    w1, _ = jvoc.transform_host(jvoc.Vocabulary(*voc), desc[:50])
    w2, _ = jvoc.transform_host(jvoc.Vocabulary(*voc2), desc[:50])
    np.testing.assert_array_equal(w2, w1)

"""Parity of the port's ORBvoc text format, visualization and vocabulary
trainer with the JAX package's, on the CPU. Every comparison is exact:
files byte-equal, arrays equal."""
import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

from coebslam_tpu.slam import vocabulary as jvoc
from coebslam_tpu.utils import viz as jviz
from coebslam_tpu_torch.slam import vocabulary as tvoc
from coebslam_tpu_torch.tools import train_vocab as ttrain
from coebslam_tpu_torch.utils import viz as tviz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_train_vocab():
    """tools/train_vocab.py of the JAX package, loaded from its path."""
    spec = importlib.util.spec_from_file_location(
        "jax_train_vocab", os.path.join(REPO, "tools", "train_vocab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def voc():
    rng = np.random.RandomState(0)
    desc = rng.randint(0, 256, (600, 32), np.uint8)
    return tvoc.train(desc, branching=4, depth=3, seed=0)


def _assert_voc_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == np.asarray(y).dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert x == y, name


def test_orbvoc_text_both_ways(voc, tmp_path):
    j_path, t_path = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jvoc.save_orbvoc_text(j_path, jvoc.Vocabulary(*voc))
    tvoc.save_orbvoc_text(t_path, voc)
    assert open(j_path).read() == open(t_path).read()
    _assert_voc_equal(tvoc.load_orbvoc_text(j_path),
                      jvoc.load_orbvoc_text(j_path))
    back = jvoc.load_orbvoc_text(t_path)
    _assert_voc_equal(tvoc.Vocabulary(*back), tvoc.load_orbvoc_text(t_path))
    q = np.random.RandomState(1).randint(0, 256, (64, 32), np.uint8)
    w_t = tvoc.transform_host(tvoc.load_orbvoc_text(t_path), q)
    w_j = jvoc.transform_host(back, q)
    for a, b in zip(w_t, w_j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(w_t[0], tvoc.transform_host(voc, q)[0])


def test_orbvoc_text_irregular_file(tmp_path):
    """Blank and short lines, extra fields, a parent read after its child
    and a parent with more than k children: read as the JAX package's
    line-by-line loader reads them."""
    rng = np.random.RandomState(2)

    def line(parent, leaf, w, extra=""):
        d = " ".join(str(x) for x in rng.randint(0, 256, 32))
        return f"{parent} {leaf} {d} {w}{extra}"

    lines = ["2 3 0 0", line(0, 0, 0.0), line(0, 0, 0.0), "",
             line(1, 1, 0.5), line(1, 1, 0.25, " 7 8"), "1 1 3",
             line(1, 1, 1.5), line(5, 1, 2.0), line(2, 1, 0.125),
             line(9, 1, 3.0)]
    path = str(tmp_path / "voc.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    _assert_voc_equal(tvoc.load_orbvoc_text(path),
                      jvoc.load_orbvoc_text(path))


def test_orbvoc_rows_equal_line_by_line_reading(voc, tmp_path):
    """The numpy parse of a regular body gives the rows that reading it
    line by line gives."""
    path = str(tmp_path / "v.txt")
    tvoc.save_orbvoc_text(path, voc)
    body = open(path).read().split("\n", 1)[1]
    want = np.asarray([[float(x) for x in ln.split()]
                       for ln in body.splitlines()])
    got = tvoc._orbvoc_rows(body)
    assert got.shape == (len(voc.node_desc) - 1, 35)
    np.testing.assert_array_equal(got, want)


def test_train_tree_matches_the_jax_tool():
    """tools/train_vocab.py's train_tree (tools/train_vocab.py:67) on the
    same descriptors and seed."""
    jt = _jax_train_vocab()
    rng = np.random.RandomState(3)
    # Clustered descriptors, so the tree has leaves at several depths.
    centres = rng.randint(0, 256, (12, 32), np.uint8)
    flips = rng.rand(1500, 32, 8) < 0.08
    noise = np.packbits(flips, axis=-1, bitorder="little")[..., 0]
    descs = centres[rng.randint(0, 12, 1500)] ^ noise
    t = ttrain.train_tree(descs, branching=5, depth=3, seed=0)
    j = jt.train_tree(descs, branching=5, depth=3, seed=0)
    _assert_voc_equal(t, tvoc.Vocabulary(*j))
    assert t.n_words > 20
    np.testing.assert_array_equal(ttrain.hamming_chunked(descs, centres,
                                                         chunk=100),
                                  jt.hamming_chunked(descs, centres))


def _scene():
    rng = np.random.RandomState(5)
    pts = rng.randn(300, 3).astype(np.float32)
    valid = rng.rand(300) < 0.8
    traj = np.cumsum(0.1 * rng.randn(25, 3), axis=0)
    kf_R = np.stack([np.eye(3)] * 5).astype(np.float32)
    return pts, valid, traj, kf_R


def test_ply_bytes_equal(tmp_path):
    pts, valid, traj, _ = _scene()
    colors = np.random.RandomState(6).randint(0, 256, (300, 3))
    for kw in ({}, dict(colors=colors, keyframe_positions=traj[:4])):
        tviz.save_ply(str(tmp_path / "t.ply"), pts, **kw)
        jviz.save_ply(str(tmp_path / "j.ply"), pts, **kw)
        assert open(tmp_path / "t.ply", "rb").read() \
            == open(tmp_path / "j.ply", "rb").read()


def test_drawings_equal(tmp_path):
    pts, valid, traj, kf_R = _scene()
    rng = np.random.RandomState(7)
    gray = rng.rand(60, 80).astype(np.float32) * 300 - 20
    uv = rng.rand(50, 2) * [85, 65] - 2
    ok = rng.rand(50) < 0.8
    ids = np.where(rng.rand(50) < 0.5, 3, -1)
    mask = rng.rand(60, 80) < 0.3
    boxes = [[5, 5, 30, 40], [-1, -1, -1, -1], [50.4, 10.6, 79.5, 59]]
    for kw in ({}, dict(point_ids=ids, dynamic_mask=mask, boxes=boxes,
                        state="OK"), dict(state="LOST"), dict(state="X")):
        np.testing.assert_array_equal(tviz.draw_frame(gray, uv, ok, **kw),
                                      jviz.draw_frame(gray, uv, ok, **kw))
    for kw in (dict(kf_t=traj[:5], kf_R=kf_R, trajectory=traj, size=150),
               dict(kf_t=traj[:5], size=90, axes=(0, 1)), {}):
        a = tviz.render_map_topdown(pts, valid, **kw)
        np.testing.assert_array_equal(
            a, jviz.render_map_topdown(pts, valid, **kw))
    tviz.save_png(str(tmp_path / "m.png"), a)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "m.png")),
                                  a)


def _fake_system(n_frames):
    """What LiveViewer reads of a System: its map and its trajectory."""
    pts, valid, traj, kf_R = _scene()
    m = SimpleNamespace(pt_pos=pts, pt_valid=valid, kf_R=kf_R,
                        kf_t=traj[:5].astype(np.float32),
                        valid_keyframes=lambda: np.arange(5))
    tr = SimpleNamespace(trajectory=[(i / 30, np.eye(3), traj[i])
                                     for i in range(n_frames)])
    return SimpleNamespace(map=m, tracker=tr)


def test_live_viewer_matches(tmp_path):
    calls = []
    sysm = _fake_system(12)
    tv = tviz.LiveViewer(str(tmp_path / "t"), every=3)
    jv = jviz.LiveViewer(str(tmp_path / "j"), every=3)
    t_cb = tv.hook(sysm, chain=lambda: calls.append(1))
    j_cb = jv.hook(sysm)
    for i in range(7):
        t_cb()
        j_cb()
    assert len(calls) == 7 and tv.n == jv.n == 7
    assert sorted(os.listdir(tmp_path / "t")) == ["map_topdown.png"]
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "t" / "map_topdown.png")),
        np.asarray(Image.open(tmp_path / "j" / "map_topdown.png")))

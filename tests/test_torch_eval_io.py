"""The port's file readers and writers against the JAX package's, on the
CPU: TUM sequences (the replica written by each package and read by
both), EuRoC and KITTI loaders, the TUM trajectory format and the relative
pose error; and [13]'s in-memory feed of ``chip_smoke.py`` against the
driver's feed from files.

Tolerances: the readers are bit-equal (the same PNG bytes decode to the
same arrays; the grey conversion is the same float64 arithmetic). Files
written by the two packages differ where the two renderers do (grey by
one level on at most 40 pixels of a frame, 16-bit depth by one unit on at
most 700, as in tests/test_torch_replica.py); their text lines are
equal. RPE agrees to 1e-12.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from coebslam_tpu.eval import rpe as jrpe
from coebslam_tpu.io import euroc as jeuroc
from coebslam_tpu.io import kitti as jkitti
from coebslam_tpu.io import trajectory as jtraj
from coebslam_tpu.io import tum as jtum
from coebslam_tpu.utils import replica as jrep
from coebslam_tpu_torch.eval import rpe as trpe
from coebslam_tpu_torch.io import euroc as teuroc
from coebslam_tpu_torch.io import kitti as tkitti
from coebslam_tpu_torch.io import trajectory as ttraj
from coebslam_tpu_torch.io import tum as ttum
from coebslam_tpu_torch.utils import replica as trep

torch.set_num_threads(1)
N_REPLICA = 12


@pytest.fixture(scope="module")
def replicas(tmp_path_factory):
    """The 12-frame replica written by the JAX package and by the port."""
    jroot = str(tmp_path_factory.mktemp("jax_replica"))
    troot = str(tmp_path_factory.mktemp("port_replica"))
    jrep.generate(jroot, n_frames=N_REPLICA)
    written = trep.write(troot, n_frames=N_REPLICA, device="cpu")
    return jroot, troot, written


def _seq_fields_equal(a, b):
    np.testing.assert_array_equal(a.rgb_stamps, b.rgb_stamps)
    np.testing.assert_array_equal(a.depth_stamps, b.depth_stamps)
    assert a.rgb_files == b.rgb_files and a.depth_files == b.depth_files
    for f in ("gt_stamps", "gt_poses"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


def _frames_equal(a, b, n):
    for i in range(n):
        for load in ("load_frame", "load_frame_raw"):
            fa, fb = getattr(a, load)(i), getattr(b, load)(i)
            assert fa[0] == fb[0]
            for x, y in zip(fa[1:], fb[1:]):
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)


def test_port_reads_jax_written_replica(replicas):
    jroot, _, _ = replicas
    t, j = ttum.load_tum_sequence(jroot), jtum.load_tum_sequence(jroot)
    assert len(t) == len(j) == N_REPLICA
    _seq_fields_equal(t, j)
    _frames_equal(t, j, N_REPLICA)


def _lines(root, name):
    with open(os.path.join(root, name)) as f:
        return f.read().splitlines()


def test_jax_reads_port_written_replica(replicas):
    jroot, troot, written = replicas
    for name in ("rgb.txt", "depth.txt", "groundtruth.txt", "boxes.txt"):
        assert _lines(troot, name) == _lines(jroot, name), name
    assert sorted(os.listdir(os.path.join(troot, "rgb"))) \
        == sorted(os.listdir(os.path.join(jroot, "rgb")))
    on_port, on_jax = jtum.load_tum_sequence(troot), \
        jtum.load_tum_sequence(jroot)
    _seq_fields_equal(on_port, on_jax)
    for i in range(N_REPLICA):
        _, g, d = on_port.load_frame_raw(i)
        _, g0, d0 = on_jax.load_frame_raw(i)
        dg = np.abs(g.astype(np.int32) - g0)
        dd = np.abs(d.astype(np.int32) - d0)
        assert dg.max() <= 1 and (dg > 0).sum() <= 40, (i, dg.sum())
        assert dd.max() <= 1 and (dd > 0).sum() <= 700, (i, dd.sum())
    np.testing.assert_array_equal(written["stamps"], on_jax.rgb_stamps)


def test_write_prefix_equals_the_full_run(replicas, tmp_path):
    """``frames=`` writes a prefix of the schedule, file for file."""
    _, troot, _ = replicas
    trep.write(str(tmp_path), n_frames=N_REPLICA, frames=range(3),
               device="cpu")
    assert _lines(tmp_path, "rgb.txt") == _lines(troot, "rgb.txt")[:4]
    for name in sorted(os.listdir(tmp_path / "depth")):
        assert open(tmp_path / "depth" / name, "rb").read() \
            == open(os.path.join(troot, "depth", name), "rb").read()


def _colour_sequence(root, rng, n=3, alpha=False):
    """A TUM layout with colour (or RGBA) PNGs, 16-bit depth, comments and
    ground truth, written by PIL."""
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    rgb_lines, depth_lines = ["# color images"], ["# depth maps"]
    for i in range(n):
        s_rgb, s_dep = 1305031102.175304 + i / 30, 1305031102.160407 + i / 30
        img = rng.randint(0, 256, (24, 32, 4 if alpha else 3)).astype(
            np.uint8)
        dep = rng.randint(0, 40000, (24, 32)).astype(np.uint16)
        Image.fromarray(img).save(root / "rgb" / f"{s_rgb:.6f}.png")
        Image.fromarray(dep).save(root / "depth" / f"{s_dep:.6f}.png")
        rgb_lines.append(f"{s_rgb:.6f} rgb/{s_rgb:.6f}.png")
        depth_lines.append(f"{s_dep:.6f} depth/{s_dep:.6f}.png")
    (root / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (root / "depth.txt").write_text("\n".join(depth_lines) + "\n")
    gt = rng.randn(2 * n, 8)
    gt[:, 0] = 1305031102.17 + np.arange(2 * n) / 60
    (root / "groundtruth.txt").write_text(
        "# ground truth\n" + "\n".join(" ".join(f"{v:.6f}" for v in row)
                                       for row in gt) + "\n")
    assoc = root / "assoc.txt"
    assoc.write_text("\n".join(
        f"{a.split()[0]} {a.split()[1]} {b.split()[0]} {b.split()[1]}"
        for a, b in zip(rgb_lines[1:], depth_lines[1:])) + "\n")
    return str(assoc)


@pytest.mark.parametrize("alpha", [False, True])
def test_colour_frames_and_association_file(alpha, tmp_path):
    """The grey of a colour image: float32 for load_frame, truncated uint8
    for load_frame_raw, bit-equal to the JAX package's."""
    assoc = _colour_sequence(tmp_path, np.random.RandomState(int(alpha)),
                             alpha=alpha)
    root = str(tmp_path)
    t, j = ttum.load_tum_sequence(root), jtum.load_tum_sequence(root)
    _seq_fields_equal(t, j)
    _frames_equal(t, j, len(j))
    for depth_factor in (5000.0, 1.0):
        np.testing.assert_array_equal(t.load_frame(1, depth_factor)[2],
                                      j.load_frame(1, depth_factor)[2])
    t, j = ttum.load_association_file(root, assoc), \
        jtum.load_association_file(root, assoc)
    _seq_fields_equal(t, j)
    _frames_equal(t, j, len(j))


def _write_png(path, arr):
    Image.fromarray(arr.astype(np.uint8)).save(path)


def test_kitti_loader(tmp_path):
    """tests/test_io_viz.py's KITTI fixture, plus a colour frame."""
    root = tmp_path / "00"
    (root / "image_0").mkdir(parents=True)
    (root / "image_1").mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        img = rng.randint(0, 255, (40, 60), np.uint8)
        _write_png(root / "image_0" / f"{i:06d}.png", img)
        _write_png(root / "image_1" / f"{i:06d}.png",
                   rng.randint(0, 255, (40, 60, 3), np.uint8))
    (root / "times.txt").write_text("0.0\n0.1\n0.2\n")
    pf = tmp_path / "00.txt"
    np.savetxt(pf, rng.randn(3, 12))
    t = tkitti.load_kitti_sequence(str(root), str(pf))
    j = jkitti.load_kitti_sequence(str(root), str(pf))
    assert len(t) == len(j) == 3
    np.testing.assert_array_equal(t.stamps, j.stamps)
    assert t.left_files == j.left_files and t.right_files == j.right_files
    np.testing.assert_array_equal(t.gt_poses, j.gt_poses)
    for i in range(3):
        for a, b in zip(t.load_stereo(i), j.load_stereo(i)):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)
        for a, b in zip(t.load_frame(i), j.load_frame(i)):
            np.testing.assert_array_equal(a, b)


def test_euroc_loader(tmp_path):
    """tests/test_io_viz.py's EuRoC fixture, with cam1 and a timestamp
    file."""
    stamps_ns = [1403636579763555584, 1403636579813555456]
    rng = np.random.RandomState(0)
    lines = ["#timestamp [ns],filename"]
    for cam in ("cam0", "cam1"):
        (tmp_path / "mav0" / cam / "data").mkdir(parents=True)
    for s in stamps_ns:
        _write_png(tmp_path / "mav0" / "cam0" / "data" / f"{s}.png",
                   rng.randint(0, 255, (30, 40), np.uint8))
        _write_png(tmp_path / "mav0" / "cam1" / "data" / f"{s}.png",
                   rng.randint(0, 255, (30, 40, 3), np.uint8))
        lines.append(f"{s},{s}.png")
    (tmp_path / "mav0" / "cam0" / "data.csv").write_text(
        "\n".join(lines) + "\n")
    gt_dir = tmp_path / "mav0" / "state_groundtruth_estimate0"
    gt_dir.mkdir(parents=True)
    (gt_dir / "data.csv").write_text(
        "#ts,px,py,pz,qw,qx,qy,qz\n"
        f"{stamps_ns[0]},1,2,3,1,0,0,0,9,9\n")
    stamp_file = tmp_path / "times.txt"
    stamp_file.write_text(f"{stamps_ns[1]}\n\n{stamps_ns[0]}\n")
    for ts in (None, str(stamp_file)):
        t = teuroc.load_euroc_sequence(str(tmp_path), ts)
        j = jeuroc.load_euroc_sequence(str(tmp_path), ts)
        assert len(t) == len(j) == 2
        np.testing.assert_array_equal(t.stamps, j.stamps)
        assert t.cam0_files == j.cam0_files and t.cam1_files == j.cam1_files
        np.testing.assert_array_equal(t.gt_stamps, j.gt_stamps)
        np.testing.assert_array_equal(t.gt_poses, j.gt_poses)
        for i in range(2):
            (s1, g1), (s2, g2) = t.load_frame(i), j.load_frame(i)
            assert s1 == s2 and g1.dtype == g2.dtype
            np.testing.assert_array_equal(g1, g2)
        # The right image, as the JAX stereo driver converts it.
        right = np.asarray(Image.open(j.cam1_files[0])).astype(np.float32)
        right = 0.299 * right[..., 0] + 0.587 * right[..., 1] \
            + 0.114 * right[..., 2]
        np.testing.assert_array_equal(teuroc.load_gray(t.cam1_files[0]),
                                      right)


def _random_poses(rng, n):
    from coebslam_tpu_torch.geometry import so3
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        w = torch.from_numpy(0.3 * rng.randn(3).astype(np.float32))
        out[i, :3, :3] = so3.exp(w).numpy()
        out[i, :3, 3] = rng.randn(3)
    return out


@pytest.mark.parametrize("delta", [1, 3])
def test_rpe_matches(delta):
    rng = np.random.RandomState(delta)
    gt = _random_poses(rng, 20)
    est = gt.copy()
    est[:, :3, 3] += 0.01 * rng.randn(20, 3)
    est[:, :3, :3] = _random_poses(rng, 20)[:, :3, :3] @ gt[:, :3, :3] \
        if delta == 3 else est[:, :3, :3]
    t, j = trpe.rpe(est, gt, delta), jrpe.rpe(est, gt, delta)
    assert t["pairs"] == j["pairs"] == 20 - delta
    for k in ("trans_rmse", "trans_mean", "rot_rmse", "rot_mean"):
        assert abs(t[k] - j[k]) <= 1e-12, k


def test_tum_trajectory_round_trip(tmp_path):
    """Each package reads what the other writes (TUM format), and the
    KITTI rows are the same text."""
    rng = np.random.RandomState(4)
    T = _random_poses(rng, 7)
    stamps = 1305031102.1 + np.arange(7) / 30
    poses_cw = [(M[:3, :3].T, -M[:3, :3].T @ M[:3, 3]) for M in T]
    for save, load in ((ttraj.save_tum, jtraj.load_tum),
                       (jtraj.save_tum, ttraj.load_tum)):
        path = str(tmp_path / "traj.txt")
        save(path, stamps, poses_cw)
        s, xyzq = load(path)
        np.testing.assert_allclose(s, stamps, atol=5e-7)
        np.testing.assert_allclose(xyzq[:, :3], T[:, :3, 3], atol=5e-7)
        back = ttraj.tum_to_matrices(xyzq)
        np.testing.assert_allclose(back[:, :3, :3], T[:, :3, :3], atol=1e-5)
    ttraj.save_tum(str(tmp_path / "a.txt"), stamps, poses_cw)
    jtraj.save_tum(str(tmp_path / "b.txt"), stamps, poses_cw)
    assert _lines(tmp_path, "a.txt") == _lines(tmp_path, "b.txt")
    ttraj.save_kitti(str(tmp_path / "a.txt"), poses_cw)
    jtraj.save_kitti(str(tmp_path / "b.txt"), poses_cw)
    assert _lines(tmp_path, "a.txt") == _lines(tmp_path, "b.txt")

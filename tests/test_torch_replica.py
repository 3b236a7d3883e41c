"""Parity of the port's in-memory replica generator with the JAX package's
PNG writer on the CPU: the JAX ``generate`` writes a short sequence that
covers every feature (two walkers composited by depth, a blur window, a
shake window; and an out-and-back closure run), the test reads it back
with PIL as ``io/tum.py`` does, and holds the port's frames, ground-truth
lines and boxes against it. Also ``so3.matrix_to_quat`` on every branch.

Measured differences (the two renderers round a texel lookup or a ray
depth differently at a few pixels, see
``tests/test_torch_realtime.py::test_renderer_matches``): grey differs by
one level on at most 33 of 307200 pixels of a frame, 16-bit depth by one
unit (0.2 mm) on at most 641. The tests hold those bounds; the
ground-truth and box lines are equal.
"""
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from coebslam_tpu.geometry import so3 as jso3
from coebslam_tpu.io import tum
from coebslam_tpu.utils import replica as jrep
from coebslam_tpu_torch.geometry import so3 as tso3
from coebslam_tpu_torch.utils import replica as trep

torch.set_num_threads(1)

CASES = {
    "walkers": dict(n_frames=20, seed=0, walkers=2,
                    blur_windows=((8, 11, 9),), shake_window=(13, 17)),
    "closure": dict(n_frames=12, seed=0, closure=True),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def both(request, tmp_path_factory):
    kw = CASES[request.param]
    root = str(tmp_path_factory.mktemp(request.param))
    jrep.generate(root, **kw)
    frames = list(trep.generate(**kw, device="cpu"))
    return request.param, root, frames


def _lines(root, name):
    with open(os.path.join(root, name)) as f:
        return [ln for ln in f.read().splitlines() if not ln.startswith("#")]


def test_frames_match_the_pngs(both):
    name, root, frames = both
    seq = tum.load_tum_sequence(root)
    assert len(seq) == len(frames) == CASES[name]["n_frames"]
    for i, f in enumerate(frames):
        stamp, g, d = seq.load_frame_raw(i)
        assert f.stamp == stamp and f.index == i
        assert f.gray.dtype == np.uint8 and f.depth.dtype == np.uint16
        dg = np.abs(g.astype(np.int32) - f.gray)
        dd = np.abs(d.astype(np.int32) - f.depth)
        assert dg.max() <= 1 and (dg > 0).sum() <= 40, (i, dg.sum())
        assert dd.max() <= 1 and (dd > 0).sum() <= 700, (i, dd.sum())
        # The float-metres contract of io/tum.load_frame.
        _, _, dm = seq.load_frame(i, depth_factor=trep.DEPTH_FACTOR)
        np.testing.assert_allclose(
            f.depth.astype(np.float32) / trep.DEPTH_FACTOR, dm, atol=2.1e-4)


def test_text_lines_and_boxes_match(both):
    name, root, frames = both
    assert [f.gt_line for f in frames] == _lines(root, "groundtruth.txt")
    boxes = _lines(root, "boxes.txt")
    assert boxes == [ln for f in frames for ln in f.box_lines]
    if name == "walkers":
        assert max(len(f.boxes) for f in frames) == 2
    # What load_boxes reads back, frame by frame.
    stamps, arr = jrep.load_boxes(os.path.join(root, "boxes.txt"))
    t_stamps, t_arr = trep.load_boxes(os.path.join(root, "boxes.txt"))
    np.testing.assert_array_equal(t_stamps, stamps)
    np.testing.assert_array_equal(t_arr, arr)
    by_stamp = {s: a for s, a in zip(stamps, arr)}
    for f in frames:
        if len(f.boxes):
            np.testing.assert_array_equal(f.boxes, by_stamp[f.stamp][
                :len(f.boxes)])


def test_lazy_frames_equal_the_full_run(both):
    """``frames=`` renders only the asked frames, and they equal the full
    run's."""
    name, _, frames = both
    part = list(trep.generate(**CASES[name], frames=[3, 9], device="cpu"))
    assert [f.index for f in part] == [3, 9]
    for f in part:
        np.testing.assert_array_equal(f.gray, frames[f.index].gray)
        np.testing.assert_array_equal(f.depth, frames[f.index].depth)
        assert f.gt_line == frames[f.index].gt_line


def test_schedule_matches_the_reference_poses():
    for closure in (False, True):
        jp = [jrep.walking_trajectory, jrep.closure_trajectory][closure](
            30, seed=3)
        tp = [trep.walking_trajectory, trep.closure_trajectory][closure](
            30, seed=3)
        for a, b in zip(jp, tp):
            np.testing.assert_array_equal(b.R.numpy(), np.asarray(a.R))
            np.testing.assert_array_equal(b.t.numpy(), np.asarray(a.t))


def test_matrix_to_quat_all_branches():
    """Random rotations plus ones whose largest pivot is each of the trace
    and the three diagonal terms (the negative-trace branches): within
    1e-6, and the quaternion maps back to the matrix."""
    rng = np.random.RandomState(0)
    q = rng.randn(64, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    R = np.asarray(jso3.quat_to_matrix(jnp.asarray(q, jnp.float32)))
    special = np.asarray([np.diag(d) for d in
                          ([1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1])],
                         np.float32)
    R = np.concatenate([R, special]).astype(np.float32)
    tr_ = np.trace(R, axis1=1, axis2=2)
    piv = np.stack([tr_, R[:, 0, 0] - R[:, 1, 1] - R[:, 2, 2],
                    R[:, 1, 1] - R[:, 0, 0] - R[:, 2, 2],
                    R[:, 2, 2] - R[:, 0, 0] - R[:, 1, 1]], 1)
    assert set(np.argmax(piv, 1)) == {0, 1, 2, 3}
    qj = np.asarray(jso3.matrix_to_quat(jnp.asarray(R)))
    qt = tso3.matrix_to_quat(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(qt, qj, atol=1e-6)
    back = tso3.quat_to_matrix(torch.from_numpy(qt)).numpy()
    np.testing.assert_allclose(back, R, atol=1e-5)

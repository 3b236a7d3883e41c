"""The FAST kernel's contract and work count, on the CPU.

The CUDA kernel (``coebslam_tpu_torch/csrc/fast.cu``) skips every tile
that starts at row >= h + 3 or column >= w + 3 of its level and writes 0
there. That is right because, on a canvas that is zero beyond each level's
extent, the function is exactly 0 there: these tests hold that for the
port's plain version and for the JAX package's Pallas kernel (interpreted),
on the extractor's canvas, on one built by hand and on the edge cases that
``chip_smoke.py`` runs on the card. They also pin ``fast_cuda.work``, the
bytes and operations that the kernel's bound is computed from.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from chip_smoke import FAST_EDGE_CASES, fast_edge_cases
from coebslam_tpu.config import SystemConfig as JaxSystemConfig
from coebslam_tpu.ops import fast_pallas
from coebslam_tpu.utils import synthetic as jsyn
from coebslam_tpu_torch.config import OrbConfig
from coebslam_tpu_torch.ops import extractor, fast, fast_cuda, pyramid

torch.set_num_threads(1)

THR = 10.0


@pytest.fixture(scope="module")
def crop():
    """A 96x128 crop of a rendered frame, [0, 255] float32."""
    cfg = JaxSystemConfig()
    planes = jsyn.make_room(seed=0)
    pose = jsyn.camera_trajectory(10, radius=0.35)[3]
    g = jsyn.render(cfg.camera, pose, planes, None, 0)[0]
    return np.clip(np.asarray(g), 0, 255).astype(np.float32)[:96, :128]


def _canvas(source, crop):
    """(canvas [L, H, W] f32, hw [L, 2] i32) on the CPU."""
    if source == "level_canvas":
        return extractor.level_canvas(torch.from_numpy(crop),
                                      OrbConfig(n_levels=3))
    if source == "by_hand":
        exts = [(96, 128), (80, 107), (67, 89)]
        canvas = np.zeros((3, 96, 128), np.float32)
        for l, (h, w) in enumerate(exts):
            canvas[l, :h, :w] = crop[:h, :w]
        return torch.from_numpy(canvas), torch.tensor(exts, dtype=torch.int32)
    return {n: (c, e) for n, c, e in fast_edge_cases(torch, "cpu")}[source]


@pytest.mark.parametrize(
    "source", ["level_canvas", "by_hand"] + [c[0] for c in FAST_EDGE_CASES])
def test_outputs_are_zero_beyond_extent_plus_3(crop, source):
    canvas, hw = _canvas(source, crop)
    L, H, W = canvas.shape
    st, sc = fast_cuda.strength_and_score(canvas, torch.tensor(THR), hw)
    row = torch.arange(H)[:, None]
    col = torch.arange(W)[None, :]
    n_dead = 0
    for l, (h, w) in enumerate(hw.tolist()):
        # The contract the skip rests on: zero beyond the extent.
        assert not canvas[l][(row >= h) | (col >= w)].any()
        dead = (row >= h + 3) | (col >= w + 3)
        n_dead += int(dead.sum())
        assert not st[l][dead].any() and not sc[l][dead].any()
        st_j, sc_j = fast_pallas.strength_and_score(
            jnp.asarray(canvas[l].numpy()), THR, true_h=h, true_w=w,
            interpret=True)
        st_j, sc_j = np.asarray(st_j), np.asarray(sc_j)
        assert not st_j[dead.numpy()].any() and not sc_j[dead.numpy()].any()
        np.testing.assert_array_equal(st[l].numpy(), st_j)
        np.testing.assert_array_equal(sc[l].numpy(), sc_j)
    assert n_dead > 0 and (st != 0).any()


def test_work_of_the_main_path():
    """[8, 480, 640] with the default pyramid's extents: 950,532 live
    pixels read once (3,802,128 bytes), two 2,457,600-px outputs written
    once (19,660,800 bytes)."""
    shapes = pyramid.pyramid_shapes(480, 640, 8, OrbConfig().scale_factor)
    assert sum(h * w for h, w in shapes) == 950_532
    assert fast_cuda.FAST_OPS_PER_PIXEL == 97
    assert fast_cuda.work(shapes, 8, 480, 640) == (23_462_928, 92_201_604)


def test_work_of_a_small_canvas():
    """Two levels of 10x12 and 8x10 in a [2, 10, 12] canvas: 200 live
    pixels, 4 * 200 + 8 * 240 bytes."""
    assert fast_cuda.work([(10, 12), (8, 10)], 2, 10, 12) == (2_720, 19_400)

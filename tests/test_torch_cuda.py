"""Tests of the port that need an NVIDIA GPU: its CUDA kernels against
their plain PyTorch versions, on the card. Without a card they skip.

They import neither JAX nor the JAX package, so they also run on a machine
that has only PyTorch (``--noconftest`` skips the JAX set-up of
``tests/conftest.py``):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import ctypes

import numpy as np
import pytest
import torch

from chip_smoke import FAST_EDGE_CASES, fast_edge_cases
from coebslam_tpu_torch.config import SystemConfig
from coebslam_tpu_torch.ops import extractor, fast, fast_cuda
from coebslam_tpu_torch.utils import synthetic

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def frame(card):
    cfg = SystemConfig()
    planes = synthetic.make_room(seed=0, device=card)
    pose = synthetic.camera_trajectory(10, radius=0.35)[3]
    return torch.clamp(synthetic.render(cfg.camera, pose, planes)[0], 0, 255)


def test_fast_kernel_matches_plain(card, frame):
    """Exact: score and (zero-padded) strength bit-equal to the plain
    version, on the 8-level canvas of a rendered frame and on a random
    image whose size is no multiple of the tile."""
    g = torch.Generator(device=card).manual_seed(3)
    rnd = torch.rand((1, 123, 161), generator=g, device=card) * 255
    cases = [extractor.level_canvas(frame, SystemConfig().orb),
             (rnd, torch.tensor([[123, 161]], dtype=torch.int32,
                                device=card))]
    for canvas, hw in cases:
        for thr in (7.0, 10.0):
            t = torch.tensor(thr, device=card)
            st_k, sc_k = fast_cuda.strength_and_score(canvas, t, hw)
            st_p, sc_p = fast.strength_and_score_plain(canvas, t, hw)
            torch.cuda.synchronize()
            assert torch.equal(sc_k, sc_p) and torch.equal(st_k, st_p)
            assert int((sc_k > 0).sum()) > 100


@pytest.mark.parametrize("name", [c[0] for c in FAST_EDGE_CASES])
def test_fast_kernel_tile_edges(card, name):
    """Bit-equal over the whole canvas where the kernel's tiles, its dead-
    tile skip, its 4-byte path (W % 4 != 0) and NMS ties meet edges."""
    canvas, hw = {n: (c, e) for n, c, e in fast_edge_cases(torch, card)}[name]
    for thr in (7.0, 10.0):
        t = torch.tensor(thr, device=card)
        st_k, sc_k = fast_cuda.strength_and_score(canvas, t, hw)
        st_p, sc_p = fast.strength_and_score_plain(canvas, t, hw)
        torch.cuda.synchronize()
        assert torch.equal(sc_k, sc_p) and torch.equal(st_k, st_p)
        assert int((sc_k > 0).sum()) > 100


def test_fast_kernel_unaligned_canvas(card, frame):
    """A contiguous canvas 4 bytes off 16-byte alignment takes the 4-byte
    path though W % 4 == 0, with the same values."""
    canvas, hw = extractor.level_canvas(frame, SystemConfig().orb)
    flat = torch.zeros(canvas.numel() + 1, device=card)
    shifted = flat[1:].view(canvas.shape)
    shifted.copy_(canvas)
    assert shifted.data_ptr() % 16 != 0
    t = torch.tensor(7.0, device=card)
    st_k, sc_k = fast_cuda.strength_and_score(shifted, t, hw)
    st_p, sc_p = fast.strength_and_score_plain(canvas, t, hw)
    torch.cuda.synchronize()
    assert torch.equal(sc_k, sc_p) and torch.equal(st_k, st_p)


def test_fast_timeline_build_matches_plain(card, frame):
    """The ``-DFAST_TIMELINE`` build that ``fast_timeline.py`` runs gives
    the same values, and every block with a live tile stamps its phases
    in order."""
    lib = fast_cuda.load(fast_cuda.build(defines=("FAST_TIMELINE",)))
    lib.coebslam_fast_timeline.argtypes = [ctypes.c_void_p]
    stamps = np.zeros((4096, 7), np.uint64)
    assert lib.coebslam_fast_timeline(stamps.ctypes.data) == 0   # clears
    canvas, hw = extractor.level_canvas(frame, SystemConfig().orb)
    t = torch.tensor(7.0, device=card)
    st_k, sc_k = fast_cuda.run(lib, canvas, t, hw)
    st_p, sc_p = fast.strength_and_score_plain(canvas, t, hw)
    assert lib.coebslam_fast_timeline(stamps.ctypes.data) == 0
    assert torch.equal(sc_k, sc_p) and torch.equal(st_k, st_p)
    live = stamps[stamps[:, 2] > 0, :5].astype(np.int64)
    assert len(live) > 100 and (np.diff(live, axis=1) >= 0).all()


def test_fast_wrapper_counts_launches_and_checks_inputs(card, frame):
    canvas, hw = extractor.level_canvas(frame, SystemConfig().orb)
    thr = torch.tensor(7.0, device=card)
    n0 = fast_cuda.LAUNCHES
    fast_cuda.strength_and_score(canvas, thr, hw)
    assert fast_cuda.LAUNCHES == n0 + 1
    with pytest.raises(ValueError):
        fast_cuda.strength_and_score(canvas.double(), thr, hw)
    with pytest.raises(ValueError):
        fast_cuda.strength_and_score(canvas, thr, hw.long())
    with pytest.raises(ValueError):
        fast_cuda.strength_and_score(canvas, thr.cpu(), hw)
    L = fast_cuda.MAX_LEVELS + 1
    with pytest.raises(ValueError):
        fast_cuda.strength_and_score(
            torch.zeros((L, 8, 8), device=card), thr,
            torch.full((L, 2), 8, dtype=torch.int32, device=card))
    assert fast_cuda.LAUNCHES == n0 + 1


def test_extract_kernel_path_matches_plain(card, frame, monkeypatch):
    """The extractor through the kernel and through the plain FAST: valid
    equal, uv within 1e-4, descriptors bit-equal."""
    cfg = SystemConfig()
    mask = torch.zeros((cfg.camera.height, cfg.camera.width),
                       dtype=torch.bool, device=card)
    mask[:, :200] = True
    for area in (False, True):
        kw = dict(dynamic_mask=mask, area_mode=torch.tensor(area, device=card))
        fk = extractor.extract(frame, cfg.orb, **kw)
        with monkeypatch.context() as m:
            m.setattr(fast_cuda, "strength_and_score",
                      fast.strength_and_score_plain)
            fp = extractor.extract(frame, cfg.orb, **kw)
        assert torch.equal(fk.valid, fp.valid) and int(fk.valid.sum()) > 500
        assert float((fk.uv - fp.uv).abs().max()) <= 1e-4
        assert torch.equal(fk.desc, fp.desc)

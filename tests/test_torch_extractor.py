"""Parity of the port's front-end (pyramid, FAST, grid selection,
extraction, RGB-D frame) with the JAX package on the CPU.

The port's FAST wrapper runs its plain version for CPU tensors; the CUDA
kernel itself is compared with that plain version on the card by
``tests/test_torch_cuda.py`` (skipped without a card) and by
``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from coebslam_tpu import config as jcfg
from coebslam_tpu.ops import extractor as jex, fast as jfast, \
    fast_pallas, grid_select as jgs, pyramid as jpyr
from coebslam_tpu.slam import frame as jframe
from coebslam_tpu.utils import synthetic as jsyn
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.ops import extractor as tex, fast as tfast, \
    fast_cuda, grid_select as tgs, pyramid as tpyr
from coebslam_tpu_torch.slam import frame as tframe
from test_features import checker_texture

torch.set_num_threads(1)

# Largest |difference| of the port's antialiased resize from
# jax.image.resize on [0, 255] images (two float32 products with another
# summation order); measured 3.4e-4 on the frames below.
RESIZE_BOUND = 1e-3


@pytest.fixture(scope="module")
def rendered():
    cfg = jcfg.SystemConfig()
    planes = jsyn.make_room(seed=0)
    pose = jsyn.camera_trajectory(10, radius=0.35)[3]
    g, d, _, _ = jsyn.render(cfg.camera, pose, planes, None, 0)
    return (np.clip(np.asarray(g), 0, 255).astype(np.float32),
            np.asarray(d, np.float32))


@pytest.mark.parametrize("shape", [(400, 533), (333, 444), (100, 133),
                                   (600, 800)])
def test_resize_matches_jax_image_resize(rendered, shape):
    img = rendered[0]
    ref = np.asarray(jpyr.resize_bilinear(jnp.asarray(img), shape))
    out = tpyr.resize_bilinear(torch.from_numpy(img), shape).numpy()
    assert np.abs(out - ref).max() <= RESIZE_BOUND


def test_pyramid_levels_within_bound(rendered):
    img = rendered[0]
    jl = jpyr.build_pyramid(jnp.asarray(img), jcfg.OrbConfig())
    tl = tpyr.build_pyramid(torch.from_numpy(img), tcfg.OrbConfig())
    assert [tuple(a.shape) for a in tl] == [tuple(a.shape) for a in jl]
    for a, b in zip(jl, tl):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= RESIZE_BOUND
    blur_j = np.asarray(jpyr.gaussian_blur(jl[2]))
    blur_t = tpyr.gaussian_blur(tl[2]).numpy()
    assert np.abs(blur_j - blur_t).max() <= RESIZE_BOUND


@pytest.mark.parametrize("thr", [7.0, 10.0, 20.0])
def test_fast_plain_matches_pallas_and_jnp(rendered, thr):
    """Exact: scores bit-equal everywhere, strength equal in the interior
    (the jnp oracle edge-pads, the kernel zero-pads)."""
    rng = np.random.RandomState(3)
    for img in ((rng.rand(123, 161) * 255).astype(np.float32),
                rendered[0][:200, :300]):
        h, w = img.shape
        st_p, sc_p = fast_pallas.strength_and_score(jnp.asarray(img), thr,
                                                    interpret=True)
        sc_j = jfast.nms_3x3(jfast.fast_score_map(jnp.asarray(img), thr))
        st_j = jfast.strength_map(jnp.asarray(img))
        hw = torch.tensor([[h, w]], dtype=torch.int32)
        st_t, sc_t = fast_cuda.strength_and_score(
            torch.from_numpy(img)[None], torch.tensor(thr), hw)
        np.testing.assert_array_equal(sc_t[0].numpy(), np.asarray(sc_p))
        np.testing.assert_array_equal(sc_t[0].numpy(), np.asarray(sc_j))
        np.testing.assert_array_equal(st_t[0].numpy(), np.asarray(st_p))
        np.testing.assert_array_equal(st_t[0].numpy()[4:-4, 4:-4],
                                      np.asarray(st_j)[4:-4, 4:-4])
        np.testing.assert_array_equal(
            tfast.strength_map(torch.from_numpy(img)).numpy(),
            np.asarray(st_j))


def test_fast_canvas_levels_match_pallas(rendered):
    """A [L, H, W] canvas with smaller true extents per level (the
    extractor's layout) against the Pallas kernel, level by level."""
    base = rendered[0][:96, :128]
    exts = [(96, 128), (80, 107), (67, 89)]
    canvas = np.zeros((3, 96, 128), np.float32)
    for l, (h, w) in enumerate(exts):
        canvas[l, :h, :w] = base[:h, :w]
    hw = torch.tensor(exts, dtype=torch.int32)
    st_t, sc_t = fast_cuda.strength_and_score(torch.from_numpy(canvas),
                                              torch.tensor(10.0), hw)
    for l, (h, w) in enumerate(exts):
        st_p, sc_p = fast_pallas.strength_and_score(
            jnp.asarray(canvas[l]), 10.0, true_h=h, true_w=w, interpret=True)
        np.testing.assert_array_equal(sc_t[l].numpy(), np.asarray(sc_p))
        np.testing.assert_array_equal(st_t[l].numpy(), np.asarray(st_p))


def test_grid_select_ties_lowest_index_first():
    """Integer scores with many ties: the same cells, slots and order."""
    rng = np.random.RandomState(4)
    score = rng.randint(0, 4, size=(2, 70, 100)).astype(np.float32) * 5.0
    score[:, 10:30, 20:60] = 15.0              # one large plateau
    for n_out in (50, 300, 2000):
        for l in range(2):
            yj, sj, vj = jgs.select_grid_topk(jnp.asarray(score[l]), 32, 8,
                                              n_out)
            yt, st, vt = tgs.select_grid_topk(torch.from_numpy(score), 32, 8,
                                              n_out)
            np.testing.assert_array_equal(yt[l].numpy(), np.asarray(yj))
            np.testing.assert_array_equal(st[l].numpy(), np.asarray(sj))
            np.testing.assert_array_equal(vt[l].numpy(), np.asarray(vj))


def _jit_extract(cfg):
    return jax.jit(lambda img, mask, area: jex.extract(
        img, cfg, dynamic_mask=mask, area_mode=area))


def _compare(fj, ft):
    """(valid equal, max |uv| diff on valid slots, share of slots with
    identical validity, uv within 1e-4 and identical descriptor)."""
    vj, vt = np.asarray(fj.valid), ft.valid.numpy()
    uv_d = np.abs(np.asarray(fj.uv) - ft.uv.numpy()).max(1)
    desc_eq = (np.asarray(fj.desc) == ft.desc.numpy()).all(1)
    same = (vj == vt) & (uv_d <= 1e-4) & desc_eq
    used = vj | vt
    return (vj == vt).all(), uv_d[vj & vt].max(initial=0.0), \
        same[used].mean(), desc_eq[vj & vt].all()


@pytest.mark.parametrize("source", ["checker", "rendered"])
def test_extract_single_level_identical(rendered, source):
    """n_levels=1: valid equal, uv within 1e-4, descriptors of valid slots
    bit-equal — with the dynamic mask and area mode on and off."""
    img = checker_texture(h=120, w=160, seed=5) if source == "checker" \
        else rendered[0]
    h, w = img.shape
    mask = np.zeros((h, w), bool)
    mask[:, : w // 3] = True
    jo = jcfg.OrbConfig(n_levels=1, max_keypoints=1024, use_pallas_fast=False)
    to = tcfg.OrbConfig(n_levels=1, max_keypoints=1024)
    run = _jit_extract(jo)
    for m in (None, mask):
        for area in (False, True):
            fj = run(jnp.asarray(img), None if m is None else jnp.asarray(m),
                     jnp.bool_(area))
            ft = tex.extract(torch.from_numpy(img), to,
                             dynamic_mask=None if m is None
                             else torch.from_numpy(m),
                             area_mode=torch.tensor(area))
            valid_eq, uv_err, share, desc_eq = _compare(fj, ft)
            assert valid_eq and uv_err <= 1e-4 and desc_eq
            assert share == 1.0


@pytest.mark.parametrize("source", ["checker", "rendered"])
def test_extract_full_pyramid_slots_agree(rendered, source):
    """8 levels: upper levels differ by the resize bound, which can reorder
    near-tied candidates; at least 99% of the used slots are identical
    (measured: 100% on the rendered frame, 99.2% on the checker)."""
    img = checker_texture(h=120, w=160, seed=5) if source == "checker" \
        else rendered[0]
    h, w = img.shape
    mask = np.zeros((h, w), bool)
    mask[:, : w // 3] = True
    jo = jcfg.OrbConfig(use_pallas_fast=False)
    run = _jit_extract(jo)
    for area in (False, True):
        fj = run(jnp.asarray(img), jnp.asarray(mask), jnp.bool_(area))
        ft = tex.extract(torch.from_numpy(img), tcfg.OrbConfig(),
                         dynamic_mask=torch.from_numpy(mask),
                         area_mode=torch.tensor(area))
        _, _, share, _ = _compare(fj, ft)
        assert share >= 0.99, share


def test_process_rgbd_matches(rendered):
    """The RGB-D frame constructor on top of identical features: depth, ur,
    weights and observations equal (full pyramid, rendered frame)."""
    g, d = rendered
    jc, tc = jcfg.SystemConfig(), tcfg.SystemConfig()
    fdj = jax.jit(lambda a, b: jframe.process_rgbd(a, b, jc.camera, jc.orb))(
        jnp.asarray(g), jnp.asarray(d))
    fdt = tframe.process_rgbd(torch.from_numpy(g), torch.from_numpy(d),
                              tc.camera, tc.orb)
    same = np.asarray(fdj.feats.valid) & fdt.feats.valid.numpy() \
        & (np.abs(np.asarray(fdj.feats.uv) - fdt.feats.uv.numpy()).max(1)
           <= 1e-4)
    assert same.sum() >= 0.99 * np.asarray(fdj.feats.valid).sum()
    np.testing.assert_allclose(fdt.depth.numpy()[same],
                               np.asarray(fdj.depth)[same], rtol=1e-6)
    np.testing.assert_allclose(fdt.obs.numpy()[same],
                               np.asarray(fdj.obs)[same], atol=1e-3)
    np.testing.assert_allclose(fdt.inv_sigma2.numpy(),
                               np.asarray(fdj.inv_sigma2), rtol=1e-6)

"""Tests of the port that need an NVIDIA GPU: its CUDA kernels against
their plain PyTorch versions, and the maintenance program, the detector,
the global BA, the stereo frame, the two-view initializer, the host
System, RANSAC EPnP, the Sim3 refinement, the LK flow motion check, the
blur metrics and the Shi-Tomasi response, and
the entry step against their CPU runs, the multi-device dry run over two
ranks sharing the card, and detector training, on the card. Without a
card they skip.

They import neither JAX nor the JAX package, so they also run on a machine
that has only PyTorch (``--noconftest`` skips the JAX set-up of
``tests/conftest.py``):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import ctypes
import pathlib

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


# --------------------------------------------------------------------- #
# the maintenance program on the card against the CPU
# --------------------------------------------------------------------- #

MAINT_CAM = dict(width=320, height=240, fx=267.7, fy=269.6, cx=160.05,
                 cy=123.8)
MAINT_LIM = dict(max_kf=8, spawn_per_kf=256, ba_window=4, local_window=3,
                 max_frames=64, seed_slots=64, bank_cap=16,
                 bank_landmarks=64)


@pytest.fixture(scope="module")
def maint_session(card):
    """A CPU session of the 320x240 room out along the orbit and back to
    its first pose (as in tests/test_torch_maintenance.py), its keyframes
    BoW-processed, then marked lost."""
    from coebslam_tpu_torch.config import CameraConfig, OrbConfig, \
        TrackingConfig
    from coebslam_tpu_torch.slam import maintenance as tm, realtime as trt, \
        vocabulary as tvoc
    cfg = SystemConfig(camera=CameraConfig(**MAINT_CAM),
                       orb=OrbConfig(n_levels=4, max_keypoints=1024),
                       tracking=TrackingConfig(max_frames_between_kf=3))
    lim = trt.RTLimits(**MAINT_LIM)
    voc = tvoc.load(str(pathlib.Path(__file__).resolve().parents[1]
                        / "artifacts" / "vocab_1e5.npz"))
    planes = synthetic.make_room(seed=0, device="cpu")
    poses = synthetic.camera_trajectory(40, radius=0.35)
    rt = trt.RealtimeSlam(cfg, lim, device="cpu")
    for k, i in enumerate((0, 2, 4, 6, 8, 10, 12, 14, 12, 10, 8, 6, 4, 2,
                           0)):
        g, d = synthetic.render(cfg.camera, poses[i], planes)[:2]
        rt.track(torch.clamp(g, 0, 255).to(torch.uint8),
                 (d * cfg.camera.depth_map_factor).to(torch.int32), k / 30.0)
    maint = tm.Maintainer(cfg, lim, voc, device="cpu")
    st, ms = maint.step(rt.state, maint.init_state(), 0,
                        n_kf=int(rt.state.n_kf), bow_next=0,
                        sampler=_fixed_sampler)
    st = st._replace(n_lost=torch.full_like(st.n_lost, tm.RELOC_AFTER_LOST),
                     track=st.track._replace(ok=torch.zeros_like(
                         st.track.ok)))
    return cfg, lim, voc, st, ms


def _fixed_sampler(tag, valid):
    """Draws that depend only on the tag and the valid mask, made on the
    CPU, so the card and the CPU solve from the same hypotheses."""
    from coebslam_tpu_torch.ops.fundamental import sample_indices
    g = torch.Generator().manual_seed(sum(map(ord, repr(tag))))
    return sample_indices(valid.cpu(), 256, g, k=3)


def _to(tree, dev):
    return torch.utils._pytree.tree_map(lambda x: x.to(dev), tree)


def _assert_maint_close(a, b):
    """Equal decisions and integer state; floats within 1e-4 (points
    within 1e-3 where valid on both)."""
    for x, y in zip(torch.utils._pytree.tree_leaves(a),
                    torch.utils._pytree.tree_leaves(b)):
        x, y = x.cpu(), y.cpu()
        if x.dtype.is_floating_point:
            if x.dim() == 2 and x.shape[-1] == 3 and x.shape[0] > 1000:
                continue                      # points: checked below
            assert torch.allclose(x, y, atol=1e-4), (x - y).abs().max()
        else:
            assert torch.equal(x, y)
    both = a[0].pt_valid.cpu() & b[0].pt_valid.cpu()
    assert (a[0].pt_pos.cpu()[both] - b[0].pt_pos.cpu()[both]).abs().max() \
        <= 1e-3


def test_maintenance_step_on_card_matches_cpu(card, maint_session):
    """One dispatch on the lost state (ring relocalization), and a ring
    closure of the newest keyframe against the first, on the card and on
    the CPU from the same state and draws."""
    from coebslam_tpu_torch.slam import maintenance as tm
    cfg, lim, voc, st, ms = maint_session
    n_kf = int(st.n_kf)
    outs = []
    for dev in ("cpu", card):
        maint = tm.Maintainer(cfg, lim, voc, device=dev)
        s, m = _to(st, dev), _to(ms, dev)
        r = maint.step(s, m, 1, n_kf=n_kf, bow_next=n_kf,
                       sampler=_fixed_sampler)
        c = tm._close_loop(
            s._replace(track=s.track._replace(ok=torch.ones_like(
                s.track.ok))), m, n_kf - 1,
            torch.zeros((), dtype=torch.int64, device=dev),
            torch.full((), 0.5, device=dev), cfg, lim,
            lambda valid: _fixed_sampler(("loop", n_kf - 1), valid).to(
                valid.device))
        outs.append((r, c))
    (r_cpu, c_cpu), (r_gpu, c_gpu) = outs
    assert int(r_cpu[1].n_reloc) == 1 and int(c_cpu[1].n_loops) == 1
    _assert_maint_close(r_cpu, r_gpu)
    _assert_maint_close(c_cpu, c_gpu)


# --------------------------------------------------------------------- #
# the detector and the global BA on the card against the CPU
# --------------------------------------------------------------------- #

def test_detect_device_on_card_matches_cpu(card, frame):
    """Full-width yolov5s (seeded random weights calibrated on the frame)
    and the walker detector: raw heads within rtol 1e-3 / atol 1e-3 (cuDNN
    sums in another order), the padded device boxes of the walker detector
    likewise."""
    from chip_smoke import walker_detector
    from coebslam_tpu_torch import config
    from coebslam_tpu_torch.models import detector as tdet, yolov5
    gray = frame.to(torch.uint8)
    dyn = SystemConfig().dynamic
    full = config.DetectorConfig()
    weights = yolov5.init_random(
        yolov5.YoloV5s(), torch.Generator().manual_seed(0),
        calib=tdet.preprocess(gray.cpu(), full.input_size)).state_dict()
    makers = (lambda d: tdet.YoloDetector(full, dyn, variables=weights,
                                          device=d),
              lambda d: walker_detector(config, tdet, dyn, device=d))
    for make in makers:
        on_cpu, on_card = make("cpu"), make(card)
        for a, b in zip(on_card.heads(gray), on_cpu.heads(gray.cpu())):
            assert torch.allclose(a.cpu(), b, rtol=1e-3, atol=1e-3), \
                (a.cpu() - b).abs().max()
    boxes = on_card.detect_device(gray).cpu()
    ref = on_cpu.detect_device(gray.cpu())
    assert torch.equal(boxes >= 0, ref >= 0)
    assert torch.allclose(boxes, ref, rtol=1e-3, atol=1e-3)


def test_global_ba_on_card_matches_cpu(card):
    """One GlobalBA.run on the arena of a short CPU session, on the card
    and on the CPU: poses within 1e-4, points within 1e-3."""
    from coebslam_tpu_torch.config import CameraConfig, OrbConfig, \
        TrackingConfig
    from coebslam_tpu_torch.slam import handoff, realtime as trt
    from coebslam_tpu_torch.slam.global_ba import GlobalBA
    cfg = SystemConfig(camera=CameraConfig(**MAINT_CAM),
                       orb=OrbConfig(n_levels=4, max_keypoints=1024),
                       tracking=TrackingConfig(max_frames_between_kf=3))
    planes = synthetic.make_room(seed=0, device="cpu")
    poses = synthetic.camera_trajectory(36, radius=0.35)
    rt = trt.RealtimeSlam(cfg, trt.RTLimits(max_kf=16, local_window=6,
                                            ba_window=6, max_frames=64),
                          device="cpu")
    for i in range(12):
        g, d = synthetic.render(cfg.camera, poses[i], planes)[:2]
        rt.track(torch.clamp(g, 0, 255).to(torch.uint8),
                 (d * cfg.camera.depth_map_factor).to(torch.int32), i / 30.0)
    res = rt.finish()
    arenas = []
    for dev in ("cpu", card):
        m, kf_ids = handoff.to_arena(res, cfg)
        assert GlobalBA(cfg, device=dev).run(m) == len(kf_ids) >= 3
        arenas.append(m)
    a, b = arenas
    kf, pts = a.valid_keyframes(), a.valid_points()
    np.testing.assert_allclose(b.kf_R[kf], a.kf_R[kf], atol=1e-4)
    np.testing.assert_allclose(b.kf_t[kf], a.kf_t[kf], atol=1e-4)
    np.testing.assert_allclose(b.pt_pos[pts], a.pt_pos[pts], atol=1e-3)


# --------------------------------------------------------------------- #
# the stereo frame and the two-view initializer on the card against the CPU
# --------------------------------------------------------------------- #

def test_process_stereo_on_card_matches_cpu(card):
    """A full-width wide-baseline stereo pair: the FAST kernel runs on both
    images (two launches), and features, matches and depth agree with the
    CPU run: valid equal, uv within 1e-4, descriptors bit-equal on
    >= 99.5 % of keypoints (orientations may differ in their last bits),
    match validity equal on >= 99.5 %, depth within 1e-4 relative where
    both matched."""
    from coebslam_tpu_torch.config import CameraConfig
    from coebslam_tpu_torch.geometry.se3 import SE3
    from coebslam_tpu_torch.slam import frame as tframe
    cfg = SystemConfig(camera=CameraConfig(bf=160.0), sensor="stereo")
    planes = synthetic.make_room(seed=0, device=card)
    pose = synthetic.camera_trajectory(30)[0]
    shift = torch.tensor([cfg.camera.baseline, 0.0, 0.0])
    gl = synthetic.render(cfg.camera, pose, planes)[0]
    gr = synthetic.render(cfg.camera, SE3(pose.R, pose.t - shift), planes)[0]
    n0 = fast_cuda.LAUNCHES
    fk = tframe.process_stereo(gl, gr, cfg.camera, cfg.orb)
    torch.cuda.synchronize()
    assert fast_cuda.LAUNCHES == n0 + 2
    fc = tframe.process_stereo(gl.cpu(), gr.cpu(), cfg.camera, cfg.orb)
    v = fc.feats.valid
    assert torch.equal(fk.feats.valid.cpu(), v)
    assert float((fk.feats.uv.cpu() - fc.feats.uv)[v].abs().max()) <= 1e-4
    same = (fk.feats.desc.cpu() == fc.feats.desc).all(1)
    assert float(same[v].float().mean()) >= 0.995
    mk, mc = fk.depth.cpu() > 0, fc.depth > 0
    assert int(mc.sum()) > 300
    assert float((mk == mc).float().mean()) >= 0.995
    both = mk & mc
    assert torch.allclose(fk.depth.cpu()[both], fc.depth[both], rtol=1e-4)


def _two_view(seed, planar):
    """Points in front of camera 1 (on z = 4 when planar), camera 2 at a
    fixed small motion, 0.3 px noise, from a numpy seed (as
    tests/test_torch_mono.py's scenes)."""
    from coebslam_tpu_torch.geometry import se3
    cam = SystemConfig().camera
    rng = np.random.RandomState(seed)
    n = 300
    z = np.full(n, 4.0) if planar else rng.uniform(2.5, 7.0, n)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), z],
                 -1).astype(np.float32)
    T2 = se3.exp(torch.tensor([0.02, -0.04, 0.01, 0.3, 0.05, 0.02]))
    X2 = X @ T2.R.numpy().T + T2.t.numpy()
    proj = lambda P: np.stack([cam.fx * P[:, 0] / P[:, 2] + cam.cx,
                               cam.fy * P[:, 1] / P[:, 2] + cam.cy], -1)
    noise = 0.3 * rng.randn(n, 2)
    uv1, uv2 = proj(X), proj(X2)
    inb = ((uv1 > 5) & (uv1 < [635.0, 475.0])).all(1) \
        & ((uv2 > 5) & (uv2 < [635.0, 475.0])).all(1)
    return (torch.from_numpy((uv1 + noise).astype(np.float32)),
            torch.from_numpy((uv2 + noise).astype(np.float32)),
            torch.from_numpy(inb), cam)


@pytest.mark.parametrize("planar", [False, True], ids=["general", "planar"])
def test_reconstruct_graph_on_card_matches_cpu(card, planar):
    """The two-view initializer with the same draws on the card and the
    CPU. The batched wide [8, 9] gesvd gives each hypothesis' null space to
    the float32 conditioning of the pixel-coordinate DLT (the median
    hypothesis within 1e-2 of the CPU's, scaled to H[2, 2] = 1). The model
    the RH rule picks scores within 1e-2 of the CPU's; the other within
    5e-2 (on the general scene the best of 200 poor homographies can be
    another one: 512.6 on the CPU, 4.4 % apart on the card). From the same
    models, motion recovery agrees within 1e-4 (R, t) with good sets equal
    on >= 99 %; the whole initializer on the card picks the same model and
    R within 1e-2 of the CPU's."""
    from coebslam_tpu_torch.ops import fundamental, initializer_ops as ti
    uv1, uv2, inb, cam = _two_view(4 if planar else 0, planar)
    g = torch.Generator().manual_seed(1)
    idx_h = fundamental.sample_indices(inb, 200, g, k=4)
    idx_f = fundamental.sample_indices(inb, 200, g, k=8)
    H_cpu = ti._dlt_homography(uv1[idx_h], uv2[idx_h])
    H_gpu = ti._dlt_homography(uv1.to(card)[idx_h.to(card)],
                               uv2.to(card)[idx_h.to(card)]).cpu()
    norm = lambda H: H / H[:, 2:3, 2:3]
    rel = ((norm(H_gpu) - norm(H_cpu)).abs().amax((1, 2))
           / norm(H_cpu).abs().amax((1, 2)))
    assert float(rel.median()) <= 1e-2, float(rel.median())
    args = (uv1, uv2, inb)
    m_cpu = ti.fit_models(*args, idx_h, idx_f)
    m_gpu = ti.fit_models(*[x.to(card) for x in args], idx_h.to(card),
                          idx_f.to(card))
    for a, b, chosen in ((m_gpu.score_h, m_cpu.score_h, planar),
                         (m_gpu.score_f, m_cpu.score_f, not planar)):
        tol = 1e-2 if chosen else 5e-2
        assert abs(float(a) - float(b)) <= tol * abs(float(b)), (a, b)
    r_cpu = ti.recover_motion(m_cpu, uv1, uv2, cam)
    r_gpu = ti.recover_motion(_to(m_cpu, card), uv1.to(card), uv2.to(card),
                              cam)
    assert bool(r_gpu.used_homography) == bool(r_cpu.used_homography) \
        == planar
    assert bool(r_gpu.ok) and bool(r_cpu.ok)
    assert torch.allclose(r_gpu.R.cpu(), r_cpu.R, atol=1e-4)
    assert torch.allclose(r_gpu.t.cpu(), r_cpu.t, atol=1e-4)
    assert float((r_gpu.good.cpu() == r_cpu.good).float().mean()) >= 0.99
    full = ti.reconstruct_graph(uv1.to(card), uv2.to(card), inb.to(card),
                                cam, idx_h.to(card), idx_f.to(card))
    ref = ti.reconstruct_graph(uv1, uv2, inb, cam, idx_h, idx_f)
    assert bool(full.ok) and bool(full.used_homography) == planar
    assert torch.allclose(full.R.cpu(), ref.R, atol=1e-2)


def test_host_system_on_card_matches_cpu(card):
    """The host System (Tracker + LocalMapper) over the first 8 frames of
    the replica, with the walker's boxes, on the card and on the CPU with
    the same F-RANSAC draws: states and inlier counts equal, poses within
    1e-3, keyframe counts equal, one FAST launch per frame on the card."""
    from coebslam_tpu_torch.slam.system import System
    from coebslam_tpu_torch.utils import replica
    frames = list(replica.generate(n_frames=400, seed=0, frames=range(8),
                                   device=card))

    def sampler(seed, valid):
        g = torch.Generator().manual_seed(seed)
        return fast_draws(valid.cpu(), g)

    runs = {}
    for dev in ("cpu", card):
        sysm = System(SystemConfig(), device=dev, sampler=sampler)
        fast_cuda.LAUNCHES = 0
        out = [sysm.track_rgbd(f.gray, f.depth / replica.DEPTH_FACTOR,
                               f.stamp,
                               boxes=f.boxes if len(f.boxes) else None)
               for f in frames]
        runs[str(dev)] = (out, sysm, fast_cuda.LAUNCHES)
    (oc, sc, _), (og, sg, launches) = runs["cpu"], runs[str(card)]
    assert og == oc and launches == len(frames)
    assert sg.map.n_kf == sc.map.n_kf >= 2
    for (_, R1, t1), (_, R2, t2) in zip(sc.tracker.trajectory,
                                        sg.tracker.trajectory):
        np.testing.assert_allclose(R2, R1, atol=1e-3)
        np.testing.assert_allclose(t2, t1, atol=1e-3)


def fast_draws(valid, generator, n=256, k=8):
    """The same F-RANSAC sample indices on both devices (drawn on the
    CPU)."""
    from coebslam_tpu_torch.ops import fundamental
    return fundamental.sample_indices(valid, n, generator, k=k)


def test_epnp_and_sim3_on_card_match_cpu(card):
    """``ransac_epnp`` at the relocalizer's shapes (300 hypotheses of 6
    points, 2048 correspondences, 30 % outliers) with the same sample
    indices, and ``optimize_sim3`` on one two-view scene, on the card and
    on the CPU: inlier sets equal; EPnP's pose within ``EPNP_CARD_TOL``
    (cuSOLVER's float32 eigh against LAPACK's, measured 1.06e-4 in t; the
    pose, not the null-space basis), the Sim3 within 1e-4."""
    from host_bow_scenes import EPNP_CARD_TOL, pnp_scene
    from coebslam_tpu_torch.geometry import camera as cam_ops, sim3, so3
    from coebslam_tpu_torch.ops import fundamental, pnp
    from coebslam_tpu_torch.optim import sim3_opt
    cfg = SystemConfig()
    X, uv, R, t = pnp_scene(cfg.camera, 11, 2048, noise_px=0.3,
                            outlier_frac=0.3)
    valid = torch.ones(len(X), dtype=torch.bool)
    idx = fundamental.sample_indices(valid, 300, torch.Generator()
                                     .manual_seed(0), k=6)
    out = {}
    for dev in ("cpu", card):
        to = lambda a: torch.from_numpy(np.array(a)).to(dev)
        out[str(dev)] = pnp.ransac_epnp(to(X), to(uv), valid.to(dev),
                                        cfg.camera, idx.to(dev))
    c, g = out["cpu"], out[str(card)]
    assert torch.equal(g.inliers.cpu(), c.inliers)
    assert int(c.n_inliers) > 0.6 * len(X)
    np.testing.assert_allclose(g.R.cpu().numpy(), c.R.numpy(),
                               atol=EPNP_CARD_TOL)
    np.testing.assert_allclose(g.t.cpu().numpy(), c.t.numpy(),
                               atol=EPNP_CARD_TOL)

    rng = np.random.RandomState(2)
    X2 = rng.uniform([-2, -1.5, 2], [2, 1.5, 6], (300, 3)).astype(np.float32)
    S_gt = sim3.Sim3.from_se3(so3.exp(torch.tensor([0.05, 0.2, -0.03])),
                              torch.tensor([0.3, -0.1, 0.2]))
    X1 = S_gt.apply(torch.from_numpy(X2))
    uv1 = cam_ops.project(cfg.camera, X1) + 0.5 * torch.from_numpy(
        rng.randn(300, 2).astype(np.float32))
    uv2 = cam_ops.project(cfg.camera, torch.from_numpy(X2))
    S0 = sim3.exp(torch.tensor([0.02, -0.03, 0.01, 0.05, 0.05, -0.05,
                                0.0])).compose(S_gt)
    res = {}
    for dev in ("cpu", card):
        mv = lambda a: a.to(dev)
        res[str(dev)] = sim3_opt.optimize_sim3(
            sim3.Sim3(*map(mv, S0)), mv(X1), mv(torch.from_numpy(X2)),
            mv(uv1), mv(uv2), torch.ones(300, dtype=torch.bool,
                                         device=dev),
            cfg.camera, cfg.optimizer)
    c, g = res["cpu"], res[str(card)]
    assert torch.equal(g.inliers.cpu(), c.inliers) and int(c.n_inliers) > 250
    for a, b in zip(g.S12, c.S12):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4)


def test_lk_flow_and_dynamic_frontend_on_card_match_cpu(card):
    """The flow motion check at full width on a pair of the walker scene
    (host_sensor_scenes.py, frames 12 and 13): good_features and lk_flow
    on the card against the CPU (valid equal, corners within 1e-3 px,
    tracked points within 1e-2 px), and dynamic_frontend with the same
    F-RANSAC samples (drawn on the CPU): mask, box flags and T_M equal."""
    from host_sensor_scenes import (HOST_FLOW_ORBIT, HOST_FLOW_WALKER,
                                    host_flow_config)
    from coebslam_tpu_torch import config
    from coebslam_tpu_torch.ops import fundamental, lk_flow
    from coebslam_tpu_torch.slam import dynamic
    cfg = host_flow_config(config)
    planes = synthetic.make_room(seed=0, device=card)
    quad = synthetic.make_walker(**HOST_FLOW_WALKER, device=card)
    poses = synthetic.camera_trajectory(**HOST_FLOW_ORBIT)
    g0, _, _, _ = synthetic.render(cfg.camera, poses[12], planes, quad, 12)
    g1, _, b1, _ = synthetic.render(cfg.camera, poses[13], planes, quad, 13)
    boxes = torch.full((cfg.dynamic.max_boxes, 4), -1.0, device=card)
    boxes[0] = b1
    n = cfg.dynamic.n_flow_points
    (ug, vg), (uc, vc) = (lk_flow.good_features(g0.to(d), n)
                          for d in (card, "cpu"))
    assert torch.equal(vg.cpu(), vc) and int(vc.sum()) > 300
    assert float((ug.cpu() - uc).abs().max()) < 1e-3
    fg = lk_flow.lk_flow(lk_flow.build_flow_pyramid(g0),
                         lk_flow.build_flow_pyramid(g1), uc.to(card))
    fc = lk_flow.lk_flow(lk_flow.build_flow_pyramid(g0.cpu()),
                         lk_flow.build_flow_pyramid(g1.cpu()), uc)
    assert torch.equal(fg.valid.cpu(), fc.valid)
    ok = fc.valid & vc
    assert float((fg.points.cpu() - fc.points)[ok].abs().max()) < 1e-2

    def draw(valid):
        return fundamental.sample_indices(
            valid.cpu(), cfg.dynamic.f_ransac_iters,
            torch.Generator().manual_seed(0)).to(valid.device)

    rg = dynamic.dynamic_frontend(g0, g1, boxes, cfg, idx=draw)
    rc = dynamic.dynamic_frontend(g0.cpu(), g1.cpu(), boxes.cpu(), cfg,
                                  idx=draw)
    for f in ("mask", "area_flag", "box_dynamic", "box_blurred",
              "outlier_valid"):
        assert torch.equal(getattr(rg, f).cpu(), getattr(rc, f)), f
    assert int(rc.n_outliers) > 0


@pytest.mark.parametrize("metric", ["laplacian", "brenner", "tenengrad",
                                    "energy"])
def test_blur_metrics_and_min_eig_on_card_match_cpu(card, frame, metric):
    """The blur metrics' maps and box scores and the Shi-Tomasi response
    on the card against the CPU, on a rendered frame: maps and scores
    within 1e-5 relative (an absolute floor of 1e-5 x the map's largest
    magnitude), absent boxes +inf on both; good_features(use_harris=False)
    selects the same corners."""
    from coebslam_tpu_torch.ops import blur, lk_flow
    boxes = torch.tensor([[100.0, 80.0, 300.0, 400.0],
                          [-1.0, -1.0, -1.0, -1.0],
                          [350.0, 10.0, 639.0, 200.0]], device=card)
    fc = frame.cpu()
    maps = {"laplacian": blur.laplacian_map, "brenner": blur.brenner_map,
            "tenengrad": blur.tenengrad_map, "energy": blur.energy_map}
    pairs = [(maps[metric](frame), maps[metric](fc)),
             (lk_flow.min_eig_response(frame),
              lk_flow.min_eig_response(fc))]
    for g, c in pairs:
        torch.testing.assert_close(g.cpu(), c, rtol=1e-5,
                                   atol=1e-5 * float(c.abs().max()))
    sg = blur.box_blur_scores(frame, boxes, metric=metric).cpu()
    sc = blur.box_blur_scores(fc, boxes.cpu(), metric=metric)
    assert torch.isinf(sg[1]) and torch.isinf(sc[1])
    torch.testing.assert_close(sg[[0, 2]], sc[[0, 2]], rtol=1e-5, atol=0)
    (ug, vg), (uc, vc) = (lk_flow.good_features(frame.to(d), 500,
                                                use_harris=False)
                          for d in (card, "cpu"))
    assert torch.equal(vg.cpu(), vc) and int(vc.sum()) > 100
    assert float((ug.cpu() - uc)[vc].abs().max()) < 1e-3


def test_tum_rgbd_driver_on_card(card, tmp_path):
    """run_tum_rgbd's host mode on 5 replica frames that replica.write
    rendered on the card: every part of the System on the card, one FAST
    launch per frame, every frame tracked, the trajectory files written."""
    from coebslam_tpu_torch.examples import run_tum_rgbd
    from coebslam_tpu_torch.utils import replica
    root = str(tmp_path / "replica")
    replica.write(root, n_frames=400, seed=0, frames=range(5), device=card)
    fast_cuda.LAUNCHES = 0
    out = run_tum_rgbd.run(run_tum_rgbd.parse_args(
        [root, "--boxes", str(tmp_path / "replica" / "boxes.txt"),
         "--out", str(tmp_path / "out")]))
    assert fast_cuda.LAUNCHES == 5
    sysm = out["system"]
    assert out["device"] == "cuda"
    assert {sysm.device.type, sysm.tracker.device.type,
            sysm.mapper.device.type} == {"cuda"}
    assert out["states"] == ["OK"] * 5
    assert out["ate"]["rmse"] < 0.02
    rows = np.loadtxt(tmp_path / "out" / "CameraTrajectory.txt", ndmin=2)
    assert rows.shape == (5, 8)


# --------------------------------------------------------------------- #
# the entry step, the multi-device dry run and detector training
# --------------------------------------------------------------------- #

def test_entry_on_card_matches_cpu(card):
    """entry()'s fused front-end + track step on the card: one FAST
    launch; pose within 1e-4 and inliers within 1 of the CPU run."""
    from coebslam_tpu_torch import entry
    fn, args = entry.entry()
    fast_cuda.LAUNCHES = 0
    with torch.no_grad():
        R, t, n = fn(*args)
        torch.cuda.synchronize()
        assert fast_cuda.LAUNCHES == 1
        fn_c, args_c = entry.entry(device="cpu")
        R_c, t_c, n_c = fn_c(*args_c)
    assert torch.allclose(R.cpu(), R_c, atol=1e-4)
    assert torch.allclose(t.cpu(), t_c, atol=1e-4)
    assert abs(int(n) - int(n_c)) <= 1


def test_dryrun_multichip_two_ranks_on_one_card(card):
    """dryrun_multichip(2): two ranks share the card over gloo (NCCL
    refuses two ranks on one device); each rank's frame makes one FAST
    launch; (e)'s segment-sharded GBA equals the 1-D mesh's."""
    from coebslam_tpu_torch import entry
    out = entry.dryrun_multichip(2)
    assert out["backend"] == "gloo"
    assert out["frontend_launches"] == 2
    assert out["gba_gap"] <= 2e-3
    assert out["segments"] == [8000, 8000]


def test_train_detector_twenty_steps_on_card(card, tmp_path):
    """tools/train_detector on the card, 20 steps at width 0.25 on one
    40-frame sequence: finite losses that fall (mean of the last 5 below
    the first 5), and the file read back equal to the trained state."""
    from coebslam_tpu_torch.models import detector as tdet, yolov5
    from coebslam_tpu_torch.tools import train_detector
    path = str(tmp_path / "det.npz")
    out = train_detector.run(train_detector.parse_args(
        ["--width", "0.25", "--seqs", "1", "--frames", "40", "--steps",
         "20", "--out", path]))
    losses = np.asarray(out["losses"])
    assert out["device"] == "cuda" and np.isfinite(losses).all()
    assert losses[-5:].mean() < losses[:5].mean(), losses
    back = yolov5.from_flax_variables(tdet.load_variables_npz(path)[0])
    assert all(torch.equal(back[k], out["state_dict"][k]) for k in back)


def test_train_detector_runs_bit_equal_on_card(card, tmp_path):
    """Two runs of tools/train_detector on the card with the same
    arguments (deterministic by default: PyTorch's deterministic
    algorithms, cuDNN deterministic, TF32 off): every loss, every loss
    term and every trained weight equal, and the same held-out IoU."""
    from coebslam_tpu_torch.tools import train_detector
    outs = [train_detector.run(train_detector.parse_args(
        ["--width", "0.25", "--seqs", "1", "--frames", "40", "--steps",
         "30", "--out", str(tmp_path / f"det{k}.npz")])) for k in range(2)]
    a, b = outs
    assert a["device"] == b["device"] == "cuda"
    assert a["losses"] == b["losses"]
    np.testing.assert_array_equal(a["terms"], b["terms"])
    assert all(torch.equal(a["state_dict"][k], b["state_dict"][k])
               for k in a["state_dict"])
    assert a["miou"] == b["miou"]


def test_bank_closure_after_ring_wrap_on_card(card):
    """chip_smoke.py [19a] (rt_loop_scenes.py): the drifted circuit with an
    8-row ring and the scene's vocabulary trained on the card, and its
    odometry twin: tests/test_place_bank.py's gates, one FAST launch per
    frame."""
    from chip_smoke import _vocabulary_of
    from rt_loop_scenes import (BANK_LIMITS, BANK_VOCAB, bank_loop_failures,
                                bank_loop_summary, bank_vocab_frames,
                                circuit_config, loop_scene, run_realtime)
    from coebslam_tpu_torch import config
    from coebslam_tpu_torch.eval import ate
    from coebslam_tpu_torch.slam import vocabulary
    from coebslam_tpu_torch.slam.realtime import RealtimeSlam, RTLimits
    cfg = circuit_config(config)
    n_circ, n_over = synthetic.N_CIRCUIT, synthetic.N_OVERLAP
    frames, gt = loop_scene(card, range(n_circ + n_over),
                            synthetic.DEPTH_BIAS, synthetic, cfg.camera)
    voc = _vocabulary_of(extractor, vocabulary, cfg, frames,
                         bank_vocab_frames(n_circ), BANK_VOCAB)
    lim = RTLimits(**BANK_LIMITS)
    fast_cuda.LAUNCHES = 0
    res = run_realtime(RealtimeSlam(cfg, lim, vocabulary=voc,
                                    maintain_every=1), frames)
    res_odo = run_realtime(RealtimeSlam(cfg, lim, maintain_every=1), frames)
    assert fast_cuda.LAUNCHES == 2 * len(frames)
    s = bank_loop_summary(res, res_odo, gt, n_circ, n_over, ate)
    assert not bank_loop_failures(s, lim.max_kf), s


def test_epnp_recovery_on_card(card):
    """chip_smoke.py [21] (host_sensor_scenes.py): the monocular System at
    full width, frames 0-45 of the 1.2 m orbit, a blackout, frame 15: OK,
    LOST,
    OK within 15 cm, the return taken by the Relocalizer through EPnP
    (its RANSACs counted), one FAST launch per frame."""
    from chip_smoke import _vocabulary_of
    from host_bow_scenes import RELOC_ATTEMPTS, reloc_calls, watch_calls
    from host_sensor_scenes import (HOST_EPNP_RETURN, HOST_EPNP_TRACK,
                                    HOST_EPNP_VOCAB_FRAMES, HOST_MONO_BLACK,
                                    HOST_MONO_VOCAB, host_epnp_failures,
                                    host_epnp_frames, host_mono_config,
                                    run_host_mono)
    from coebslam_tpu_torch import config
    from coebslam_tpu_torch.eval import ate
    from coebslam_tpu_torch.slam import vocabulary
    from coebslam_tpu_torch.slam.system import System
    cfg = host_mono_config(config)
    frames, gt = host_epnp_frames(synthetic, cfg.camera, card)
    voc = _vocabulary_of(extractor, vocabulary, cfg, [(g,) for g in frames],
                         HOST_EPNP_VOCAB_FRAMES, HOST_MONO_VOCAB)
    sysm = System(cfg, vocabulary=voc)
    rec = watch_calls([], sysm.relocalizer,
                      RELOC_ATTEMPTS["port"] + ("relocalize",))
    mark = []
    fast_cuda.LAUNCHES = 0
    s = run_host_mono(sysm, frames, torch.zeros_like(frames[0]), gt, ate,
                      HOST_EPNP_RETURN,
                      before_return=lambda: mark.append(len(rec)))
    assert fast_cuda.LAUNCHES == HOST_EPNP_TRACK + HOST_MONO_BLACK + 1
    back = rec[mark[0]:]
    s["return_reloc"] = reloc_calls(back)
    s["return_pnp"] = sum("pnp" in r[0] for r in back)
    assert not host_epnp_failures(s), s

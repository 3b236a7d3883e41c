"""Parity of the port's host ``Tracker`` + ``LocalMapper`` (synchronous)
with the JAX package on the CPU, frame by frame on the static room of
``tests/test_tracking_e2e.py`` (its ``small_config``, radius 0.35): the
tracking mode, the inlier count and the keyframe ids are held equal,
poses within 1e-4, and the map arena by the rule of
``tests/test_torch_realtime.py::assert_states_close`` (points within 1e-3
where live in both, keypoints that tie in the extractor's slot order may
spawn into other rows; the frame's matched point ids equal on >= 99 % of
keypoints). The run covers the first keyframes, their
triangulation, fusion and local BA, and point culling.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax

from coebslam_tpu.slam.local_mapping import LocalMapper as JMapper
from coebslam_tpu.slam.tracking import Tracker as JTracker
from coebslam_tpu.utils import synthetic as jsyn
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.slam.local_mapping import LocalMapper as TMapper
from coebslam_tpu_torch.slam.tracking import Tracker as TTracker
from test_tracking_e2e import small_config

torch.set_num_threads(2)

N_FRAMES = 12


def room_frames(n, cfg, quad=None):
    """The tracking e2e scene (the room, radius 0.35): grey and float
    metres as the JAX renderer gives them, plus the quad's box."""
    planes = jsyn.make_room(seed=0)
    poses = jsyn.camera_trajectory(max(n, 30), radius=0.35)[:n]
    render = jax.jit(lambda p, i: jsyn.render(cfg.camera, p, planes, quad,
                                              i)[:3])
    out = []
    for i, p in enumerate(poses):
        g, d, b = render(p, i)
        out.append((np.asarray(g), np.asarray(d), np.asarray(b)))
    return out, poses


def _share(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


def assert_arenas_close(j, t, i):
    """Keyframes equal in number, validity and ids; poses within 1e-4;
    observations equal on >= 99 % of slots; live points equal on >= 99.5 %
    of rows and within 1e-3 where live in both, except that at most 1 % of
    them may sit at another reference point (slot-order ties)."""
    assert (t.n_kf, t.n_pt) == (j.n_kf, j.n_pt), i
    np.testing.assert_array_equal(t.kf_valid, j.kf_valid)
    np.testing.assert_array_equal(t.kf_seq, j.kf_seq)
    np.testing.assert_array_equal(t.kf_parent, j.kf_parent)
    np.testing.assert_allclose(t.kf_R, j.kf_R, atol=1e-4)
    np.testing.assert_allclose(t.kf_t, j.kf_t, atol=1e-4)
    assert _share(t.kf_obs_pt, j.kf_obs_pt) >= 0.99, i
    assert _share(t.pt_valid, j.pt_valid) >= 0.995, i
    both = t.pt_valid & j.pt_valid
    err = np.abs(t.pt_pos[both] - j.pt_pos[both]).max(1)
    off = err > 1e-3
    if off.any():
        ref = j.pt_pos[j.pt_valid]
        moved = t.pt_pos[both][off]
        nearest = np.abs(moved[:, None] - ref[None]).max(-1).min(1)
        assert off.mean() <= 0.01 and nearest.max() <= 1e-3, i


def assert_tracker_states_equal(j, t, i):
    """Mode and counters equal, poses within 1e-4."""
    for f in dataclasses.fields(j):
        if f.name in ("pose_R", "pose_t"):
            np.testing.assert_allclose(getattr(t, f.name), getattr(j, f.name),
                                       atol=1e-4)
        else:
            assert getattr(t, f.name) == getattr(j, f.name), (i, f.name)


class StageLog:
    """Counts what each mapper stage changed in the map."""

    def __init__(self, mapper):
        self.added = 0
        self.extended = 0
        self.ba = 0
        m = mapper
        tri, fuse, ba = m._tri_writeback, m._fuse_writeback, m._ba_writeback

        def tri_wb(kf, p):
            n = len(m.map.valid_points())
            tri(kf, p)
            self.added += len(m.map.valid_points()) - n

        def fuse_wb(kf, p):
            n = (m.map.kf_obs_pt >= 0).sum()
            fuse(kf, p)
            self.extended += int((m.map.kf_obs_pt >= 0).sum() - n)

        def ba_wb(kf, p):
            ba(kf, p)
            self.ba += 1

        m._tri_writeback, m._fuse_writeback = tri_wb, fuse_wb
        m._ba_writeback = ba_wb


def test_tracker_and_mapper_frame_by_frame():
    cfg = small_config()
    tc = tcfg.config_from_dict(dataclasses.asdict(cfg))
    frames, _ = room_frames(N_FRAMES, cfg)
    jt = JTracker(cfg)
    jm = JMapper(cfg, jt.map)
    jt.on_keyframe = jm.process_keyframe
    tt = TTracker(tc, device="cpu")
    tm = TMapper(tc, tt.map, device="cpu")
    tt.on_keyframe = tm.process_keyframe
    log = StageLog(tm)
    for i, (g, d, _) in enumerate(frames):
        rj = jt.process_frame(g, d, stamp=i / 30.0)
        rt = tt.process_frame(g, d, stamp=i / 30.0)
        assert rt == rj, (i, rj, rt)
        assert (tt.ref_kf, tt.state.last_kf) == (jt.ref_kf, jt.state.last_kf)
        assert_tracker_states_equal(jt.state, tt.state, i)
        assert _share(tt._last_pids, jt._last_pids) >= 0.99, i
        assert_arenas_close(jt.map, tt.map, i)
    assert jt.map.n_kf >= 3
    assert log.added > 0 and log.extended > 0 and log.ba >= 1, vars(log)
    assert sorted(tm.stage_ms) == sorted(jm.stage_ms)
    for (s1, R1, t1), (s2, R2, t2) in zip(jt.export_trajectory(),
                                          tt.export_trajectory()):
        assert s1 == s2
        np.testing.assert_allclose(R2, R1, atol=1e-4)
        np.testing.assert_allclose(t2, t1, atol=1e-4)


def test_mapper_stages_batched_over_neighbours():
    """The batched triangulation and fusion programs equal one dispatch per
    neighbour of the plain ``triangulate_pair`` / projection search."""
    from coebslam_tpu_torch.geometry.se3 import SE3
    from coebslam_tpu_torch.ops import brief, triangulation
    from coebslam_tpu_torch.slam import local_mapping as tlm
    tc = tcfg.config_from_dict(dataclasses.asdict(small_config()))
    rng = np.random.RandomState(0)
    K, N, B = 6, 1024, 3
    uv = torch.from_numpy((rng.rand(K, N, 2) * [640, 480]).astype(np.float32))
    desc = torch.from_numpy(rng.randint(0, 256, (K, N, 32)).astype(np.uint8))
    desc[1:, :400] = desc[0, :400]       # shared descriptors: matches exist
    lvl = torch.from_numpy(rng.randint(0, 4, (K, N)).astype(np.int32))
    ur = torch.full((K, N), -1.0)
    val = torch.ones(K, N, dtype=torch.bool)
    R = torch.eye(3).expand(K, 3, 3).clone()
    t = torch.from_numpy((0.1 * rng.randn(K, 3)).astype(np.float32))
    nbr = torch.tensor([1, 2, 4])
    v1 = torch.from_numpy(rng.rand(N) > 0.2)
    v2 = torch.from_numpy(rng.rand(B, N) > 0.2)
    out = tlm.triangulate_all((uv, desc, lvl, ur, val), (R, t), 0, nbr, v1,
                              v2, tc)
    sd = lambda k: brief.to_signed(brief.unpack_bits(desc[k]))
    for b in range(B):
        k = int(nbr[b])
        res = triangulation.triangulate_pair(
            uv[0], sd(0), v1, lvl[0], uv[k], sd(k), v2[b], lvl[k], ur[k],
            SE3(R[0], t[0]), SE3(R[k], t[k]), tc.camera, tc.orb, tc.matcher)
        good = np.nonzero(res.good.numpy())[0]
        n = len(good)
        assert 0 < n <= tlm.K_OUT
        row = out[b].numpy()
        np.testing.assert_array_equal(row[:n, 0], good)
        assert row[:n, 1].all() and not row[n:, 1].any()
        np.testing.assert_array_equal(row[:n, 2], res.idx2.numpy()[good])
        np.testing.assert_array_equal(row[:n, 3:], res.points.numpy()[good])

    # 20 of the 50 points sit on keypoints of keyframe 1, with their
    # descriptors: those fuse.
    pts_pos = torch.from_numpy((rng.randn(50, 3) + [0, 0, 3]).astype(np.float32))
    pts_sd = sd(0)[:50].clone()
    cam = tc.camera
    s_on = torch.from_numpy(rng.choice(N, 20, replace=False))
    xc = torch.stack([(uv[1, s_on, 0] - cam.cx) / cam.fx * 3.0,
                      (uv[1, s_on, 1] - cam.cy) / cam.fy * 3.0,
                      torch.full((20,), 3.0)], dim=1)
    pts_pos[:20] = (xc - t[1]) @ R[1]
    pts_sd[:20] = sd(1)[s_on]
    own = torch.arange(50)
    own_valid = torch.ones(50, dtype=torch.bool)
    slots = tlm.fuse_all((pts_pos, pts_sd), (uv, desc, lvl, ur, val), (R, t),
                         own, own_valid, nbr, tc)
    for b in range(B):
        k = int(nbr[b])
        pc = pts_pos @ R[k].T + t[k]
        u = tc.camera.fx * pc[:, 0] / pc[:, 2] + tc.camera.cx
        v = tc.camera.fy * pc[:, 1] / pc[:, 2] + tc.camera.cy
        for p in range(50):
            close = (torch.abs(uv[k, :, 0] - u[p]) <= 3) \
                & (torch.abs(uv[k, :, 1] - v[p]) <= 3)
            ham = (0.5 * (256 - sd(k) @ pts_sd[p]))
            ham = torch.where(close, ham, torch.full_like(ham, 1e9))
            inside = 0 <= u[p] < 640 and 0 <= v[p] < 480
            want = int(torch.argmin(ham)) if inside \
                and float(ham.min()) <= tc.matcher.th_low else -1
            assert int(slots[b, p]) == want, (b, p)
    assert (slots[0, :20] >= 0).sum() >= 15

"""Parity of the port's four-stage tracking step with the JAX package.

A short session of the port builds a map; then one ``fused_step`` runs in
both packages from that same state, arena and frame.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from coebslam_tpu import config as jcfg
from coebslam_tpu.ops import brief as jbrief
from coebslam_tpu.ops.extractor import Features as JFeatures
from coebslam_tpu.slam import tracking as jtr
from coebslam_tpu.slam.frame import FrameData as JFrameData
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.ops import brief as tbrief
from coebslam_tpu_torch.slam import frame as tframe, realtime as trt, \
    tracking as ttr
from coebslam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

CAM = dict(width=320, height=240, fx=267.7, fy=269.6, cx=160.05, cy=123.8)
ORB = dict(n_levels=4, max_keypoints=1024)
LIM = trt.RTLimits(max_kf=8, spawn_per_kf=256, ba_window=4, local_window=3,
                   max_frames=64, seed_slots=64)


def _j(t):
    a = t.numpy()
    return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)


@pytest.fixture(scope="module")
def session():
    tc = tcfg.SystemConfig(camera=tcfg.CameraConfig(**CAM),
                           orb=tcfg.OrbConfig(**ORB),
                           tracking=tcfg.TrackingConfig(max_frames_between_kf=3))
    planes = tsyn.make_room(seed=0, device="cpu")
    poses = tsyn.camera_trajectory(40, radius=0.35)
    rt = trt.RealtimeSlam(tc, LIM, device="cpu")
    frames = []
    for i in range(6):
        g, d, _, _ = tsyn.render(tc.camera, poses[i], planes, None, i)
        g = torch.clamp(g, 0, 255).to(torch.uint8)
        frames.append((g, d))
        if i < 5:
            rt.track(g, d, i / 30.0)
    return tc, rt.state, frames[5]


def test_fused_step_matches(session):
    tc, st, (g, d) = session
    jc = jcfg.SystemConfig(camera=jcfg.CameraConfig(**CAM),
                           orb=jcfg.OrbConfig(**ORB),
                           tracking=jcfg.TrackingConfig(max_frames_between_kf=3))
    assert int(st.n_kf) >= 2
    fd = tframe.process_rgbd(g.to(torch.float32), d, tc.camera, tc.orb,
                             n_features=st.budget)
    # Inputs exactly as rt_step builds them.
    S = LIM.spawn_per_kf
    Lw = LIM.local_window * S
    k_new = torch.clamp(st.n_kf - 1, min=0)
    lstart = torch.clamp(k_new - LIM.local_window + 1, min=0) * S
    tids = lstart + torch.arange(Lw)
    local_ids = torch.cat([tids, torch.zeros(LIM.reuse_chunks * S,
                                             dtype=torch.int64),
                           trt.SEED_BASE + torch.arange(LIM.seed_slots)])
    local_alive = torch.cat([tids < st.n_kf * S,
                             torch.zeros(LIM.reuse_chunks * S + LIM.seed_slots,
                                         dtype=torch.bool)])
    local_phys = trt.pid_phys(local_ids, LIM)
    alive = trt.pid_alive(st.track.pids, st.kf_lid, LIM)
    track_in = st.track._replace(pids=torch.where(
        alive, trt.pid_phys(st.track.pids, LIM), torch.full_like(alive, -1,
                                                                 dtype=torch.int64)))
    gate = torch.tensor(1.0)
    arena_t = (st.pt_pos, tbrief.to_signed(tbrief.unpack_bits(st.pt_desc)),
               st.pt_valid, st.pt_angle, st.pt_normal, st.pt_mind, st.pt_maxd)
    out_t = ttr.fused_step(fd, track_in, local_phys, local_alive, arena_t,
                           gate, tc)

    f = fd.feats
    fd_j = JFrameData(
        feats=JFeatures(uv=_j(f.uv), level=_j(f.level), score=_j(f.score),
                        angle=_j(f.angle), desc=_j(f.desc), valid=_j(f.valid)),
        depth=_j(fd.depth), ur=_j(fd.ur), inv_sigma2=_j(fd.inv_sigma2),
        obs=_j(fd.obs))
    state_j = jtr.DevTrackState(*[_j(x) for x in track_in])
    arena_j = (_j(st.pt_pos),
               jbrief.to_signed(jbrief.unpack_bits(_j(st.pt_desc))),
               _j(st.pt_valid), _j(st.pt_angle), _j(st.pt_normal),
               _j(st.pt_mind), _j(st.pt_maxd))
    out_j = jax.jit(lambda *a: jtr.fused_step(*a, jc))(
        fd_j, state_j, _j(local_phys), _j(local_alive), arena_j,
        jnp.float32(1.0))

    vj, vt = np.asarray(out_j.scalars.vec), out_t.scalars.vec.numpy()
    assert vt[jtr._V_OK] == 1.0 == vj[jtr._V_OK]
    counts = [jtr._V_INL1, jtr._V_MATCH1, jtr._V_INL2A, jtr._V_INL,
              jtr._V_NFEAT, jtr._V_TRACKED_CLOSE, jtr._V_UNTRACKED_CLOSE]
    np.testing.assert_array_equal(vt[counts], vj[counts])
    np.testing.assert_array_equal(out_t.scalars.pids.numpy(),
                                  np.asarray(out_j.scalars.pids))
    np.testing.assert_array_equal(out_t.state.pids.numpy(),
                                  np.asarray(out_j.state.pids))
    np.testing.assert_allclose(out_t.state.R.numpy(), np.asarray(out_j.state.R),
                               atol=1e-5)
    np.testing.assert_allclose(out_t.state.t.numpy(), np.asarray(out_j.state.t),
                               atol=1e-5)
    np.testing.assert_allclose(out_t.state.vt.numpy(),
                               np.asarray(out_j.state.vt), atol=1e-5)
    assert bool(out_t.state.has_vel) == bool(out_j.state.has_vel)
    assert vt[jtr._V_INL] > 100

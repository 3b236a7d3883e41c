"""Parity of the port's loop closing (``optim/sim3_opt.py``,
``slam/loop_closing.py``) with the JAX package on the CPU.

* ``optimize_sim3`` on tests/test_loop_closing.py's two-camera scene (fixed
  and free scale, with outliers): S12 within 1e-4 (measured: 1.2e-7), the
  inlier sets equal.
* ``LoopCloser`` stage by stage on one shared state:
  - ``detect`` over a synthetic arena and database (controlled
    covisibility and sequence numbers): the chosen candidate and the
    consistency groups equal at every keyframe;
  - ``compute_sim3`` between the newest and the first keyframe of the JAX
    System's map after 10 frames of the relocalization world, with the
    reference's draws injected: the same gates passed (``last_debug``
    equal) and S within 1e-4;
  - ``correct`` on copies of that arena with the global BA held back:
    poses and point positions within 1e-4 (measured: 1.9e-6), every
    integer array of the arena equal (``tests/test_torch_map.py``'s
    rule), loop and fused edges equal; then each package's global BA on
    its arena, held as ``tests/test_torch_handoff.py`` holds it (poses
    1e-4, points 1e-3).

The JAX package's ``correct`` reads each group keyframe's pre-correction
pose through ``jnp.asarray`` of a row view of ``kf_R``/``kf_t`` and then
overwrites that row; on the CPU, JAX shares the memory of a numpy array
whose row happens to be aligned instead of copying it, so some of those
poses are read after the overwrite and the reference's point moves
depend on where the arrays were allocated. The reference's arena is
therefore given strided pose arrays here (``_copying_views``), whose rows
JAX must copy: the reference then computes what its code says, which is
what the port computes.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from coebslam_tpu import config as jcfg
from coebslam_tpu.config import CameraConfig, OptimizerConfig
from coebslam_tpu.geometry import camera as jcam, sim3 as jsim3, so3 as jso3
from coebslam_tpu.optim import sim3_opt as jso
from coebslam_tpu.slam.global_ba import GlobalBA as JGBA
from coebslam_tpu.slam.keyframe_db import KeyFrameDatabase as JDB
from coebslam_tpu.slam.loop_closing import LoopCloser as JLoop
from coebslam_tpu.slam.map import MapArena as JArena
from coebslam_tpu.slam.system import System as JSystem
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.geometry import sim3 as tsim3
from coebslam_tpu_torch.optim import sim3_opt as tso
from coebslam_tpu_torch.slam import vocabulary as tvoc
from coebslam_tpu_torch.slam.global_ba import GlobalBA as TGBA
from coebslam_tpu_torch.slam.keyframe_db import KeyFrameDatabase as TDB
from coebslam_tpu_torch.slam.loop_closing import LoopCloser as TLoop
from coebslam_tpu_torch.slam.map import MapArena as TArena
from test_torch_keyframe_db import port_db_of, reloc_world
from test_torch_relocalization import JaxDraws

torch.set_num_threads(2)
CAM = CameraConfig()
OPT = OptimizerConfig()
TCAM = tcfg.CameraConfig(**dataclasses.asdict(CAM))
TOPT = tcfg.OptimizerConfig(**dataclasses.asdict(OPT))
TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("seed,fix_scale", [(2, True), (3, False),
                                            (4, True)])
def test_optimize_sim3_matches_jax(seed, fix_scale):
    rng = np.random.RandomState(seed)
    X_c2 = rng.uniform([-2, -1.5, 2], [2, 1.5, 6], (150, 3)).astype(
        np.float32)
    S12_gt = jsim3.Sim3.from_se3(
        jnp.asarray(np.asarray(jso3.exp(jnp.asarray([0.05, 0.2, -0.03])))),
        jnp.asarray([0.3, -0.1, 0.2]))
    X_c1 = np.asarray(S12_gt.apply(jnp.asarray(X_c2)))
    noise = lambda: rng.randn(150, 2).astype(np.float32) * 0.5
    uv1 = np.asarray(jcam.project(CAM, jnp.asarray(X_c1))) + noise()
    uv2 = np.asarray(jcam.project(CAM, jnp.asarray(X_c2))) + noise()
    uv1[:15] += 30.0                       # outliers in one direction
    inb = (uv1 > 10).all(1) & (uv1 < [630, 470]).all(1) \
        & (uv2 > 10).all(1) & (uv2 < [630, 470]).all(1)
    S0 = jsim3.exp(jnp.asarray([0.02, -0.03, 0.01, 0.05, 0.05, -0.05,
                                0.0 if fix_scale else 0.03])).compose(S12_gt)
    rj = jso.optimize_sim3(S0, jnp.asarray(X_c1), jnp.asarray(X_c2),
                           jnp.asarray(uv1), jnp.asarray(uv2),
                           jnp.asarray(inb), CAM, OPT, fix_scale=fix_scale)
    rt = tso.optimize_sim3(tsim3.Sim3(*(_t(x) for x in S0)), _t(X_c1),
                           _t(X_c2), _t(uv1), _t(uv2), _t(inb), TCAM, TOPT,
                           fix_scale=fix_scale)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) > 0.8 * inb.sum()
    for a, b in zip(rt.S12, rj.S12):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)


# ---------------------------------------------------------------------- #


def _detect_stub(seed, K=30, N=64, n_words=60):
    """Both packages' arenas and databases with the same random content:
    covisibility in bands along the sequence (so the far past is not
    covisible) plus random cross links, words correlated along it."""
    rng = np.random.RandomState(seed)
    cfg = jcfg.SystemConfig(
        orb=jcfg.OrbConfig(max_keypoints=N),
        map=jcfg.MapConfig(max_keyframes=K, max_points=256),
        loop=jcfg.LoopConfig(min_score_factor=0.5))
    tc = tcfg.config_from_dict(dataclasses.asdict(cfg))
    idx = np.arange(K)
    band = np.abs(idx[:, None] - idx[None, :])
    cov = np.where((band > 0) & (band <= 3), rng.randint(15, 60, (K, K)), 0)
    cross = (rng.rand(K, K) < 0.04) & (band > 8)
    cov = np.where(cross, rng.randint(1, 40, (K, K)), cov)
    cov = np.triu(cov, 1)
    cov = (cov + cov.T).astype(np.int32)
    base = rng.randint(0, n_words, (K // 6 + 1, N))
    words = np.where(rng.rand(K, N) < 0.7, base[idx // 6 % len(base)],
                     rng.randint(0, n_words, (K, N)))
    words[K // 2:] = np.where(rng.rand(K - K // 2, N) < 0.5,
                              words[:K - K // 2], words[K // 2:])
    weights = rng.uniform(0.1, 3.0, n_words).astype(np.float32)
    from coebslam_tpu.slam import vocabulary as jvoc
    voc = jvoc.Vocabulary(np.zeros((1, 32), np.uint8),
                          np.full((1, 2), -1, np.int32),
                          np.full(1, -1, np.int32), weights,
                          np.zeros(1, np.int32), 1, 2)
    out = []
    for Arena, DB, Loop, c, v, kw in (
            (JArena, JDB, JLoop, cfg, voc, {}),
            (TArena, TDB, TLoop, tc, tvoc.Vocabulary(*voc),
             {"device": "cpu"})):
        arena = Arena(c)
        arena.covis[:] = cov
        arena.kf_valid[:] = True
        arena.n_kf = K
        arena.kf_seq[:] = idx
        db = DB(v, arena, K)
        out.append((arena, db, Loop(c, arena, db, **kw)))
    return out, words.astype(np.int32)


@pytest.mark.parametrize("seed", range(3))
def test_detect_matches_jax(seed):
    ((_, jdb, jl), (_, tdb, tl)), words = _detect_stub(seed)
    chosen = []
    for k in range(len(words)):
        jdb.add(k, words[k])
        tdb.add(k, words[k])
        a, b = jl.detect(k), tl.detect(k)
        assert b == a, k
        assert tl._consistency == jl._consistency, k
        chosen.append(a)
        if a >= 0:          # as insert_keyframe does after a closure
            jl.last_loop_seq = tl.last_loop_seq = k
    assert any(c >= 0 for c in chosen), chosen


# ---------------------------------------------------------------------- #


def _copying_views(a):
    """``a``'s values in an array whose rows are strided views, which
    ``jnp.asarray`` copies rather than shares."""
    out = np.zeros(a.shape + (2,), a.dtype)[..., 0]
    out[...] = a
    return out


def port_arena_of(j, tc):
    """A port MapArena holding a copy of a JAX arena's state."""
    t = TArena(tc)
    for k, v in vars(j).items():
        if k not in ("cfg", "on_keyframe_removed", "_devmap"):
            setattr(t, k, copy.deepcopy(v))
    t._dirty_all = True
    return t


def assert_arenas_match(j, t, where):
    """Integer and boolean arrays equal; poses and positions within TOL;
    every other float array equal."""
    for k, a in vars(j).items():
        if not isinstance(a, np.ndarray):
            continue
        b = getattr(t, k)
        if k in ("kf_R", "kf_t", "pt_pos"):
            np.testing.assert_allclose(b, a, atol=TOL, err_msg=f"{where} {k}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{where} {k}")
    for k in ("n_kf", "n_pt", "version", "_free_pt", "_free_kf"):
        assert getattr(t, k) == getattr(j, k), (where, k)


class _HeldBack:
    """Stands in for the global BA inside ``correct``: records its call."""

    def __init__(self):
        self.calls = []

    def run(self, m, fixed_kf=None):
        self.calls.append(fixed_kf)
        return 0


@pytest.fixture(scope="module")
def loop_state():
    cfg, tc, frames, _, voc, tv = reloc_world(10)
    js = JSystem(cfg, vocabulary=voc)
    for i, (g, d, _) in enumerate(frames):
        js.track_rgbd(g, d, stamp=i / 30.0)
    kfs = js.map.valid_keyframes()
    assert len(kfs) >= 4
    return cfg, tc, js, tv, int(kfs[np.argmax(js.map.kf_seq[kfs])]), \
        int(kfs[np.argmin(js.map.kf_seq[kfs])])


def test_compute_sim3_and_correct_match_jax(loop_state):
    cfg, tc, js, tv, kf, cand = loop_state
    jm = copy.deepcopy(js.map)
    jm.on_keyframe_removed = []
    jm.kf_R, jm.kf_t = _copying_views(jm.kf_R), _copying_views(jm.kf_t)
    jdb = copy.deepcopy(js.kf_db)
    jdb.map = jm
    tm = port_arena_of(jm, tc)
    jl = JLoop(cfg, jm, jdb)
    tl = TLoop(tc, tm, port_db_of(jdb, tv, tm), device="cpu",
               sampler=JaxDraws(13))
    assert_arenas_match(jm, tm, "copy")

    ok_j, S_j = jl.compute_sim3(kf, cand)
    ok_t, S_t = tl.compute_sim3(kf, cand)
    assert tl.last_debug == jl.last_debug
    assert ok_t == ok_j and ok_j, jl.last_debug
    for a, b in zip(S_t, S_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)
    np.testing.assert_array_equal(tl._loop_pts, jl._loop_pts)

    jl._global_ba, tl._global_ba = _HeldBack(), _HeldBack()
    jl.correct(kf, cand, S_j)
    tl.correct(kf, cand, S_t)
    assert tl._global_ba.calls == jl._global_ba.calls == [cand]
    assert tl.loop_edges == jl.loop_edges == [(kf, cand)]
    assert tl._fused_edges == jl._fused_edges
    assert tl.last_loop_seq == jl.last_loop_seq
    assert_arenas_match(jm, tm, "correct")

    n_j = JGBA(cfg).run(jm, fixed_kf=cand)
    n_t = TGBA(tc, device="cpu").run(tm, fixed_kf=cand)
    assert n_t == n_j > 0
    np.testing.assert_allclose(tm.kf_R, jm.kf_R, atol=1e-4)
    np.testing.assert_allclose(tm.kf_t, jm.kf_t, atol=1e-4)
    np.testing.assert_allclose(tm.pt_pos, jm.pt_pos, atol=1e-3)

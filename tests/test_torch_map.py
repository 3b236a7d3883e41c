"""Parity of the port's host map arena and its device mirror with the JAX
package on the CPU: one sequence of insertions, fuse redirects, point and
keyframe removals (with a removal listener) and id recycling, applied to
both arenas; every array is held equal after each step, and the device
mirrors after ``sync``."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from coebslam_tpu import config as jcfg
from coebslam_tpu.slam import map as jmap, map_device as jmd
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.slam import map as tmap, map_device as tmd

torch.set_num_threads(1)

JCFG = jcfg.SystemConfig(orb=jcfg.OrbConfig(max_keypoints=64),
                         map=jcfg.MapConfig(max_keyframes=8, max_points=256))
TCFG = tcfg.config_from_dict(dataclasses.asdict(JCFG))
N = 64


def _rot(rng):
    w = 0.2 * rng.randn(3)
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    return (np.eye(3) + np.sin(th) / th * K
            + (1 - np.cos(th)) / th ** 2 * (K @ K)).astype(np.float32)


def _kf_args(rng, point_ids):
    return dict(
        R_cw=_rot(rng), t_cw=rng.randn(3).astype(np.float32),
        stamp=float(rng.rand()),
        uv=(rng.rand(N, 2) * [640, 480]).astype(np.float32),
        level=rng.randint(0, 4, N).astype(np.int32),
        angle=rng.uniform(-np.pi, np.pi, N).astype(np.float32),
        desc=rng.randint(0, 256, (N, 32)).astype(np.uint8),
        depth=rng.uniform(0.5, 4.0, N).astype(np.float32),
        ur=rng.uniform(0, 640, N).astype(np.float32),
        kp_valid=rng.rand(N) > 0.05, point_ids=point_ids)


def _slots(rng, pids):
    out = np.full(N, -1, np.int32)
    out[rng.choice(N, len(pids), replace=False)] = pids
    return out


def _copying_views(a):
    """``a``'s values in an array whose rows are strided views, which
    ``jnp.asarray`` copies rather than shares."""
    out = np.zeros(a.shape + (2,), a.dtype)[..., 0]
    out[...] = a
    return out


def assert_arenas_equal(j, t, step):
    names = [k for k, v in vars(j).items() if isinstance(v, np.ndarray)]
    assert len(names) > 30
    for k in names:
        a, b = getattr(j, k), getattr(t, k)
        assert a.dtype == b.dtype, (step, k)
        np.testing.assert_array_equal(b, a, err_msg=f"{step}: {k}")
    for k in ("n_kf", "n_pt", "version", "kf_seq_counter", "_pose_version",
              "_free_pt", "_free_kf"):
        assert getattr(t, k) == getattr(j, k), (step, k)
    assert sorted(t.kf_cull_rel) == sorted(j.kf_cull_rel), step
    for k, (p, R, tt) in j.kf_cull_rel.items():
        pt, Rt, ttt = t.kf_cull_rel[k]
        assert pt == p
        np.testing.assert_array_equal(Rt, R)
        np.testing.assert_array_equal(ttt, tt)


def assert_mirrors_equal(dj, dt):
    for a, b in zip(dj.points + dj.kf_feats + dj.kf_poses,
                    dt.points + dt.kf_feats + dt.kf_poses):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).astype(
            b.numpy().dtype))


def test_arena_operations_match():
    rng = np.random.RandomState(0)
    j, t = jmap.MapArena(JCFG), tmap.MapArena(TCFG)
    removed = {"j": [], "t": []}
    j.on_keyframe_removed.append(removed["j"].append)
    t.on_keyframe_removed.append(removed["t"].append)
    dj = jmd.DeviceMap(JCFG)
    dt = tmd.DeviceMap(TCFG, device="cpu")

    def both(name, *a, **kw):
        rj = getattr(j, name)(*a, **kw)
        rt = getattr(t, name)(*a, **kw)
        if isinstance(rj, np.ndarray):
            np.testing.assert_array_equal(rt, rj, err_msg=name)
        elif isinstance(rj, tuple):
            for x, y in zip(rj, rt):
                np.testing.assert_array_equal(y, x, err_msg=name)
        else:
            assert rt == rj, name
        return rj

    # Three keyframes over 60 points, with shared observations.
    pos = rng.randn(60, 3).astype(np.float32) + [0, 0, 3]
    desc = rng.randint(0, 256, (60, 32)).astype(np.uint8)
    ids = both("add_points", pos, desc, first_kf=0,
               angles=rng.rand(60).astype(np.float32))
    for k, sel in enumerate((ids[:40], ids[10:50], ids[25:60])):
        both("add_keyframe", **_kf_args(rng, _slots(rng, sel)))
    both("update_point_stats", ids)
    assert_arenas_equal(j, t, "insert")
    dj.sync(j)
    dt.sync(t)
    assert_mirrors_equal(dj, dt)

    # Fuse chain 3 -> 12 -> 30, followed by resolve_ids.
    both("replace_point", 3, 12)
    both("replace_point", 12, 30)
    got = both("resolve_ids", np.asarray([3, 12, 30, 5, -1, 7], np.int32))
    assert got[0] == 30 and got[1] == 30
    both("remove_point", 7)
    got = both("resolve_ids", np.asarray([7, 3], np.int32))
    assert got[0] == -1
    both("point_observation_count", ids)
    assert_arenas_equal(j, t, "fuse")

    # Cull keyframe 2 (a listener sees it), then keyframe 1; a culled
    # keyframe's pose resolves through its parent until the id is reused.
    j.kf_parent[1], t.kf_parent[1] = 0, 0
    j.kf_parent[2], t.kf_parent[2] = 1, 1
    both("remove_keyframe", 2)
    both("remove_keyframe", 1)
    assert removed["j"] == removed["t"] == [2, 1]
    R2, t2, found = both("anchored_pose", 2)
    assert found
    both("local_map_points", np.asarray([0]), 128)
    both("local_map_points", np.asarray([0, 1, 2]), 16)
    assert_arenas_equal(j, t, "cull")
    dj.sync(j)
    dt.sync(t)
    assert_mirrors_equal(dj, dt)
    # Points that only the culled keyframes observed are dead in the mirror.
    dead = np.nonzero(~t.pt_valid[:t.n_pt])[0]
    assert len(dead) > 10
    assert not dt.points[2][dead].any()

    # Recycling: new points reuse freed ids, a new keyframe reuses slot 1.
    new = both("add_points", rng.randn(20, 3).astype(np.float32),
               rng.randint(0, 256, (20, 32)).astype(np.uint8), first_kf=0)
    assert set(new[:5]) <= set(dead)
    k = both("add_keyframe", **_kf_args(rng, _slots(rng, new)))
    assert k == 1
    both("update_point_stats", new)
    both("mark_poses_dirty")
    both("keyframe_pose", 0)
    assert_arenas_equal(j, t, "recycle")
    dj.sync(j)
    dt.sync(t)
    assert_mirrors_equal(dj, dt)


def test_adopt_keyframe_row_matches():
    """A keyframe's feature row written from the device frame equals the
    JAX package's, and the row is no longer dirty."""
    rng = np.random.RandomState(1)
    j, t = jmap.MapArena(JCFG), tmap.MapArena(TCFG)
    # On the CPU, ``jnp.asarray`` shares a numpy array's memory when its
    # buffer happens to be aligned, so the reference's pose mirror would
    # see the second keyframe's pose before it is synced, depending on the
    # allocation. Strided pose arrays are always copied.
    j.kf_R, j.kf_t = _copying_views(j.kf_R), _copying_views(j.kf_t)
    args = _kf_args(rng, np.full(N, -1, np.int32))
    for m in (j, t):
        m.add_keyframe(**args)
    dj = jmd.DeviceMap(JCFG).sync(j)
    dt = tmd.DeviceMap(TCFG, device="cpu").sync(t)
    args2 = _kf_args(rng, np.full(N, -1, np.int32))
    for m in (j, t):
        m.add_keyframe(**args2)

    def fd(lib):
        feats = SimpleNamespace(uv=lib(args2["uv"]), desc=lib(args2["desc"]),
                                level=lib(args2["level"]),
                                valid=lib(args2["kp_valid"]))
        return SimpleNamespace(feats=feats, ur=lib(args2["ur"]))

    dj.adopt_keyframe_row(j, 1, fd(jnp.asarray))
    dt.adopt_keyframe_row(t, 1, fd(lambda a: torch.from_numpy(np.array(a))))
    assert not t._dirty_kf[1] and not j._dirty_kf[1]
    assert_mirrors_equal(dj, dt)
    np.testing.assert_array_equal(dt.kf_feats[0][1].numpy(), args2["uv"])


def test_keyframes_not_mirrored_on_request():
    t = tmap.MapArena(TCFG)
    t.add_keyframe(**_kf_args(np.random.RandomState(2),
                              np.full(N, -1, np.int32)))
    dm = tmd.DeviceMap(TCFG, device="cpu", mirror_keyframes=False).sync(t)
    assert dm.kf_feats is None and dm.points is not None
    t.add_keyframe(**_kf_args(np.random.RandomState(3),
                              np.full(N, -1, np.int32)))
    dm.sync(t)
    assert dm.kf_feats is None

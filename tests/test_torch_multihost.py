"""The port's multi-node glue (coebslam_tpu_torch/parallel/multihost.py)
beside tests/test_multihost.py: the hybrid (dcn, ici) mesh's shape and
dimension names over 1, 4 and 8 spawned gloo ranks, ``initialize`` as a
no-op for one process, contiguous keyframe segments, the real-map bridge
(``arena_to_ba_problem``) on one arena fed to both packages, and the
point-sharded BA over the ICI axis of a (2, 2) mesh.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
import jax

from coebslam_tpu import config as jcfg
from coebslam_tpu.parallel import multihost as jmh
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch import entry
from coebslam_tpu_torch.optim import local_ba as tba
from coebslam_tpu_torch.optim import pose_graph as tpg
from coebslam_tpu_torch.parallel import multihost, sharded_ba
from test_local_ba import build_problem

torch.set_num_threads(1)
OPT = tcfg.OptimizerConfig()


def _tiny_graph(n_edges: int):
    """A 3-node chain with ``n_edges`` edges (the mesh tests' payload)."""
    K = 3
    ei = np.asarray([1 + k % 2 for k in range(n_edges)])
    return tpg.PoseGraphProblem(
        s=torch.ones(K), R=torch.eye(3).repeat(K, 1, 1),
        t=torch.tensor([[0.5 * k, 0.0, 0.0] for k in range(K)]),
        fixed=torch.arange(K) == 0, valid=torch.ones(K, dtype=torch.bool),
        edge_i=torch.from_numpy(ei), edge_j=torch.from_numpy(ei - 1),
        edge_s=torch.ones(n_edges), edge_R=torch.eye(3).repeat(n_edges, 1, 1),
        edge_t=torch.tensor([[0.5, 0.0, 0.0]] * n_edges),
        edge_valid=torch.ones(n_edges, dtype=torch.bool),
        edge_weight=torch.ones(n_edges))


@pytest.mark.parametrize("n_ranks,dcn_size,shape", [
    (1, None, (1, 1)), (4, None, (1, 4)), (4, 2, (2, 2)),
    (8, None, (1, 8)), (8, 2, (2, 4))])
def test_hybrid_mesh_shape(n_ranks, dcn_size, shape):
    """One node: dcn defaults to 1 and the ranks form the ici axis; an
    explicit dcn_size splits them row-major. The ranks' poses agree."""
    out = sharded_ba.run_sharded("pose_graph", _tiny_graph(2 * n_ranks),
                                 OPT, n_ranks, device="cpu", hybrid=True,
                                 dcn_size=dcn_size,
                                 axis=(multihost.DCN_AXIS,
                                       multihost.ICI_AXIS))
    assert out["mesh"] == shape
    assert out["mesh_dims"] == (multihost.DCN_AXIS, multihost.ICI_AXIS)
    assert all(torch.equal(out["rank_t"][0], t) for t in out["rank_t"])


def test_hybrid_shape_rule_matches_jax():
    """The ragged-layout rule of make_hybrid_mesh, against the JAX
    package's on virtual meshes of its 8 devices."""
    for dcn in (1, 2, 3, 4, 8, 16):
        assert multihost.hybrid_shape(8, dcn) \
            == jmh.make_hybrid_mesh(dcn_size=dcn).devices.shape
    assert multihost.hybrid_shape(6, 4) == (3, 2)
    assert multihost.hybrid_shape(1, 2) == (1, 1)


def test_initialize_is_noop_single_process():
    multihost.initialize()                       # must not raise
    assert not dist.is_initialized()


def test_segment_assignment_is_contiguous():
    segs = [multihost.segment_of_keyframe(k, 4, 512) for k in range(512)]
    assert segs[0] == 0 and segs[-1] == 3
    assert all(b - a in (0, 1) for a, b in zip(segs, segs[1:]))
    assert segs == [jmh.segment_of_keyframe(k, 4, 512) for k in range(512)]


@pytest.fixture(scope="module")
def arena():
    cam, _ = entry._small_configs()
    return entry.build_arena(cam)


def test_arena_to_ba_problem_matches_jax(arena):
    """dryrun_multichip (e)'s ~100-keyframe arena through both packages'
    bridge (the JAX one reads the same numpy arena): every array equal,
    the same keyframes, points and segments."""
    m, cfg_m = arena
    jcfg_m = jcfg.SystemConfig(orb=jcfg.OrbConfig(
        scale_factor=cfg_m.orb.scale_factor))
    jp, jk, jpts, jseg = jmh.arena_to_ba_problem(m, jcfg_m, max_obs=8,
                                                 n_segments=2,
                                                 pad_points_to=8)
    tp, tk, tpts, tseg = multihost.arena_to_ba_problem(
        m, cfg_m, max_obs=8, n_segments=2, pad_points_to=8, device="cpu")
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tpts, jpts)
    np.testing.assert_array_equal(tseg, jseg)
    assert len(tk) == 100 and len(tpts) == 16000
    assert [int((tseg == s).sum()) for s in range(2)] == [8000, 8000]
    for name in tba.BAProblem._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)),
                                      err_msg=name)


def test_sharded_ba_on_ici_axis():
    """The point-sharded BA over the ICI axis of a (2, 2) mesh (each dcn
    row solves its own replica): camera 1 within 2 cm of the truth, as
    tests/test_multihost.py gates it."""
    prob, poses_gt, _ = build_problem(jax.random.PRNGKey(0), K=4, P=64, M=4)
    d = {k: np.asarray(v) for k, v in prob._asdict().items()}
    d["obs_kf"] = d["obs_kf"].astype(np.int64)
    tprob = tba.BAProblem(**{k: torch.from_numpy(v.copy())
                             for k, v in d.items()})
    out = sharded_ba.run_sharded("local", tprob, OPT, 4,
                                 cam=tcfg.CameraConfig(), device="cpu",
                                 hybrid=True, dcn_size=2,
                                 axis=multihost.ICI_AXIS)
    assert out["mesh"] == (2, 2)
    terr = np.linalg.norm(out["result"].kf_t[1].numpy()
                          - np.asarray(poses_gt.t[1]))
    assert terr < 0.02, terr
    assert all(torch.equal(out["rank_t"][0], t) for t in out["rank_t"])

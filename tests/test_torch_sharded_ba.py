"""The port's distributed BA (coebslam_tpu_torch/parallel) on the CPU.

PyTorch has no single-process virtual mesh, so each case spawns 2 or 4
gloo ranks through ``parallel.launch`` (about 1 s of start-up per rank
here) and runs one sharded solve on the same problem as the JAX package's
tests/test_sharded_ba.py (tests/test_local_ba.py's build_problem, K 4,
P 128, M 4; its drifted chain pose graph). Shard invariance is held with
the JAX tests' tolerances: poses within 2e-3, median point gap under
5e-3; every rank must end with bit-equal camera poses. The port's
single-rank solvers are held against the JAX package's on the same numpy
problem, and the ``reduce_fn`` hook against the hook-free path.
"""
import numpy as np
import pytest
import torch
import jax

from coebslam_tpu import config as jcfg
from coebslam_tpu.optim import local_ba as jba
from coebslam_tpu.optim import pose_graph as jpg
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.optim import local_ba as tba
from coebslam_tpu_torch.optim import pose_graph as tpg
from coebslam_tpu_torch.parallel import sharded_ba
from test_local_ba import build_problem
import test_sharded_ba as jax_sharded

torch.set_num_threads(1)
CAM = tcfg.CameraConfig()
OPT = tcfg.OptimizerConfig()


def _np(tup):
    return {k: np.asarray(v) for k, v in tup._asdict().items()}


def _tprob(cls, d):
    return cls(**{k: torch.from_numpy(v.astype(np.int64) if v.dtype
                                      == np.int32 else v.copy())
                  for k, v in d.items()})


@pytest.fixture(scope="module")
def problem():
    prob, poses_gt, _ = build_problem(jax.random.PRNGKey(0), K=4, P=128,
                                      M=4)
    return _np(prob), np.asarray(poses_gt.t)


@pytest.fixture(scope="module")
def chain():
    prob, _, t_gt = jax_sharded.TestShardedPoseGraph()._chain_problem()
    return _np(prob), t_gt


def _single(kind, prob, n_blocks=None):
    if kind == "local":
        return tba.optimize_local_ba(prob, CAM, OPT)
    if kind == "global":
        return tba.optimize_global_ba(prob, CAM, OPT, n_blocks=n_blocks)
    return tpg.optimize_pose_graph(prob, OPT, fix_scale=True)


#: The sharded solvers' options per kind, as the JAX tests call them.
OPTIONS = {"local": {}, "global": {"n_blocks_per_device": 2},
           "pose_graph": {"fix_scale": True}}


def _problem_of(kind, problem, chain):
    if kind == "pose_graph":
        return _tprob(tpg.PoseGraphProblem, chain[0])
    return _tprob(tba.BAProblem, problem[0])


@pytest.mark.parametrize("n_ranks", [2, 4])
@pytest.mark.parametrize("kind", ["local", "global", "pose_graph"])
def test_sharded_matches_single_rank(kind, n_ranks, problem, chain):
    """optimize_sharded, optimize_global_sharded (2 blocks per rank) and
    optimize_pose_graph_sharded(fix_scale=True) against the single-rank
    solve (the global one over n_ranks * 2 blocks); the ranks' poses
    bit-equal; two all-reduces (S and b) per GN iteration."""
    prob = _problem_of(kind, problem, chain)
    out = sharded_ba.run_sharded(kind, prob, OPT, n_ranks, cam=CAM,
                                 device="cpu", **OPTIONS[kind])
    single = _single(kind, prob, n_blocks=2 * n_ranks)
    res = out["result"]
    R, t = ("R", "t") if kind == "pose_graph" else ("kf_R", "kf_t")
    np.testing.assert_allclose(getattr(res, t).numpy(),
                               getattr(single, t).numpy(), atol=2e-3)
    np.testing.assert_allclose(getattr(res, R).numpy(),
                               getattr(single, R).numpy(), atol=2e-3)
    if kind != "pose_graph":
        gap = (res.pt_pos - single.pt_pos).norm(dim=-1)
        assert float(gap.median()) < 5e-3
        assert res.pt_pos.shape == single.pt_pos.shape
    assert out["mesh"] == (n_ranks,) and out["backend"] == "gloo"
    for stack in (out["rank_R"], out["rank_t"]):
        assert stack.shape[0] == n_ranks
        assert all(torch.equal(stack[0], s) for s in stack[1:])
    iters = {"local": OPT.local_ba_iters_first + OPT.local_ba_iters_second,
             "global": OPT.global_ba_iters,
             "pose_graph": OPT.essential_graph_iters}[kind]
    assert out["all_reduces"] == 2 * iters


@pytest.mark.parametrize("kind", ["local", "global", "pose_graph"])
def test_reduce_fn_identity_is_bit_equal(kind, problem, chain):
    """A reduce_fn that sums over one rank (the identity, and the real
    all-reduce over a 1-rank group in this process) leaves every output
    bit for bit as the hook-free solve gives it."""
    prob = _problem_of(kind, problem, chain)
    plain = _single(kind, prob, n_blocks=2)
    ident = lambda S, b: (S, b)
    if kind == "local":
        hooked = tba.optimize_local_ba(prob, CAM, OPT, reduce_fn=ident)
    elif kind == "global":
        hooked = tba.optimize_global_ba(prob, CAM, OPT, n_blocks=2,
                                        reduce_fn=ident)
    else:
        hooked = tpg.optimize_pose_graph(prob, OPT, fix_scale=True,
                                         reduce_fn=ident)
    one = sharded_ba.run_sharded(kind, prob, OPT, 1, cam=CAM, device="cpu",
                                 **OPTIONS[kind])
    for a, b, c in zip(plain, hooked, one["result"]):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("kind", ["local", "global", "pose_graph"])
def test_single_rank_matches_jax(kind, problem, chain):
    """The port's single-device solve against the JAX package's on the
    same numpy problem (the sharded tests' inputs)."""
    jcam, jopt = jcfg.CameraConfig(), jcfg.OptimizerConfig()
    if kind == "pose_graph":
        d = chain[0]
        j = jpg.optimize_pose_graph(jpg.PoseGraphProblem(**d), jopt,
                                    fix_scale=True)
        t = tpg.optimize_pose_graph(_tprob(tpg.PoseGraphProblem, d), OPT,
                                    fix_scale=True)
        pairs = [("R", 1e-4), ("t", 1e-4), ("s", 1e-4)]
    else:
        d = problem[0]
        jp = jba.BAProblem(**d)
        tp = _tprob(tba.BAProblem, d)
        if kind == "local":
            j = jax.jit(lambda p: jba.optimize_local_ba(p, jcam, jopt))(jp)
            t = tba.optimize_local_ba(tp, CAM, OPT)
        else:
            j = jax.jit(lambda p: jba.optimize_global_ba(
                p, jcam, jopt, n_blocks=2))(jp)
            t = tba.optimize_global_ba(tp, CAM, OPT, n_blocks=2)
        pairs = [("kf_R", 2e-5), ("kf_t", 5e-5), ("pt_pos", 5e-4)]
        np.testing.assert_array_equal(t.obs_valid.numpy(),
                                      np.asarray(j.obs_valid))
    for name, tol in pairs:
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), atol=tol)


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["local", "global", "pose_graph"])
def test_eight_ranks_match_jax_mesh(kind, problem, chain):
    """The port at 8 ranks against coebslam_tpu.parallel.sharded_ba on the
    8-device virtual mesh, as tests/test_sharded_ba.py runs it."""
    from coebslam_tpu.parallel import mesh as jmesh
    from coebslam_tpu.parallel import sharded_ba as jsb
    mesh = jmesh.make_mesh(8)
    jopt = jcfg.OptimizerConfig()
    prob = _problem_of(kind, problem, chain)
    if kind == "pose_graph":
        j = jsb.optimize_pose_graph_sharded(
            jpg.PoseGraphProblem(**chain[0]), jopt, mesh, fix_scale=True)
        names = ("R", "t")
    else:
        jp = jba.BAProblem(**problem[0])
        j = (jsb.optimize_sharded(jp, jcfg.CameraConfig(), jopt, mesh)
             if kind == "local" else jsb.optimize_global_sharded(
                 jp, jcfg.CameraConfig(), jopt, mesh,
                 n_blocks_per_device=2))
        names = ("kf_R", "kf_t")
    out = sharded_ba.run_sharded(kind, prob, OPT, 8, cam=CAM, device="cpu",
                                 **OPTIONS[kind])
    for name in names:
        np.testing.assert_allclose(getattr(out["result"], name).numpy(),
                                   np.asarray(getattr(j, name)), atol=2e-3)
    if kind != "pose_graph":
        gap = np.linalg.norm(out["result"].pt_pos.numpy()
                             - np.asarray(j.pt_pos), axis=-1)
        assert np.median(gap) < 5e-3


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["local", "global", "pose_graph"])
def test_eight_ranks_converge(kind, problem, chain):
    """tests/test_sharded_ba.py's convergence gates on the port at 8
    ranks: camera translations within 2 cm of the truth; the chain's
    drift cut below 0.6 of its start."""
    prob = _problem_of(kind, problem, chain)
    out = sharded_ba.run_sharded(kind, prob, OPT, 8, cam=CAM, device="cpu",
                                 **OPTIONS[kind])
    res = out["result"]
    if kind == "pose_graph":
        t_gt = chain[1]
        err = np.linalg.norm(res.t.numpy() - t_gt, axis=-1)
        init = np.linalg.norm(chain[0]["t"] - t_gt, axis=-1)
        assert err.mean() < 0.6 * init.mean(), (err.mean(), init.mean())
    else:
        t_gt = problem[1]
        for k in range(1, 4):
            terr = np.linalg.norm(res.kf_t[k].numpy() - t_gt[k])
            assert terr < 0.02, (k, terr)

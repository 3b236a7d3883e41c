"""Pose Gauss-Newton as one CUDA graph a solve (``optim/pose_gn.py``).

On a CUDA tensor ``optimize_pose`` captures its 4x10 schedule once per
shapes, dtypes and configs and replays it; on a CPU tensor it runs the
schedule eagerly. The ``cuda`` cases hold each replay bit for bit to the
eager body (``pose_gn._solve``) on the card and skip without one; the CPU
cases hold the eager path to the JAX package's pose GN expectations
(``tests/test_pose_gn.py``) and check that it never captures.

This module imports neither JAX nor the JAX package at its top, so its
card cases also run on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_pose_gn_graph.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from coebslam_tpu_torch.config import CameraConfig, OptimizerConfig
from coebslam_tpu_torch.geometry import camera, se3
from coebslam_tpu_torch.geometry.se3 import SE3
from coebslam_tpu_torch.optim import pose_gn
from coebslam_tpu_torch.utils import metrics
from profile_pose_gn import problem

CAM = CameraConfig()
OPT = OptimizerConfig()
XI_GT = [0.03, -0.05, 0.02, 0.1, -0.05, 0.15]


def make_problem(seed, n=200, stereo_frac=0.5, noise_px=0.3):
    """``tests/test_pose_gn.py``'s scene, drawn with a torch generator:
    points 1.5-5 m in front of the camera at a known pose, observed with
    pixel noise, the first ``stereo_frac`` of them in stereo (u_right
    < 0 marks mono)."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(n, 3, generator=g)
    pts_cam = torch.stack([u[:, 0] * 3.0 - 1.5, u[:, 1] * 2.0 - 1.0,
                           u[:, 2] * 3.5 + 1.5], -1)
    pose_gt = se3.exp(torch.tensor(XI_GT))
    pts_w = se3.transform_points(pose_gt.inverse(), pts_cam)
    obs = camera.project_stereo(CAM, pts_cam)
    obs = obs + noise_px * torch.randn(n, 3, generator=g)
    is_stereo = torch.arange(n) < int(n * stereo_frac)
    obs[:, 2] = torch.where(is_stereo, obs[:, 2], -1.0)
    return pose_gt, pts_w, obs, torch.ones(n)


def rot_trans_err(pose: SE3, pose_gt: SE3) -> float:
    return float(torch.linalg.norm(se3.log(pose.compose(pose_gt.inverse()))))


@pytest.fixture
def recorder():
    """The process-wide recorder on and empty; off and empty after."""
    metrics.drain()
    metrics.tracing(True)
    try:
        yield
    finally:
        metrics.tracing(False)
        metrics.drain()


def counts() -> dict:
    """The host counters recorded since the last drain, summed."""
    return {k: sum(v.values()) for k, v in metrics.drain()["counters"].items()}


# ---------------------------------------------------------------- CPU

def _recovers(seed):
    pose_gt, pts_w, obs, w = make_problem(seed)
    pose0 = se3.retract(pose_gt, torch.tensor([0.05, -0.04, 0.03, 0.2, 0.1,
                                               -0.15]))
    res = pose_gn.optimize_pose(pose0, pts_w, obs, w,
                                torch.ones(len(w), dtype=torch.bool), CAM,
                                OPT)
    assert rot_trans_err(res.pose, pose_gt) < 5e-3
    assert int(res.n_inliers) > 180


def _rejects_outliers(seed):
    pose_gt, pts_w, obs, w = make_problem(seed, noise_px=0.2)
    n = len(w)
    n_bad = n // 4
    obs[:n_bad, 0] += 40.0
    pose0 = se3.retract(pose_gt, torch.tensor([0.02, 0.02, -0.02, 0.1, -0.1,
                                               0.05]))
    res = pose_gn.optimize_pose(pose0, pts_w, obs, w,
                                torch.ones(n, dtype=torch.bool), CAM, OPT)
    assert rot_trans_err(res.pose, pose_gt) < 1e-2
    assert int(res.inliers[:n_bad].sum()) < n_bad // 4
    assert int(res.inliers[n_bad:].sum()) > (n - n_bad) * 3 // 4


def _respects_validity(seed):
    pose_gt, pts_w, obs, w = make_problem(seed)
    n = len(w)
    valid = torch.arange(n) < n // 2
    obs[n // 2:, :2] = 10000.0
    pose0 = se3.retract(pose_gt, torch.tensor([0.03, 0.0, 0.0, 0.1, 0.0,
                                               0.0]))
    res = pose_gn.optimize_pose(pose0, pts_w, obs, w, valid, CAM, OPT)
    assert rot_trans_err(res.pose, pose_gt) < 1e-2
    assert not bool(res.inliers[n // 2:].any())


def _zero_valid_stays_finite(seed):
    pose_gt, pts_w, obs, w = make_problem(seed)
    res = pose_gn.optimize_pose(pose_gt, pts_w, obs, w,
                                torch.zeros(len(w), dtype=torch.bool), CAM,
                                OPT)
    assert torch.isfinite(res.pose.t).all()
    assert int(res.n_inliers) == 0


@pytest.mark.parametrize("case,seed", [
    (_recovers, 0), (_rejects_outliers, 1), (_respects_validity, 2),
    (_zero_valid_stays_finite, 3)],
    ids=["recovers", "rejects_outliers", "respects_validity", "zero_valid"])
def test_cpu_meets_the_reference_expectations(case, seed):
    """The JAX package's pose GN expectations, on the port's CPU path."""
    case(seed)


def test_cpu_never_captures(recorder):
    pose_gt, pts_w, obs, w = make_problem(4)
    valid = torch.ones(len(w), dtype=torch.bool)
    n_graphs = len(pose_gn._graphs)
    for _ in range(2):
        res = pose_gn.optimize_pose(pose_gt, pts_w, obs, w, valid, CAM, OPT)
    assert counts() == {}
    assert len(pose_gn._graphs) == n_graphs
    eager = pose_gn._solve(pose_gt.R, pose_gt.t, pts_w, obs, w, valid, CAM,
                           OPT)
    assert_bit_equal(res, eager)


@pytest.mark.parametrize("seed", [5, 6])
def test_cpu_matches_the_jax_package(seed):
    """The port's CPU path against ``coebslam_tpu.optim.pose_gn`` on the
    same float32 inputs: the same inliers, the pose within float32
    rounding of 40 iterations."""
    jnp = pytest.importorskip("jax.numpy")
    jcfg = pytest.importorskip("coebslam_tpu.config")
    jse3 = pytest.importorskip("coebslam_tpu.geometry.se3")
    jpg = pytest.importorskip("coebslam_tpu.optim.pose_gn")
    pose_gt, pts_w, obs, w = make_problem(seed, noise_px=0.5)
    obs[:20, 1] += 25.0                       # outliers for the gating
    valid = torch.arange(len(w)) % 7 != 3
    pose0 = se3.retract(pose_gt, torch.tensor([0.02, -0.03, 0.01, 0.05,
                                               0.08, -0.04]))
    res = pose_gn.optimize_pose(pose0, pts_w, obs, w, valid, CAM, OPT)
    ref = jpg.optimize_pose(
        jse3.SE3(jnp.asarray(pose0.R.numpy()), jnp.asarray(pose0.t.numpy())),
        jnp.asarray(pts_w.numpy()), jnp.asarray(obs.numpy()),
        jnp.asarray(w.numpy()), jnp.asarray(valid.numpy()),
        jcfg.CameraConfig(), jcfg.OptimizerConfig())
    np.testing.assert_array_equal(res.inliers.numpy(),
                                  np.asarray(ref.inliers))
    np.testing.assert_allclose(res.pose.R.numpy(), np.asarray(ref.pose.R),
                               atol=2e-5)
    np.testing.assert_allclose(res.pose.t.numpy(), np.asarray(ref.pose.t),
                               atol=2e-5)


# ---------------------------------------------------------------- card

def assert_bit_equal(a: pose_gn.PoseOptResult, b: pose_gn.PoseOptResult):
    """Every output equal bit for bit (float NaNs included)."""
    pairs = [(a.pose.R, b.pose.R), (a.pose.t, b.pose.t),
             (a.inliers, b.inliers), (a.n_inliers, b.n_inliers),
             (a.chi2, b.chi2)]
    for x, y in pairs:
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


def card_problem(kind, seed, n, dev):
    """A frame-sized solve on the card: ``mixed`` (``profile_pose_gn``'s:
    half stereo, a fifth gross outliers, a tenth invalid, from a perturbed
    pose), ``all_invalid`` or ``degenerate`` (five valid mono observations
    of nearly one point, so the normal equations are near-singular)."""
    R, t, pts_w, obs, w, valid = problem(torch, se3, camera, CAM, n, dev,
                                         seed)
    if kind == "all_invalid":
        valid = torch.zeros_like(valid)
    elif kind == "degenerate":
        g = torch.Generator().manual_seed(seed)
        pts_w = pts_w[:1] + 1e-4 * torch.randn(n, 3, generator=g).to(dev)
        obs[:, 2] = -1.0
        valid = torch.arange(n, device=dev) < 5
    return [R, t, pts_w, obs, w, valid]


def replay(inputs):
    R, t, *rest = inputs
    return pose_gn.optimize_pose(SE3(R, t), *rest, CAM, OPT)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mixed", "all_invalid", "degenerate"])
def test_replay_is_bit_equal_to_the_eager_body(card, kind):
    inputs = card_problem(kind, 11, 2048, card)
    got = replay(inputs)
    want = pose_gn._solve(*inputs, CAM, OPT)
    torch.cuda.synchronize()
    assert_bit_equal(got, want)
    if kind == "mixed":
        assert 0 < int(got.n_inliers) < 2048


@pytest.mark.cuda
def test_successive_replays_keep_their_own_results(card, recorder):
    """Four replays with other inputs, all read after the last: a result
    that aliased the graph's static outputs would read the fourth's."""
    problems = [card_problem("mixed", 20 + k, 2048, card) for k in range(4)]
    got = [replay(p) for p in problems]
    want = [pose_gn._solve(*p, CAM, OPT) for p in problems]
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert_bit_equal(a, b)
    assert not torch.equal(got[0].pose.t, got[3].pose.t)
    assert counts().get("pose_gn_replays") == 4


@pytest.mark.cuda
def test_a_new_size_captures_a_new_graph(card, recorder):
    n_graphs = len(pose_gn._graphs)
    replay(card_problem("mixed", 30, 1000, card))
    replay(card_problem("mixed", 31, 1000, card))
    assert counts() == {"pose_gn_captures": 1, "pose_gn_replays": 2}
    got = replay(card_problem("mixed", 32, 1001, card))
    assert counts() == {"pose_gn_captures": 1, "pose_gn_replays": 1}
    assert len(pose_gn._graphs) == n_graphs + 2
    want = pose_gn._solve(*card_problem("mixed", 32, 1001, card), CAM, OPT)
    torch.cuda.synchronize()
    assert_bit_equal(got, want)


@pytest.mark.cuda
def test_a_capture_keeps_only_its_buffers(card):
    """A capture leaves allocated only its static inputs and outputs (no
    second cuBLAS workspace), and its peak stays near an eager solve's."""
    inputs = card_problem("mixed", 40, 1500, card)
    pose_gn._solve(*inputs, CAM, OPT)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pose_gn._solve(*inputs, CAM, OPT)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated() - before
    torch.cuda.reset_peak_memory_stats()
    replay(inputs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    after = torch.cuda.memory_allocated() - before
    buffers = sum(x.numel() * x.element_size() for x in inputs)
    assert after < 2 * buffers + 2**20
    assert peak < eager_peak + 2**21

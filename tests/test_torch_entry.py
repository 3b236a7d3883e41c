"""The port's entry module (coebslam_tpu_torch/entry.py) beside the
repository root's __graft_entry__.py: the fused front-end + track step on
the same 640x480 arguments, and the multi-device dry run on 2 spawned gloo
ranks.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from coebslam_tpu_torch import entry

torch.set_num_threads(2)


def test_entry_matches_jax():
    """Both modules build their arguments from RandomState(0): the
    arguments are equal, and the step's pose agrees within 1e-4 and its
    inlier count within 1."""
    fn_t, args_t = entry.entry(device="cpu")
    fn_j, args_j = graft.entry()
    assert len(args_t) == len(args_j) == 11
    for t, j in zip(args_t, args_j):
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j.astype(jnp.float32)))
    R_j, t_j, n_j = jax.jit(fn_j)(*args_j)
    with torch.no_grad():
        R_t, t_t, n_t = fn_t(*args_t)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-4)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-4)
    assert abs(int(n_t) - int(n_j)) <= 1, (int(n_t), int(n_j))


def test_dryrun_multichip_two_ranks(capsys):
    """Parts (a)-(e) on 2 ranks with their checks; the summary line as the
    JAX module prints it; two all-reduces per GN iteration in each
    sharded solve; the real-map bridge's segments."""
    out = entry.dryrun_multichip(2, device="cpu")
    line = capsys.readouterr().out
    assert line.startswith("dryrun_multichip(2): sharded local BA"), line
    assert "HYBRID mesh (2, 1) (dcn,ici)" in line
    assert out["hybrid_mesh"] == (2, 1) and out["backend"] == "gloo"
    assert len(out["counts"]) == 2 and min(out["counts"]) > 0
    assert out["n_kf"] == 100 and out["n_points"] == 16000
    assert out["segments"] == [8000, 8000]
    assert out["gba_gap"] <= 2e-3
    assert out["pose_graph"] == (100, 100)
    assert out["all_reduces"]["a"] == 30          # 5 + 10 iterations
    assert out["all_reduces"]["c"] == out["all_reduces"]["e_hybrid"] == 20
    assert out["all_reduces"]["d"] == 40          # 20 iterations

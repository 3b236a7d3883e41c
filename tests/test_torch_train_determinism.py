"""The detector trainer's loss terms, its optimizer and its determinism
(coebslam_tpu_torch/tools/train_detector.py) beside the JAX package's
tools/train_detector.py, on the CPU.

* ``detector_loss(terms=True)`` on seeded random heads and the targets of
  seeded random boxes against ``jax_loss_terms``, a transcription of the
  JAX tool's ``loss_fn`` (tools/train_detector.py:175-197, a closure inside
  its ``main``) that also returns the four terms it sums per level
  (objectness BCE, class BCE, xy, wh): the total and each term within
  relative 1e-5.
* ``make_optimizer`` against ``optax.adam(lr)`` on seeded parameters and
  gradients: one step within 1e-7 of the parameters' scale, and three.
* Two seeded runs of ``train_detector.run`` (3 steps) bit-equal in every
  loss, term and trained weight, and ``deterministic`` restoring the
  settings it changes.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from coebslam_tpu_torch.tools import train_detector as ttd

torch.set_num_threads(2)
LEVELS = (40, 20, 10)            # the 320 input's three heads
LR = 2e-3


def jax_loss_terms(raw, tgt):
    """The JAX tool's ``loss_fn`` after the network: the total, summed in
    its order, and [obj, cls, xy, wh] summed over the levels."""
    total, parts = 0.0, jnp.zeros(4)
    for lvl in range(len(tgt)):
        obj_t, xy_t, wh_t, mask = tgt[lvl]
        sig = jax.nn.sigmoid(raw[lvl])
        obj_p = raw[lvl][..., 4]
        bce = optax.sigmoid_binary_cross_entropy(obj_p, obj_t)
        wpos = 1.0 + 200.0 * obj_t
        obj = (bce * wpos).mean()
        m = mask[..., None]
        xy = 8.0 * (jnp.where(m, (sig[..., 0:2] - xy_t) ** 2,
                              0.0).sum() / (m.sum() + 1.0))
        wh = 8.0 * (jnp.where(m, (sig[..., 2:4] - wh_t) ** 2,
                              0.0).sum() / (m.sum() + 1.0))
        cls = (optax.sigmoid_binary_cross_entropy(raw[lvl][..., 5], obj_t)
               * wpos).mean()
        total += obj
        total += xy
        total += wh
        total += cls
        parts = parts + jnp.stack([obj, cls, xy, wh])
    return total, parts


def _boxes(rng, n_frames):
    """Seeded [n, MAX_GT, 4] xyxy boxes in a 640x480 image, -1 padded."""
    out = np.full((n_frames, ttd.MAX_GT, 4), -1.0, np.float32)
    for f in range(n_frames):
        for j in range(rng.randint(1, ttd.MAX_GT + 1)):
            x0, y0 = rng.uniform(0, 560), rng.uniform(0, 360)
            w, h = rng.uniform(20, 200), rng.uniform(60, 300)
            out[f, j] = [x0, y0, min(x0 + w, 639), min(y0 + h, 479)]
    return out


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 4.0), (2, 30.0)])
def test_detector_loss_terms_match_jax(seed, scale):
    """Heads N(0, scale^2): 30 reaches the logits of the training's loss
    spikes, where BCE is linear in the logit."""
    rng = np.random.RandomState(seed)
    B = 3
    raw = [(scale * rng.randn(B, s, s, 3, 6)).astype(np.float32)
           for s in LEVELS]
    tgt = ttd.stack_targets(_boxes(rng, B), 640, 480, "cpu")
    assert sum(int(t[3].sum()) for t in tgt) > 0
    total, parts = ttd.detector_loss([torch.from_numpy(r) for r in raw],
                                     tgt, terms=True)
    j_total, j_parts = jax.jit(jax_loss_terms)(
        [jnp.asarray(r) for r in raw],
        [tuple(jnp.asarray(a.numpy()) for a in lvl) for lvl in tgt])
    np.testing.assert_allclose(float(total), float(j_total), rtol=1e-5)
    np.testing.assert_allclose(parts.numpy(), np.asarray(j_parts),
                               rtol=1e-5)
    assert float(total) == float(ttd.detector_loss(
        [torch.from_numpy(r) for r in raw], tgt))


@pytest.mark.parametrize("steps", [1, 3])
def test_adam_matches_optax(steps):
    """Seeded parameters (one with near-zero entries) and gradients; optax
    applies the same gradients; the parameters within 1e-7 of their
    scale."""
    rng = np.random.RandomState(steps)
    shapes = [(16, 8, 3, 3), (16,), (40,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    params[2][:20] *= 1e-6
    grads = [[(rng.randn(*s) * 10.0 ** rng.randint(-8, 2)).astype(np.float32)
              for s in shapes] for _ in range(steps)]
    model = torch.nn.Module()
    model.p = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params])
    opt = ttd.make_optimizer(model, LR)
    tx = optax.adam(LR)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    for g in grads:
        for p, x in zip(model.p, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        upd, state = tx.update([jnp.asarray(x) for x in g], state)
        jp = optax.apply_updates(jp, upd)
    for p, q in zip(model.p, jp):
        q = np.asarray(q)
        np.testing.assert_allclose(p.detach().numpy(), q, rtol=0,
                                   atol=1e-7 * max(1.0, np.abs(q).max()))


def test_two_seeded_runs_are_bit_equal(tmp_path):
    """``run`` twice with the same arguments (deterministic by default):
    every loss, every term and every trained weight equal."""
    outs = []
    for k in range(2):
        outs.append(ttd.run(ttd.parse_args(
            ["--cpu", "--width", "0.125", "--seqs", "1", "--frames", "34",
             "--steps", "3", "--batch", "2",
             "--out", str(tmp_path / f"det{k}.npz")])))
    a, b = outs
    assert a["losses"] == b["losses"]
    np.testing.assert_array_equal(a["terms"], b["terms"])
    assert a["terms"].shape == (3, len(ttd.TERMS))
    np.testing.assert_allclose(a["terms"].sum(1), a["losses"], rtol=1e-5)
    assert a["state_dict"].keys() == b["state_dict"].keys()
    assert all(torch.equal(a["state_dict"][k], b["state_dict"][k])
               for k in a["state_dict"])
    assert a["miou"] == b["miou"]


def test_deterministic_restores_the_settings():
    cudnn = torch.backends.cudnn
    before = (torch.are_deterministic_algorithms_enabled(),
              cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    with ttd.deterministic(torch):
        assert torch.are_deterministic_algorithms_enabled()
        assert cudnn.deterministic and not cudnn.benchmark
        assert not cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.are_deterministic_algorithms_enabled(),
            cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before

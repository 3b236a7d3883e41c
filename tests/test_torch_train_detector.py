"""The port's detector trainer (coebslam_tpu_torch/tools/train_detector.py)
beside the JAX package's tools/train_detector.py.

The JAX tool's loss is a closure inside its ``main``, so it is written out
here in jnp (``jax_loss``, a transcription of tools/train_detector.py's
``loss_fn``). Both networks start from the same Flax-initialised weights
at the walker detector's width 0.25 (carried across with
``yolov5.from_flax_variables``) and see the same batch of 2 rendered
walker frames. Held: the targets equal; the loss within relative 1e-4;
the gradients of the first convolution, a BatchNorm scale and a head
within relative 1e-3 of their largest entry; one Adam step (Adam turns
near-zero gradient differences into sign flips of size lr, so the
parameters are held to an lr-scaled tolerance) and three steps' losses
within relative 1e-3; the saved .npz read by both packages' loaders, and
the JAX package's detector on a port-written file giving the port's boxes.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from coebslam_tpu import config as jcfg
from coebslam_tpu.models import detector as jdet
from coebslam_tpu.models import yolov5 as jy
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.models import detector as tdet
from coebslam_tpu_torch.models import yolov5 as ty
from coebslam_tpu_torch.tools import train_detector as ttd

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, LR = 0.25, 2e-3


def _jax_tool():
    """tools/train_detector.py of the JAX package, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "jax_train_detector", os.path.join(ROOT, "tools",
                                           "train_detector.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_MODEL = jy.YoloV5s(num_classes=1, width_mult=WIDTH, depth_mult=0.33)


def jax_loss(params, rest, img, tgt):
    """The JAX tool's ``loss_fn`` (tools/train_detector.py:175-197)."""
    raw = JAX_MODEL.apply({"params": params, **rest}, img)
    total = 0.0
    for lvl in range(len(tgt)):
        obj_t, xy_t, wh_t, mask = tgt[lvl]
        sig = jax.nn.sigmoid(raw[lvl])
        obj_p = raw[lvl][..., 4]
        bce = optax.sigmoid_binary_cross_entropy(obj_p, obj_t)
        wpos = 1.0 + 200.0 * obj_t
        total += (bce * wpos).mean()
        m = mask[..., None]
        total += 8.0 * (jnp.where(m, (sig[..., 0:2] - xy_t) ** 2,
                                  0.0).sum() / (m.sum() + 1.0))
        total += 8.0 * (jnp.where(m, (sig[..., 2:4] - wh_t) ** 2,
                                  0.0).sum() / (m.sum() + 1.0))
        cls_bce = optax.sigmoid_binary_cross_entropy(raw[lvl][..., 5],
                                                     obj_t)
        total += (cls_bce * wpos).mean()
    return total


@pytest.fixture(scope="module")
def setup():
    """Flax-initialised variables, the port's network with them, and a
    batch of 2 walker frames (the JAX tool's first sequence) with its
    targets in both layouts."""
    variables = jax.device_get(jax.jit(JAX_MODEL.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, ttd.INPUT, ttd.INPUT, 3))))
    model = ty.YoloV5s(1, WIDTH, 0.33)
    model.load_state_dict(ty.from_flax_variables(variables))
    model.eval()
    G, B = ttd.render_dataset(n_seqs=1, n_frames=40, device="cpu")
    idx = [5, 30]
    imgs = torch.cat([tdet.preprocess(torch.from_numpy(G[i]), ttd.INPUT)
                      for i in idx])
    t_tgt = ttd.stack_targets(B[idx], G.shape[2], G.shape[1], "cpu")
    j_tgt = [tuple(jnp.asarray(a.numpy()) for a in lvl) for lvl in t_tgt]
    j_img = jnp.asarray(imgs.permute(0, 2, 3, 1).numpy())
    return dict(variables=variables, model=model, imgs=imgs, G=G, B=B,
                t_tgt=t_tgt, j_tgt=j_tgt, j_img=j_img)


def test_build_targets_match_the_jax_tool(setup):
    jtool = _jax_tool()
    rng = np.random.RandomState(4)
    cases = list(setup["B"][::7])
    for _ in range(20):                  # random boxes, tiny to huge
        b = np.full((ttd.MAX_GT, 4), -1.0, np.float32)
        for j in range(rng.randint(0, ttd.MAX_GT + 1)):
            x0, y0 = rng.uniform(-20, 640), rng.uniform(-20, 480)
            w, h = np.exp(rng.uniform(0, 6, 2))
            b[j] = [x0, y0, x0 + w, y0 + h]
        cases.append(b)
    for b in cases:
        for t, j in zip(ttd.build_targets_np(b, 640, 480),
                        jtool.build_targets_np(b, 640, 480)):
            for x, y in zip(t, j):
                np.testing.assert_array_equal(x, y)
    assert sum(int(t[3].sum()) for t in ttd.build_targets_np(
        setup["B"][5], 640, 480)) > 0


def _jax_grads(setup):
    v = setup["variables"]
    rest = {k: x for k, x in v.items() if k != "params"}
    return jax.jit(jax.value_and_grad(jax_loss), static_argnums=())(
        v["params"], rest, setup["j_img"], setup["j_tgt"])


def test_loss_and_gradients_match_jax(setup):
    j_loss, j_grad = _jax_grads(setup)
    model = setup["model"]
    model.zero_grad()
    t_loss = ttd.detector_loss(model(setup["imgs"]), setup["t_tgt"])
    t_loss.backward()
    assert abs(float(t_loss.detach()) - float(j_loss)) \
        <= 1e-4 * abs(float(j_loss))
    named = dict(model.named_parameters())
    pairs = [("b0.conv.weight", ("b0", "conv", "kernel")),
             ("b0.bn.weight", ("b0", "bn", "scale")),
             ("h23.cv3.bn.weight", ("h23", "cv3", "bn", "scale")),
             ("detect.0.weight", ("detect0", "kernel")),
             ("detect.2.bias", ("detect2", "bias"))]
    for name, path in pairs:
        g = j_grad
        for p in path:
            g = g[p]
        g = np.asarray(g)
        if g.ndim == 4:
            g = g.transpose(3, 2, 0, 1)                # HWIO -> OIHW
        t = named[name].grad.numpy()
        scale = np.abs(g).max()
        assert scale > 0, name
        np.testing.assert_allclose(t, g, rtol=0, atol=1e-3 * scale,
                                   err_msg=name)


def test_adam_steps_match_optax(setup):
    """One step: every parameter within 2 lr, and 99 % of the entries
    within lr / 100 (the others are sign flips of near-zero gradients).
    Three steps on the same batch: the losses within relative 1e-3."""
    v = setup["variables"]
    rest = {k: x for k, x in v.items() if k != "params"}
    tx = optax.adam(LR)

    @jax.jit
    def step(params, opt_state):
        loss, g = jax.value_and_grad(jax_loss)(params, rest, setup["j_img"],
                                               setup["j_tgt"])
        updates, opt_state = tx.update(g, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    model = ty.YoloV5s(1, WIDTH, 0.33)
    model.load_state_dict(ty.from_flax_variables(v))
    model.eval()
    opt = ttd.make_optimizer(model, LR)
    params, opt_state = v["params"], tx.init(v["params"])
    j_losses, t_losses = [], []
    for it in range(3):
        params, opt_state, loss = step(params, opt_state)
        j_losses.append(float(loss))
        t_loss = ttd.detector_loss(model(setup["imgs"]), setup["t_tgt"])
        opt.zero_grad(set_to_none=True)
        t_loss.backward()
        opt.step()
        t_losses.append(float(t_loss.detach()))
        if it == 0:
            after = ty.from_flax_variables({"params": jax.device_get(params),
                                            "batch_stats":
                                            v["batch_stats"]})
            sd = model.state_dict()
            n_far = n_all = 0
            for k, x in after.items():
                if k.endswith("num_batches_tracked"):
                    continue
                d = (sd[k] - x).abs()
                assert float(d.max()) <= 2 * LR * 1.001, k
                n_far += int((d > LR / 100).sum())
                n_all += d.numel()
            assert n_far <= 0.01 * n_all, (n_far, n_all)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-3)
    assert t_losses[-1] < t_losses[0]


def test_saved_file_reads_in_both_packages(setup, tmp_path):
    """The committed walker detector's weights written by the port's
    ``save_variables``: the port's loader gives the same state back, the
    JAX package's loader the same arrays and metadata, and the JAX
    package's detector on that file gives the port's boxes (within 0.5
    px) on a walker frame."""
    art = os.path.join(ROOT, "artifacts", "detector_walker.npz")
    state = ty.from_flax_variables(tdet.load_variables_npz(art)[0])
    path = str(tmp_path / "walker.npz")
    ttd.save_variables(path, state, 0.5, WIDTH)
    tv, tmeta = tdet.load_variables_npz(path)
    back = ty.from_flax_variables(tv)
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k]) for k in state)
    jv, jmeta = jdet.load_variables_npz(path)
    assert float(jmeta["miou"]) == float(tmeta["miou"]) == 0.5
    assert float(jmeta["width"]) == WIDTH
    kw = dict(width_multiple=WIDTH, num_classes=1, input_size=ttd.INPUT,
              conf_threshold=0.4)
    jd = jdet.YoloDetector(jcfg.DetectorConfig(**kw),
                           jcfg.SystemConfig().dynamic, variables=jv)
    td = tdet.YoloDetector(tcfg.DetectorConfig(**kw),
                           tcfg.SystemConfig().dynamic, variables=tv,
                           device="cpu")
    gray = setup["G"][30]
    jb, tb = np.asarray(jd.detect(gray)), td.detect(gray)
    assert len(tb) == len(jb) >= 1
    np.testing.assert_allclose(tb, jb, atol=0.5)

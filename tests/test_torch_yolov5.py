"""Parity of the port's YOLOv5 (``coebslam_tpu_torch/models/yolov5.py``)
with the JAX package's Flax network: raw heads, decode, fixed-size NMS
(ties and the class filter included), and the weight converters.

The Flax network is initialised by Flax, its BatchNorm statistics and
affine terms are replaced by seeded random values so that inference-mode
BatchNorm is exercised, and the variables are carried across with
``from_flax_variables``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from coebslam_tpu.models import yolov5 as jyolo
from coebslam_tpu_torch.models import yolov5 as tyolo

torch.set_num_threads(1)

NC, WIDTH, SIZE = 3, 0.125, 64


def _perturbed(variables, rng):
    """Flax variables with random BatchNorm scale/bias/mean/var."""
    v = jax.tree.map(np.asarray, variables)

    def walk(node, coll):
        for k, x in node.items():
            if isinstance(x, dict):
                walk(x, coll)
            elif coll == "batch_stats":
                node[k] = (rng.uniform(0.5, 1.5, x.shape) if k == "var"
                           else rng.normal(0, 0.2, x.shape)).astype(np.float32)
            elif k in ("scale", "bias") and x.ndim == 1:
                node[k] = (x + rng.normal(0, 0.1, x.shape)).astype(np.float32)
    walk(v["params"], "params")
    walk(v["batch_stats"], "batch_stats")
    return v


@pytest.fixture(scope="module")
def nets():
    jm = jyolo.YoloV5s(num_classes=NC, width_mult=WIDTH)
    variables = _perturbed(
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))),
        np.random.RandomState(1))
    tm = tyolo.YoloV5s(NC, WIDTH).eval()
    tm.load_state_dict(tyolo.from_flax_variables(variables))
    x = np.random.RandomState(2).rand(1, SIZE, SIZE, 3).astype(np.float32)
    j_raw = [np.asarray(r) for r in jm.apply(variables, jnp.asarray(x))]
    with torch.no_grad():
        t_raw = [r.numpy() for r in
                 tm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))]
    return variables, j_raw, t_raw


def test_raw_heads_match_flax(nets):
    _, j_raw, t_raw = nets
    assert [r.shape for r in t_raw] == [r.shape for r in j_raw]
    for j, t in zip(j_raw, t_raw):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-4)


def test_decode_matches(nets):
    _, j_raw, _ = nets
    jd = np.asarray(jyolo.decode_predictions(
        [jnp.asarray(r) for r in j_raw], NC))
    td = tyolo.decode_predictions([torch.tensor(r) for r in j_raw], NC)
    np.testing.assert_allclose(td.numpy(), jd, rtol=0, atol=1e-4)


def _tied_decoded(rng, n=300):
    """Decoded predictions with integer-valued scores (many exact ties)
    and boxes on a coarse grid (many exact IoU ties)."""
    d = np.zeros((n, 5 + NC), np.float32)
    d[:, 0:2] = rng.randint(0, 8, (n, 2)) * 8.0
    d[:, 2:4] = rng.randint(1, 4, (n, 2)) * 8.0
    d[:, 4] = 1.0
    d[:, 5:] = rng.randint(0, 4, (n, NC)) / 4.0
    return d


@pytest.mark.parametrize("case", ["model", "tied", "tied_filtered",
                                  "model_filtered"])
def test_nms_topk_equal(nets, case):
    _, j_raw, _ = nets
    if case.startswith("model"):
        dec = np.asarray(jyolo.decode_predictions(
            [jnp.asarray(r) for r in j_raw], NC))[0]
        kw = dict(conf_threshold=0.2, iou_threshold=0.3)
    else:
        dec = _tied_decoded(np.random.RandomState(3))
        kw = dict(conf_threshold=0.25, iou_threshold=0.45)
    if case.endswith("filtered"):
        kw["class_filter"] = (1,)
    jb, js, jc = (np.asarray(a) for a in jyolo.nms_topk(jnp.asarray(dec),
                                                          **kw))
    tb, ts, tc = (a.numpy() for a in tyolo.nms_topk(torch.from_numpy(dec),
                                                     **kw))
    assert (js > 0).sum() >= 4, "the case selects too few boxes"
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tc, jc)


def _ultralytics_names(sd):
    """This module's state_dict renamed to ultralytics v6.0 names, with
    the Detect head's anchor buffers."""
    back = {f"{name}.": f"model.{idx}." for name, idx in tyolo._LAYER_MAP}
    out = {}
    for k, v in sd.items():
        head = k.split(".")[0] + "."
        out[back[head] + k[len(head):]] = v
    out["model.24.anchors"] = torch.tensor(tyolo.ANCHORS, dtype=torch.float32)
    out["model.24.anchor_grid"] = torch.zeros(3, 1, 3, 1, 1, 2)
    return out


def test_port_torch_weights_maps_ultralytics_names():
    """A yolov5s-shaped ultralytics state dict (random values, made here)
    loads through port_torch_weights, and equals what the JAX package's
    port_torch_weights makes of it, carried back by from_flax_variables."""
    g = torch.Generator().manual_seed(4)
    src = tyolo.YoloV5s(NC, WIDTH)
    sd = {k: (torch.rand(v.shape, generator=g) + 0.5
              if v.is_floating_point() else v)
          for k, v in src.state_dict().items()}
    ultra = _ultralytics_names(sd)
    ported = tyolo.port_torch_weights(ultra)
    dst = tyolo.YoloV5s(NC, WIDTH)
    dst.load_state_dict(ported)            # strict: every name and shape
    for k, v in dst.state_dict().items():
        assert torch.equal(v, sd[k]), k
    via_jax = tyolo.from_flax_variables(jyolo.port_torch_weights(ultra, NC))
    assert via_jax.keys() == ported.keys()
    for k in ported:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(via_jax[k], ported[k]), k
    with pytest.raises(KeyError):
        tyolo.port_torch_weights({"model.30.conv.weight": torch.zeros(1)})


def test_full_width_parameter_count():
    """yolov5s as DetectorConfig() defines it has the Flax init's
    7,235,389 parameters."""
    m = tyolo.YoloV5s()
    assert sum(p.numel() for p in m.parameters()) == 7_235_389


def test_random_init_is_seeded_and_calibrated():
    """Same seed, same weights; calibrated on an input, BatchNorm
    normalises it and every Detect channel has zero mean and unit
    variance on it."""
    a, b = (tyolo.init_random(tyolo.YoloV5s(NC, WIDTH),
                              torch.Generator().manual_seed(s))
            for s in (5, 5))
    c = tyolo.init_random(tyolo.YoloV5s(NC, WIDTH),
                          torch.Generator().manual_seed(6))
    for x, y in zip(a.state_dict().values(), b.state_dict().values()):
        assert torch.equal(x, y)
    assert not torch.equal(a.b0.conv.weight, c.b0.conv.weight)
    x = torch.rand((2, 3, SIZE, SIZE), generator=torch.Generator()
                   .manual_seed(7))
    m = tyolo.init_random(tyolo.YoloV5s(NC, WIDTH),
                          torch.Generator().manual_seed(5), calib=x)
    assert not m.training
    with torch.no_grad():
        for r in m(x):
            r = r.reshape(-1, 3 * (5 + NC))
            assert float(r.mean(0).abs().max()) < 1e-4
            assert float((r.std(0) - 1).abs().max()) < 1e-3

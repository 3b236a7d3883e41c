"""YOLOv5s as PyTorch modules: the dynamic-object detector's network.

Counterpart of ``coebslam_tpu/models/yolov5.py``: the CSP backbone with C3
blocks and SPPF, the PANet neck and the anchor-based Detect head on P3, P4
and P5, with yolov5s compound scaling (depth 0.33, width 0.50). The
network is NCHW; the head tensors come out in the reference's layout
[B, H, W, 3, 5 + nc], so ``decode_predictions`` flattens the candidates in
the reference's order (which decides ties in the top-k of ``nms_topk``).

BatchNorm runs in inference mode with epsilon 1e-3 and is not folded into
the convolutions. Module names follow ultralytics v6.0 inside each block
(``cv1``, ``m.0``, ``bn.running_mean``), so ``port_torch_weights`` only
renames the ``model.N`` prefixes; ``from_flax_variables`` carries the JAX
package's variables across (HWIO -> OIHW).
"""
from __future__ import annotations

import functools
import math
import re
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# yolov5s v6.0 anchors (w, h) px per stride, P3/8, P4/16, P5/32.
ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)
STRIDES = (8, 16, 32)


def _width(c: int, mult: float = 0.50) -> int:
    """Width scaling rounded up to a multiple of 8 (make_divisible)."""
    return int(math.ceil(c * mult / 8) * 8)


def _depth(n: int, mult: float = 0.33) -> int:
    return max(int(round(n * mult)), 1)


class ConvBN(nn.Module):
    """Conv + BatchNorm (inference) + SiLU — ultralytics ``Conv``.
    ``pad`` -1 pads ``kernel // 2`` on every side."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1,
                 stride: int = 1, pad: int = -1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride,
                              kernel // 2 if pad < 0 else pad, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3, momentum=0.03)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBN(in_ch, out_ch, 1)
        self.cv2 = ConvBN(out_ch, out_ch, 3)
        self.add = shortcut and in_ch == out_ch

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs (ultralytics ``C3``)."""

    def __init__(self, in_ch: int, out_ch: int, n: int = 1,
                 shortcut: bool = True):
        super().__init__()
        hidden = out_ch // 2
        self.cv1 = ConvBN(in_ch, hidden, 1)
        self.cv2 = ConvBN(in_ch, hidden, 1)
        self.cv3 = ConvBN(2 * hidden, out_ch, 1)
        self.m = nn.Sequential(*(Bottleneck(hidden, hidden, shortcut)
                                 for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast: three chained 5x5 stride-1 max-pools
    (padded with -inf, as the reference's ``SAME`` pooling)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        hidden = in_ch // 2
        self.cv1 = ConvBN(in_ch, hidden, 1)
        self.cv2 = ConvBN(4 * hidden, out_ch, 1)

    def forward(self, x):
        x = self.cv1(x)
        p1 = F.max_pool2d(x, 5, 1, 2)
        p2 = F.max_pool2d(p1, 5, 1, 2)
        p3 = F.max_pool2d(p2, 5, 1, 2)
        return self.cv2(torch.cat([x, p1, p2, p3], 1))


def _up2(x):
    """2x nearest upsampling: an exact repeat of every pixel."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class YoloV5s(nn.Module):
    """Full yolov5s: backbone + PANet neck + Detect head.

    Input [B, 3, H, W] float32 in [0, 1], H and W multiples of 32. Output:
    the 3 raw head tensors [B, Hs, Ws, 3, 5 + nc].
    """

    def __init__(self, num_classes: int = 80, width_mult: float = 0.50,
                 depth_mult: float = 0.33):
        super().__init__()
        w = lambda c: _width(c, width_mult)
        d = lambda n: _depth(n, depth_mult)
        self.num_classes = num_classes
        # Backbone (yolov5s.yaml rows 0-9).
        self.b0 = ConvBN(3, w(64), 6, 2, pad=2)
        self.b1 = ConvBN(w(64), w(128), 3, 2)
        self.b2 = C3(w(128), w(128), d(3))
        self.b3 = ConvBN(w(128), w(256), 3, 2)
        self.b4 = C3(w(256), w(256), d(6))
        self.b5 = ConvBN(w(256), w(512), 3, 2)
        self.b6 = C3(w(512), w(512), d(9))
        self.b7 = ConvBN(w(512), w(1024), 3, 2)
        self.b8 = C3(w(1024), w(1024), d(3))
        self.b9 = SPPF(w(1024), w(1024))
        # Head (rows 10-23).
        self.h10 = ConvBN(w(1024), w(512), 1)
        self.h13 = C3(2 * w(512), w(512), d(3), shortcut=False)
        self.h14 = ConvBN(w(512), w(256), 1)
        self.h17 = C3(2 * w(256), w(256), d(3), shortcut=False)
        self.h18 = ConvBN(w(256), w(256), 3, 2)
        self.h20 = C3(2 * w(256), w(512), d(3), shortcut=False)
        self.h21 = ConvBN(w(512), w(512), 3, 2)
        self.h23 = C3(2 * w(512), w(1024), d(3), shortcut=False)
        self.detect = nn.ModuleList(
            nn.Conv2d(c, 3 * (5 + num_classes), 1)
            for c in (w(256), w(512), w(1024)))

    def forward(self, x) -> List[torch.Tensor]:
        x = self.b3(self.b2(self.b1(self.b0(x))))
        p3 = self.b4(x)
        p4 = self.b6(self.b5(p3))
        p5 = self.b9(self.b8(self.b7(p4)))
        h10 = self.h10(p5)
        h14 = self.h14(self.h13(torch.cat([_up2(h10), p4], 1)))
        out3 = self.h17(torch.cat([_up2(h14), p3], 1))
        out4 = self.h20(torch.cat([self.h18(out3), h14], 1))
        out5 = self.h23(torch.cat([self.h21(out4), h10], 1))
        outs = []
        for conv, feat in zip(self.detect, (out3, out4, out5)):
            y = conv(feat)
            b, _, hh, ww = y.shape
            outs.append(y.view(b, 3, 5 + self.num_classes, hh, ww)
                        .permute(0, 3, 4, 1, 2))
        return outs


def init_random(model: nn.Module, generator: torch.Generator,
                calib=None) -> nn.Module:
    """Seeded random weights for pipeline and timing runs (the values do
    not follow Flax's initialiser): convolution kernels normal with
    variance 1 / fan_in, and then, on the input batch ``calib`` ([B, 3, H,
    W]; default uniform noise at 128^2), each BatchNorm's statistics set
    to those of its input and each Detect channel scaled and shifted to
    zero mean and unit variance. Without the calibration the activations
    fade through the depth and every logit is ~0; calibrated on images
    like those it will see, the logits have unit scale."""
    if calib is None:
        calib = torch.rand((2, 3, 128, 128), generator=generator)
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(torch.randn(mod.weight.shape,
                                             generator=generator)
                                 / math.sqrt(fan_in))
                if mod.bias is not None:
                    mod.bias.zero_()
        for bn in bns:
            bn.reset_parameters()
            bn.momentum = 1.0
        model.train()
        model(calib)
        for bn in bns:
            bn.momentum = 0.03
            bn.num_batches_tracked.zero_()
        model.eval()
        for conv, r in zip(model.detect, model(calib)):
            r = r.reshape(-1, conv.out_channels)      # channel a*(5+nc)+f
            mean, std = r.mean(0), r.std(0)
            conv.weight /= std[:, None, None, None]
            conv.bias.copy_(-mean / std)
    return model.eval()


def init_like_flax(model: nn.Module, generator: torch.Generator
                   ) -> nn.Module:
    """Initial weights drawn as the JAX package's Flax module draws its own
    (the distributions, not the values): convolution kernels from Flax's
    ``lecun_normal`` (a normal of variance 1 / fan_in truncated at two
    standard deviations), biases zero, BatchNorm scale 1, bias 0, mean 0,
    variance 1. The training tool starts from these."""
    std_of_unit_trunc = 0.87962566103423978     # std of N(0,1) cut at +-2
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                std = math.sqrt(1.0 / mod.weight[0].numel()) \
                    / std_of_unit_trunc
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
    return model


@functools.lru_cache(maxsize=32)
def level_constants(lvl: int, h: int, w: int, device: str):
    """The cell grid [1, h, w, 1, 2] (x, y) and the anchors [3, 2] of head
    ``lvl``, made once per shape and device."""
    dev = torch.device(device)
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    grid = torch.stack([gx, gy], -1)[None, :, :, None, :]
    anchors = torch.tensor(ANCHORS[lvl], dtype=torch.float32).to(dev)
    return grid, anchors


def decode_predictions(raw_outputs, num_classes: int = 80):
    """Raw head tensors -> [B, N, 5 + nc] (xywh px, objectness, class
    scores), N = sum of h * w * 3 in head order. ultralytics v6 decode:
    xy = (2 sig(t) - 0.5 + grid) * stride, wh = (2 sig(t))^2 * anchor."""
    out = []
    for lvl, raw in enumerate(raw_outputs):
        b, h, w, na, _ = raw.shape
        grid, anchors = level_constants(lvl, h, w, str(raw.device))
        sig = torch.sigmoid(raw)
        xy = (2.0 * sig[..., 0:2] - 0.5 + grid) * STRIDES[lvl]
        wh = (2.0 * sig[..., 2:4]) ** 2 * anchors
        dec = torch.cat([xy, wh, sig[..., 4:]], -1)
        out.append(dec.reshape(b, h * w * na, 5 + num_classes))
    return torch.cat(out, 1)


def _top(score, k: int):
    """``lax.top_k``: the k largest, ties to the lowest index."""
    val, idx = torch.sort(score, descending=True, stable=True)
    return val[:k], idx[:k]


def nms_topk(decoded, *, conf_threshold: float = 0.3,
             iou_threshold: float = 0.45, max_detections: int = 16,
             class_filter=None):
    """Fixed-size NMS of one image's decoded predictions [N, 5 + nc], with
    no read on the host.

    Greedy NMS runs over the 4 * max_detections best candidates: box i
    suppresses every later candidate whose IoU with it exceeds the
    threshold, if box i is itself still alive. ``class_filter``: class
    ids to keep. Returns boxes [max_detections, 4] xyxy (-1 padded),
    scores and classes (-1 padded).
    """
    xy, wh = decoded[:, 0:2], decoded[:, 2:4]
    cls_scores = decoded[:, 5:]
    cls_id = torch.argmax(cls_scores, dim=-1)
    score = decoded[:, 4] * cls_scores.max(dim=-1).values
    keep = score >= conf_threshold
    if class_filter is not None:
        in_filter = torch.zeros_like(keep)
        for c in class_filter:
            in_filter = in_filter | (cls_id == c)
        keep = keep & in_filter
    score = torch.where(keep, score, torch.zeros_like(score))
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], -1)

    k = min(4 * max_detections, score.shape[0])
    top_score, top_idx = _top(score, k)
    top_boxes = boxes[top_idx]
    top_cls = cls_id[top_idx]
    area = torch.clamp(top_boxes[:, 2] - top_boxes[:, 0], min=0.0) \
        * torch.clamp(top_boxes[:, 3] - top_boxes[:, 1], min=0.0)
    lt = torch.maximum(top_boxes[:, None, :2], top_boxes[None, :, :2])
    rb = torch.minimum(top_boxes[:, None, 2:], top_boxes[None, :, 2:])
    inter = torch.prod(torch.clamp(rb - lt, min=0.0), -1)
    iou = inter / torch.clamp(area[:, None] + area[None, :] - inter, min=1e-9)
    ar = torch.arange(k, device=score.device)
    suppresses = (iou > iou_threshold) & (ar[None, :] > ar[:, None])
    alive = top_score > 0.0
    for i in range(k):
        alive = alive & ~(suppresses[i] & alive[i])
    final = torch.where(alive, top_score, torch.zeros_like(top_score))
    sel_score, sel = _top(final, max_detections)
    valid = sel_score > 0.0
    out_boxes = torch.where(valid[:, None], top_boxes[sel],
                            torch.full_like(top_boxes[sel], -1.0))
    out_cls = torch.where(valid, top_cls[sel], torch.full_like(top_cls[sel], -1))
    return out_boxes, sel_score, out_cls


# --------------------------------------------------------------------- #
# weights
# --------------------------------------------------------------------- #

_FLAX_LEAF = {("conv", "kernel"): "conv.weight", ("bn", "scale"): "bn.weight",
              ("bn", "bias"): "bn.bias", ("bn", "mean"): "bn.running_mean",
              ("bn", "var"): "bn.running_var"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_flax_variables(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's YoloV5s variables ({'params', 'batch_stats'},
    nested dicts of arrays) as this module's ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _flatten(variables[coll]):
            mods = [re.sub(r"^(m|detect)(\d+)$", r"\1.\2", p)
                    for p in path[:-2]]
            a = np.asarray(leaf, np.float32)
            if path[-2].startswith("detect"):
                mods.append(re.sub(r"^detect(\d+)$", r"detect.\1", path[-2]))
                name = {"kernel": "weight", "bias": "bias"}[path[-1]]
            else:
                name = _FLAX_LEAF[path[-2:]]
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)            # HWIO -> OIHW
            sd[".".join(mods + [name])] = torch.from_numpy(
                np.ascontiguousarray(a))
            if name == "bn.running_mean":
                sd[".".join(mods + ["bn.num_batches_tracked"])] = \
                    torch.zeros((), dtype=torch.int64)
    return sd


_FLAX_NAME = {v: k for k, v in _FLAX_LEAF.items()}


def to_flax_variables(state_dict) -> dict:
    """The inverse of ``from_flax_variables``: this module's ``state_dict``
    as the JAX package's variables ({'params', 'batch_stats'}, nested
    dicts of float32 numpy arrays, kernels HWIO), the layout that its
    ``tools/train_detector.py`` saves and ``load_variables_npz`` reads."""
    out: dict = {"params": {}, "batch_stats": {}}
    for key, val in state_dict.items():
        parts = key.split(".")
        if parts[-1] == "num_batches_tracked":
            continue
        if parts[0] == "detect":
            path = [f"detect{parts[1]}",
                    {"weight": "kernel", "bias": "bias"}[parts[2]]]
            coll = "params"
        else:
            mods = re.sub(r"(^|\.)(m)\.(\d+)(?=\.)", r"\1\2\3",
                          ".".join(parts[:-2])).split(".")
            leaf = _FLAX_NAME[".".join(parts[-2:])]
            path = mods + list(leaf)
            coll = "batch_stats" if leaf[1] in ("mean", "var") else "params"
        a = val.detach().cpu().numpy().astype(np.float32)
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)                # OIHW -> HWIO
        node = out[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = a
    return out


# (this module's name, ultralytics model.N index), in yaml order.
_LAYER_MAP = (
    ("b0", 0), ("b1", 1), ("b2", 2), ("b3", 3), ("b4", 4), ("b5", 5),
    ("b6", 6), ("b7", 7), ("b8", 8), ("b9", 9), ("h10", 10), ("h13", 13),
    ("h14", 14), ("h17", 17), ("h18", 18), ("h20", 20), ("h21", 21),
    ("h23", 23), ("detect", "24.m"),
)


def port_torch_weights(state_dict) -> Dict[str, torch.Tensor]:
    """An ultralytics yolov5 v6.0 ``state_dict`` (e.g. ``ckpt['model']
    .float().state_dict()`` of yolov5s.pt) as this module's: the
    ``model.N.`` prefixes renamed, the Detect head's anchor buffers
    dropped (they are ``ANCHORS``). Load it with ``load_state_dict``,
    which checks every name and shape."""
    prefix = {f"model.{idx}.": f"{name}." for name, idx in _LAYER_MAP}
    out = {}
    for key, val in state_dict.items():
        if key.startswith("model.24.anchor"):
            continue
        head = re.match(r"model\.(24\.m|\d+)\.", key)
        if head is None or head.group(0) not in prefix:
            raise KeyError(f"unexpected ultralytics key {key!r}")
        t = torch.as_tensor(val).detach()
        out[prefix[head.group(0)] + key[head.end():]] = \
            t.float() if t.is_floating_point() else t
    return out

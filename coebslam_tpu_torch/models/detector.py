"""The YOLOv5 detector behind the dynamic front-end, and a fake detector.

Counterpart of ``coebslam_tpu/models/detector.py`` (``YoloDetector``,
``FakeDetector``, ``load_variables_npz``). ``YoloDetector.detect_device``
runs resize, normalisation, the network, decode, fixed-size NMS, the box
dilation and the padding to ``[dynamic.max_boxes, 4]`` on the detector's
device with no read on the host, so the realtime loop can feed its boxes
to the dynamic step in the same stream. ``detect`` is the host path.
``BlurGate`` is the reference's flow-magnitude frame gate.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import DetectorConfig, DynamicConfig
from ..ops import blur as blur_ops
from ..ops import lk_flow, pyramid
from ..utils.device import resolve_device
from . import yolov5


def preprocess(gray, size: int) -> torch.Tensor:
    """An [H, W] grey frame as the network's input [1, 3, size, size]:
    grey to 3 channels / 255, antialiased linear resize."""
    img = pyramid.resize_bilinear(gray.to(torch.float32) / 255.0,
                                  (size, size))
    return img[None, None].expand(1, 3, size, size)


class FakeDetector:
    """Replays a precomputed box sequence (ground truth in tests)."""

    def __init__(self, boxes_per_frame: Sequence):
        self._boxes = [np.asarray(b, np.float32).reshape(-1, 4)
                       for b in boxes_per_frame]
        self._i = 0

    def detect(self, gray) -> np.ndarray:
        b = self._boxes[min(self._i, len(self._boxes) - 1)]
        self._i += 1
        return b

    def detect_device(self, gray) -> torch.Tensor:
        """The next boxes [n, 4], on gray's device (``RealtimeSlam`` pads
        them)."""
        return torch.tensor(self.detect(gray), device=gray.device)


def load_variables_npz(path: str):
    """Variables saved by the JAX package's tools/train_detector.py
    ('/'-joined keys -> nested dict of numpy arrays; '__name__' keys are
    metadata). Returns (variables, meta)."""
    z = np.load(path)
    out: dict = {}
    meta = {}
    for k in z.files:
        if k.startswith("__"):
            meta[k.strip("_")] = z[k]
            continue
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[k]
    return out, meta


class YoloDetector:
    """YOLOv5 detector filtered to the dynamic classes.

    ``variables``: the JAX package's variables ({'params', 'batch_stats'},
    e.g. from ``load_variables_npz``), or a ``state_dict`` of
    ``yolov5.YoloV5s`` (e.g. from ``yolov5.port_torch_weights``); None
    makes seeded random weights (``seed``), for pipeline and timing runs.
    ``device`` defaults to CUDA, with no CPU fallback.
    """

    def __init__(self, cfg: DetectorConfig, dyn_cfg: DynamicConfig,
                 variables=None, seed: int = 0, dilate: float = 0.0,
                 device=None):
        self.device = resolve_device(device, "YoloDetector")
        self.cfg = cfg
        self.model = yolov5.YoloV5s(cfg.num_classes, cfg.width_multiple,
                                    cfg.depth_multiple)
        if variables is None:
            yolov5.init_random(self.model, torch.Generator().manual_seed(seed))
        else:
            self.model.load_state_dict(
                yolov5.from_flax_variables(variables)
                if "params" in variables else variables)
        self.model.eval().to(self.device)
        self.dilate = float(dilate)
        self._class_filter = tuple(dyn_cfg.dynamic_classes)
        self._max_boxes = int(dyn_cfg.max_boxes)
        self.dispatches = 0          # detect_device calls
        # The heads' grids and anchors, made now: a run adds no upload.
        size = cfg.input_size
        for lvl, s in enumerate(yolov5.STRIDES):
            yolov5.level_constants(lvl, size // s, size // s,
                                    str(self.device))

    def _frame(self, gray) -> torch.Tensor:
        if isinstance(gray, torch.Tensor):
            return gray.to(self.device)
        return torch.from_numpy(np.asarray(gray)).to(self.device)

    @torch.no_grad()
    def heads(self, gray) -> list:
        """The network's raw head tensors for an [H, W] grey frame."""
        return self.model(preprocess(self._frame(gray), self.cfg.input_size))

    @torch.no_grad()
    def run(self, gray):
        """(boxes [max_detections, 4] in image pixels, scores, classes,
        boxes padded or cut to [dynamic.max_boxes, 4]); all on the
        device."""
        cfg = self.cfg
        h, w = gray.shape[-2:]
        dec = yolov5.decode_predictions(self.heads(gray), cfg.num_classes)[0]
        boxes, scores, classes = yolov5.nms_topk(
            dec, conf_threshold=cfg.conf_threshold,
            iou_threshold=cfg.iou_threshold,
            max_detections=cfg.max_detections,
            class_filter=self._class_filter)
        # Back from the detector's input scale to image pixels, per
        # coordinate as the reference does (a negative one stays -1).
        sx, sy = w / cfg.input_size, h / cfg.input_size
        scaled = torch.stack([boxes[:, 0] * sx, boxes[:, 1] * sy,
                              boxes[:, 2] * sx, boxes[:, 3] * sy], 1)
        boxes = torch.where(boxes >= 0, scaled, torch.full_like(boxes, -1.0))
        if self.dilate > 0.0:
            # A margin for the dynamic mask: a box that clips a limb leaks
            # moving keypoints into the map.
            ctr = 0.5 * (boxes[:, :2] + boxes[:, 2:])
            half = 0.5 * (boxes[:, 2:] - boxes[:, :2]) * (1.0 + self.dilate)
            dil = torch.cat([ctr - half, ctr + half], 1)
            boxes = torch.where(boxes[:, :1] >= 0, dil, boxes)
        pad = self._max_boxes - boxes.shape[0]
        if pad > 0:
            padded = torch.cat([boxes, torch.full((pad, 4), -1.0,
                                                  device=boxes.device)])
        else:
            padded = boxes[:self._max_boxes]
        return boxes, scores, classes, padded

    def detect(self, gray) -> np.ndarray:
        """The valid boxes [n, 4] as numpy (the host path: reads back)."""
        b = self.run(gray)[0].cpu().numpy()
        return b[b[:, 0] >= 0]

    def detect_device(self, gray) -> torch.Tensor:
        """Padded [dynamic.max_boxes, 4] pixel boxes, left on the device:
        the dynamic step takes them with no read on the host."""
        self.dispatches += 1
        return self.run(gray)[3]


class BlurGate:
    """Flow-magnitude frame gate (the reference's yolo_v5_blur variant).

    Between consecutive frames it sums the LK flow magnitude over tracked
    corners; above ``flow_threshold`` it buffers ``buffer_size`` frames and
    emits only the sharpest (the largest Laplacian variance). Both numbers
    come from one device call and one transfer. ``push`` returns (emit,
    (stamp, gray) or None): emit False means the frame is buffered.
    Runs on ``device`` (default CUDA; no CPU fallback).
    """

    def __init__(self, flow_threshold: float = 500.0, buffer_size: int = 3,
                 n_track_points: int = 256, device=None):
        self.flow_threshold = float(flow_threshold)
        self.buffer_size = int(buffer_size)
        self.n_track_points = int(n_track_points)
        self.device = resolve_device(device, "BlurGate")
        self._buf = []                     # [(stamp, gray, sharpness)]
        self._prev = None

    def measure(self, prev_gray, gray) -> torch.Tensor:
        """[2] device tensor: the summed flow magnitude of the tracked
        corners, and the variance of ``gray``'s Laplacian."""
        pts, ok = lk_flow.good_features(prev_gray, self.n_track_points)
        fr = lk_flow.lk_flow(lk_flow.build_flow_pyramid(prev_gray),
                             lk_flow.build_flow_pyramid(gray), pts)
        mag = torch.where(ok & fr.valid,
                          torch.linalg.norm(fr.points - pts, dim=-1),
                          torch.zeros_like(pts[:, 0]))
        sharp = torch.var(blur_ops.laplacian_map(gray), unbiased=False)
        return torch.stack([mag.sum(), sharp])

    def push(self, gray, stamp: float = 0.0):
        g = gray if isinstance(gray, torch.Tensor) \
            else torch.from_numpy(np.asarray(gray, np.float32))
        g = g.to(self.device, torch.float32)
        if self._prev is None:
            self._prev = g
            return True, (stamp, gray)
        motion, sharp = self.measure(self._prev, g).cpu().tolist()
        self._prev = g
        if motion <= self.flow_threshold and not self._buf:
            return True, (stamp, gray)
        self._buf.append((stamp, gray, sharp))
        if len(self._buf) < self.buffer_size:
            return False, None
        best = max(self._buf, key=lambda x: x[2])
        self._buf = []
        return True, (best[0], best[1])

"""Train a reduced-width YOLOv5 walker detector on rendered frames.

Counterpart of ``tools/train_detector.py`` of the JAX package (which made
``artifacts/detector_walker.npz``). The renderer labels its own frames, so
this trains a single-class ``YoloV5s`` on walker scenes of the synthetic
room and saves it in the JAX tool's format (flattened Flax variable names,
``__miou__``, ``__width__``), which both packages'
``models.detector.load_variables_npz`` read.

  * Dataset: the JAX tool's walker sequences (``render_dataset``), rendered
    by the port's renderer on the run's device; the last 30 frames are
    held out.
  * Targets (``build_targets_np``): the ultralytics v6 assignment reduced
    to its core -- each box's centre cell at every level, anchors gated by
    a width/height ratio under 4, targets in sigmoid space.
  * Loss (``detector_loss``): BCE objectness and class, positives weighted
    200x, and sigmoid-space L2 on xy and wh at the positives.
  * Optimizer: Adam (optax's ``adam``: betas 0.9 / 0.999, eps 1e-8).
    The network trains in ``eval()`` mode: the JAX network's BatchNorm
    uses its running statistics while it trains (scale and bias learn,
    the statistics stay), and ``train()`` would normalise by batch
    statistics instead.
  * Batches: ``RandomState(0).randint`` per step, the JAX tool's draws.
  * Score: held-out mean IoU through ``YoloDetector`` (the inference path).
  * Determinism (``deterministic``): training and scoring run with
    PyTorch's deterministic algorithms, cuDNN's deterministic and
    non-benchmarked convolutions and TF32 off (the reference computes in
    float32), so two runs on one card give the same bits.

Usage:
  python3 -m coebslam_tpu_torch.tools.train_detector [--steps 700]
      [--width 0.125] [--batch 8] [--lr 2e-3] [--seqs 3] [--frames 130]
      [--out build/detector_walker.npz] [--log-every 100] [--cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

INPUT = 320
MAX_GT = 2
N_VAL = 30
DEFAULT_OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "detector_walker.npz")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python3 -m coebslam_tpu_torch.tools.train_detector",
        description="Train the walker detector on rendered frames.")
    ap.add_argument("--steps", type=int, default=700)
    ap.add_argument("--width", type=float, default=0.125)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seqs", type=int, default=3)
    ap.add_argument("--frames", type=int, default=130)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def render_dataset(n_seqs: int = 3, n_frames: int = 130, device=None):
    """The JAX tool's walker sequences: sequence s is room ``s`` with 1 + s
    % 2 walkers on a 0.3 m orbit, each walker rendered with the room and
    the frames composited by depth. Returns (grey [N, H, W] uint8,
    boxes [N, MAX_GT, 4] float32 xyxy px, -1 padded) as numpy."""
    import torch
    from ..config import SystemConfig
    from ..utils import synthetic
    from ..utils.device import resolve_device

    dev = resolve_device(device, "render_dataset")
    cam = SystemConfig().camera
    gs, bs = [], []
    for s in range(n_seqs):
        planes = synthetic.make_room(seed=s, device=dev)
        walkers = [synthetic.make_walker(
            seed=s * 7 + w, start=(-1.2 + 0.5 * w + 0.1 * s,
                                   -0.3 + 0.05 * w, 1.7 + 0.25 * w),
            velocity=(0.010 + 0.004 * w, 0.004 - 0.002 * w, 0.0),
            half_w=0.24 + 0.05 * w, half_h=0.55 + 0.08 * w, device=dev)
            for w in range(1 + s % 2)]
        seq_boxes = []
        for i, pose in enumerate(synthetic.camera_trajectory(n_frames,
                                                             radius=0.3)):
            gray = depth = None
            boxes = []
            for q in walkers:
                g, d, b = synthetic.render(cam, pose, planes, q, i)[:3]
                if gray is None:
                    gray, depth = g, d
                else:
                    closer = (d > 0) & ((depth <= 0) | (d < depth))
                    gray = torch.where(closer, g, gray)
                    depth = torch.where(closer, d, depth)
                boxes.append(b)
            gs.append(torch.clamp(gray, 0, 255).to(torch.uint8))
            seq_boxes.append(torch.stack(boxes))
        for b in torch.stack(seq_boxes).cpu().numpy():   # one read per seq
            arr = np.full((MAX_GT, 4), -1.0, np.float32)
            kept = [x for x in b if x[0] >= 0][:MAX_GT]
            for j, x in enumerate(kept):
                arr[j] = x
            bs.append(arr)
    return torch.stack(gs).cpu().numpy(), np.stack(bs)


def build_targets_np(boxes, cam_w, cam_h):
    """Per-level target tensors from [MAX_GT, 4] xyxy boxes (image px).

    Returns per level: obj [h,w,3], xy [h,w,3,2], wh [h,w,3,2] (both in
    SIGMOID space, i.e. what sigmoid(raw) should equal), mask [h,w,3].
    """
    from ..models.yolov5 import ANCHORS, STRIDES
    sx, sy = INPUT / cam_w, INPUT / cam_h
    out = []
    for lvl, stride in enumerate(STRIDES):
        h = w = INPUT // stride
        anchors = np.asarray(ANCHORS[lvl], np.float32)
        obj = np.zeros((h, w, 3), np.float32)
        txy = np.zeros((h, w, 3, 2), np.float32)
        twh = np.zeros((h, w, 3, 2), np.float32)
        mask = np.zeros((h, w, 3), bool)
        for b in boxes:
            if b[0] < 0:
                continue
            cx = 0.5 * (b[0] + b[2]) * sx
            cy = 0.5 * (b[1] + b[3]) * sy
            bw = max((b[2] - b[0]) * sx, 2.0)
            bh = max((b[3] - b[1]) * sy, 2.0)
            gx, gy = int(cx / stride), int(cy / stride)
            if not (0 <= gx < w and 0 <= gy < h):
                continue
            for a in range(3):
                r = np.maximum([bw / anchors[a, 0], bh / anchors[a, 1]],
                               [anchors[a, 0] / bw, anchors[a, 1] / bh])
                if r.max() >= 4.0:
                    continue
                obj[gy, gx, a] = 1.0
                mask[gy, gx, a] = True
                # sigmoid-space targets inverting the v6 decode.
                txy[gy, gx, a] = [(cx / stride - gx + 0.5) / 2.0,
                                  (cy / stride - gy + 0.5) / 2.0]
                twh[gy, gx, a] = [np.sqrt(bw / anchors[a, 0]) / 2.0,
                                  np.sqrt(bh / anchors[a, 1]) / 2.0]
        out.append((obj, txy, twh, mask))
    return out


def stack_targets(boxes, cam_w, cam_h, device):
    """``build_targets_np`` of every frame's boxes, stacked per level as
    tensors on ``device``: [(obj [N,h,w,3], xy, wh, mask), ...]."""
    import torch
    per = [build_targets_np(b, cam_w, cam_h) for b in boxes]
    return [tuple(torch.from_numpy(np.stack([p[lvl][j] for p in per]))
                  .to(device) for j in range(4))
            for lvl in range(len(per[0]))]


#: The loss terms ``detector_loss(terms=True)`` returns, in order.
TERMS = ("obj", "cls", "xy", "wh")


def detector_loss(raw, targets, terms: bool = False):
    """The JAX tool's training loss over the heads ``raw`` ([B, h, w, 3,
    6] per level) and the batch's ``targets`` (per level obj, xy, wh,
    mask): per level, BCE objectness and class BCE with positives weighted
    1 + 200 (means over every cell and anchor), and 8 x the squared
    sigmoid-space xy and wh errors summed over the positives / (positives
    + 1). The total is accumulated in the JAX tool's order; with
    ``terms`` also a [4] tensor of each term summed over the levels
    (``TERMS``)."""
    import torch
    import torch.nn.functional as F
    total = 0.0
    parts = []
    for r, (obj_t, xy_t, wh_t, mask) in zip(raw, targets):
        sig = torch.sigmoid(r)
        wpos = 1.0 + 200.0 * obj_t
        bce = F.binary_cross_entropy_with_logits(r[..., 4], obj_t,
                                                 reduction="none")
        obj = (bce * wpos).mean()
        m = mask[..., None]
        npos = mask.sum() + 1.0
        zero = torch.zeros((), dtype=r.dtype, device=r.device)
        xy = 8.0 * torch.where(m, (sig[..., 0:2] - xy_t) ** 2,
                               zero).sum() / npos
        wh = 8.0 * torch.where(m, (sig[..., 2:4] - wh_t) ** 2,
                               zero).sum() / npos
        cls_bce = F.binary_cross_entropy_with_logits(r[..., 5], obj_t,
                                                     reduction="none")
        cls = (cls_bce * wpos).mean()
        total = total + obj + xy + wh + cls
        parts.append(torch.stack([obj, cls, xy, wh]))
    if terms:
        return total, torch.stack(parts).detach().sum(0)
    return total


@contextlib.contextmanager
def deterministic(torch, warn_only: bool = False):
    """Run the block with PyTorch's deterministic algorithms (an op
    without one raises, or with ``warn_only`` warns), cuDNN's
    deterministic, non-benchmarked convolutions and TF32 off for
    convolutions and matrix products; restore the settings after it.
    cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG`` for deterministic products:
    it is set here unless the caller set it (it takes effect when the
    process first uses cuBLAS)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
             matmul.allow_tf32)
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    cudnn.deterministic, cudnn.benchmark = True, False
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
         matmul.allow_tf32) = saved[2:]


def make_optimizer(model, lr: float):
    """optax's ``adam(lr)``: betas 0.9 / 0.999, eps 1e-8, eps_root 0."""
    import torch
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def mean_iou(detect, grays, boxes) -> tuple:
    """Mean over ground-truth boxes of the best IoU with ``detect(gray)``'s
    boxes, and the number of ground-truth boxes (the JAX tool's score)."""
    ious = []
    for gray, gt_all in zip(grays, boxes):
        found = np.asarray(detect(gray))
        for g in gt_all[gt_all[:, 0] >= 0]:
            best = 0.0
            for b in found:
                if b[0] < 0:
                    continue
                lt = np.maximum(b[:2], g[:2])
                rb = np.minimum(b[2:], g[2:])
                inter = np.prod(np.maximum(rb - lt, 0))
                ua = (np.prod(b[2:] - b[:2]) + np.prod(g[2:] - g[:2])
                      - inter)
                best = max(best, inter / max(ua, 1e-9))
            ious.append(best)
    return (float(np.mean(ious)) if ious else 0.0), len(ious)


def save_variables(path: str, state_dict, miou: float, width: float):
    """The JAX tool's file: flattened Flax variable names, ``__miou__``
    and ``__width__``."""
    from ..models import yolov5
    flat = {}

    def flatten(prefix, d):
        for k, v in d.items():
            kk = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                flatten(kk, v)
            else:
                flat[kk] = v

    flatten("", yolov5.to_flax_variables(state_dict))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, __miou__=np.float32(miou),
                        __width__=np.float32(width), **flat)


def run(args: argparse.Namespace) -> dict:
    """Render, then train, score and save under ``deterministic``. Returns
    the per-step losses and loss terms ([steps, 4], ``TERMS``), the seconds
    of rendering and training, steps/s (steps 2 to the last, the card
    drained), the held-out IoU and its box count, the frame counts, the
    trained ``state_dict`` (CPU) and the output path."""
    import torch
    from ..utils.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else None, "train_detector")
    t0 = time.perf_counter()
    G, B = render_dataset(args.seqs, args.frames, device=dev)
    render_s = time.perf_counter() - t0
    with deterministic(torch):
        out = _train(args, dev, G, B, render_s)
    out["render_s"] = render_s
    return out


def _train(args: argparse.Namespace, dev, G, B, render_s) -> dict:
    import torch
    from ..config import DetectorConfig, SystemConfig
    from ..models import yolov5
    from ..models.detector import YoloDetector, preprocess

    n = len(G)
    if n <= N_VAL:
        raise ValueError(f"{n} frames: more than the {N_VAL} held out "
                         "are needed")
    cam_h, cam_w = G.shape[1:3]
    print(f"dataset: {n} frames ({N_VAL} held out), rendered in "
          f"{render_s:.1f} s on {dev}", flush=True)

    # Flax's initial distributions; eval(): BatchNorm keeps its running
    # statistics while scale and bias train, as the JAX network does.
    model = yolov5.YoloV5s(num_classes=1, width_mult=args.width,
                           depth_mult=0.33)
    yolov5.init_like_flax(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    opt = make_optimizer(model, args.lr)
    imgs = torch.cat([preprocess(torch.from_numpy(g).to(dev), INPUT)
                      for g in G])                       # [n, 3, S, S]
    T = stack_targets(B, cam_w, cam_h, dev)
    if any(p.device.type != dev.type for p in model.parameters()) \
            or imgs.device.type != dev.type:
        raise RuntimeError(f"train_detector: training is not on {dev}")

    rng = np.random.RandomState(0)
    losses, terms = [], []
    t_first = t1 = time.perf_counter()
    for it in range(args.steps):
        idx = torch.from_numpy(rng.randint(0, n - N_VAL, size=args.batch)
                               ).to(dev)
        loss, parts = detector_loss(
            model(imgs[idx]), [tuple(a[idx] for a in lvl) for lvl in T],
            terms=True)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        terms.append(parts)
        if it == 0:
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
        if it % args.log_every == 0 or it == args.steps - 1:
            vals = torch.cat([losses[-1][None], parts]).tolist()
            print(f"step {it}: loss {vals[0]:.4f} ("
                  + ", ".join(f"{k} {v:.4f}" for k, v in zip(TERMS,
                                                              vals[1:]))
                  + f"; {time.perf_counter() - t_first:.0f}s)", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    losses = torch.stack(losses).cpu().numpy().astype(float).tolist()
    terms = torch.stack(terms).cpu().numpy().astype(float)
    steps_per_s = (args.steps - 1) / (t2 - t1) if args.steps > 1 \
        else float("nan")

    dcfg = DetectorConfig(width_multiple=args.width, num_classes=1,
                          input_size=INPUT, conf_threshold=0.4)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    det = YoloDetector(dcfg, SystemConfig().dynamic, variables=state,
                       device=dev)
    miou, n_boxes = mean_iou(det.detect, G[n - N_VAL:], B[n - N_VAL:])
    print(f"held-out mean IoU vs GT: {miou:.3f} over {n_boxes} boxes")
    save_variables(args.out, state, miou, args.width)
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)")
    return {"losses": losses, "terms": terms, "train_s": t2 - t_first, "steps_per_s": steps_per_s,
            "miou": miou, "n_boxes": n_boxes, "n_frames": n, "n_val": N_VAL,
            "state_dict": state, "out": args.out, "device": str(dev)}


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The work of one frame, counted from the configuration's shapes, and the
chip's published peaks.

Nothing here reads the program: the counts stay the same whatever code
does the work. ``frame_least_seconds`` is the least time one NVIDIA H100
needs for one frame's counted work; ``frame_mfu`` divides it by the
window's time per frame.
"""
from __future__ import annotations

import torch

from . import reference

#: Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
#: rates, at the full 700 W power limit).
PEAK = {"bf16_flops": 989e12, "tf32_flops": 495e12, "fp32_flops": 67e12,
        "hbm_bytes": 3.35e12}

#: Operations per live pixel of the FAST kernel: 86 two-operand min/max for
#: the two arc reductions, 2 subtractions of the centre and 1 max for
#: max(a, -b), 3 for the gate and 5 for the 3 x 3 NMS.
FAST_OPS_PER_PIXEL = 97


def fast_work(height: int, width: int, n_levels: int, scale_factor: float):
    """(bytes, operations) of FAST on one frame's [L, H, W] pyramid canvas:
    each live input float read once, both full output maps written once,
    ``FAST_OPS_PER_PIXEL`` per live pixel."""
    shapes = reference.pyramid_shapes(height, width, n_levels, scale_factor)
    live = sum(h * w for h, w in shapes)
    return (4 * live + 2 * 4 * n_levels * height * width,
            FAST_OPS_PER_PIXEL * live)


def fast_seconds(height, width, n_levels, scale_factor) -> float:
    """The roofline bound of one FAST launch: the larger of bytes over HBM
    bandwidth and operations over the fp32 peak."""
    b, ops = fast_work(height, width, n_levels, scale_factor)
    return max(b / PEAK["hbm_bytes"], ops / PEAK["fp32_flops"])


def yolo_conv_flops(det: dict) -> int:
    """2 x multiply-adds of YOLOv5s's convolutions at its input size, from
    the shapes alone (the network laid out on the meta device)."""
    model = reference.YoloV5s(det["num_classes"], det["width_multiple"],
                              det["depth_multiple"]).to("meta")
    total = [0]

    def hook(mod, inp, out):
        total[0] += 2 * out.numel() * mod.weight[0].numel()

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    s = det["input_size"]
    with torch.no_grad():
        model(torch.zeros((1, 3, s, s), device="meta"))
    for h in hooks:
        h.remove()
    return total[0]


def hamming_flops(cfg: dict) -> int:
    """2 x 256 x rows x columns of the frame's +-1 descriptor products: the
    four tracking stages against the local map's candidates, the dynamic
    check against the previous frame and, for stereo, left against right.
    A frame has the configuration's ``n_features`` keypoints, whatever
    number of slots the program pads them to."""
    n = cfg["orb"]["n_features"]
    lim = cfg["limits"]
    local = (lim["local_window"] + lim["reuse_chunks"]) \
        * lim["spawn_per_kf"] + lim["seed_slots"]
    pairs = 4 * n * local + n * n
    if cfg["sensor"] == "stereo":
        pairs += n * n
    return 2 * 256 * pairs


def frame_least_seconds(cfg: dict, detect_every: int) -> dict:
    """The least time of one frame's counted work by kind, in seconds:
    YOLOv5s in fp32 (amortised over ``detect_every`` frames), the Hamming
    products at the bf16 peak (exact in bf16), FAST at its roofline (twice
    for stereo)."""
    cam, orb = cfg["camera"], cfg["orb"]
    out = {"hamming": hamming_flops(cfg) / PEAK["bf16_flops"],
           "fast": (2 if cfg["sensor"] == "stereo" else 1) * fast_seconds(
               cam["height"], cam["width"], orb["n_levels"],
               orb["scale_factor"])}
    if cfg.get("detector_enabled"):
        out["yolov5s"] = yolo_conv_flops(cfg["detector"]) \
            / PEAK["fp32_flops"] / detect_every
    return out

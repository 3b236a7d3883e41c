"""Per-box blur scores (the COEB motion-blur gate).

Counterpart of ``coebslam_tpu/ops/blur.py``. The reference thresholds the
Laplacian's variance per box (``Frame::detect_laplacian``); the Brenner,
Tenengrad and energy variants it tried and rejected are kept too,
selected by ``box_blur_scores(metric=)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def box_mask(h, w, boxes):
    """[B, H, W] bool masks from [B, 4] (xmin, ymin, xmax, ymax); a box with
    xmin < 0 is absent."""
    dev = boxes.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    inside = ((xs >= boxes[:, 0, None, None]) & (xs <= boxes[:, 2, None, None])
              & (ys >= boxes[:, 1, None, None]) & (ys <= boxes[:, 3, None, None]))
    present = boxes[:, 0] >= 0.0
    return inside & present[:, None, None]


def laplacian_map(img):
    """4-neighbour Laplacian with edge padding."""
    p = F.pad(img[None], (1, 1, 1, 1), mode="replicate")[0]
    return (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
            - 4.0 * img)


def brenner_map(img):
    """Brenner gradient (I(x+2) - I(x))², edge-padded on the right."""
    p = F.pad(img[None], (0, 2, 0, 0), mode="replicate")[0]
    d = p[:, 2:] - p[:, :-2]
    return d * d


def tenengrad_map(img):
    """Tenengrad: the squared 3x3 Sobel gradient magnitude."""
    p = F.pad(img[None], (1, 1, 1, 1), mode="replicate")[0]
    gx = (p[1:-1, 2:] - p[1:-1, :-2]) * 2.0 \
        + (p[:-2, 2:] - p[:-2, :-2]) + (p[2:, 2:] - p[2:, :-2])
    gy = (p[2:, 1:-1] - p[:-2, 1:-1]) * 2.0 \
        + (p[2:, 2:] - p[:-2, 2:]) + (p[2:, :-2] - p[:-2, :-2])
    return gx * gx + gy * gy


def energy_map(img):
    """Energy of gradient (I(x+1) - I(x))² + (I(y+1) - I(y))²."""
    px = F.pad(img[None], (0, 1, 0, 0), mode="replicate")[0]
    py = F.pad(img[None], (0, 0, 0, 1), mode="replicate")[0]
    dx = px[:, 1:] - px[:, :-1]
    dy = py[1:, :] - py[:-1, :]
    return dx * dx + dy * dy


_METRICS = {
    "laplacian": laplacian_map,
    "brenner": brenner_map,
    "tenengrad": tenengrad_map,
    "energy": energy_map,
}


def box_blur_scores(img, boxes, metric: str = "laplacian"):
    """Sharpness per box ([B]): the std of the Laplacian inside the box
    (the reference's scale, thresholded at 4.2), or for the other metrics
    the mean response; absent boxes (xmin < 0) +inf."""
    h, w = img.shape
    masks = box_mask(h, w, boxes).to(img.dtype)
    resp = _METRICS[metric](img)
    area = torch.clamp(masks.sum(dim=(1, 2)), min=1.0)
    mean = (resp[None] * masks).sum(dim=(1, 2)) / area
    if metric == "laplacian":
        var = (((resp[None] - mean[:, None, None]) ** 2) * masks
               ).sum(dim=(1, 2)) / area
        score = torch.sqrt(var)
    else:
        score = mean
    present = boxes[:, 0] >= 0.0
    return torch.where(present, score, torch.full_like(score, float("inf")))

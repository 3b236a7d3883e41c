"""Per-box blur score (the COEB Laplacian blur gate).

Counterpart of the Laplacian path of ``coebslam_tpu/ops/blur.py``.
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


def box_blur_scores(img, boxes):
    """Std of the Laplacian inside each box ([B]); absent boxes +inf."""
    h, w = img.shape
    masks = box_mask(h, w, boxes).to(img.dtype)
    resp = laplacian_map(img)
    area = torch.clamp(masks.sum(dim=(1, 2)), min=1.0)
    mean = (resp[None] * masks).sum(dim=(1, 2)) / area
    var = (((resp[None] - mean[:, None, None]) ** 2) * masks).sum(dim=(1, 2)) \
        / area
    score = torch.sqrt(var)
    present = boxes[:, 0] >= 0.0
    return torch.where(present, score, torch.full_like(score, float("inf")))

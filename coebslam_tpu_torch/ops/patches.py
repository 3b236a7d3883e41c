"""Keypoint patch gathering and intensity-centroid orientation.

Counterpart of ``coebslam_tpu/ops/patches.py``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# Patch edge for descriptor sampling (covers the rotated BRIEF pattern).
PATCH_SIZE = 48
ORIENT_RADIUS = 15  # intensity-centroid circle radius (HALF_PATCH_SIZE)


def gather_patches(img, level, yx, patch_size: int = PATCH_SIZE):
    """Gather [N, P, P] patches from a [L, H, W] stack: patch n is centred
    at integer (row, col) ``yx[n]`` of level ``level[n]``, edge-padded."""
    pad = patch_size // 2
    padded = F.pad(img, (pad, pad, pad, pad), mode="replicate")
    ar = torch.arange(patch_size, device=img.device)
    rows = yx[:, 0, None] + ar[None, :]
    cols = yx[:, 1, None] + ar[None, :]
    return padded[level[:, None, None], rows[:, :, None], cols[:, None, :]]


@functools.lru_cache(maxsize=4)
def _centroid_weights(patch_size: int, radius: int, device: str):
    """Static [P*P, 2] (wx, wy) weights of the intensity centroid."""
    d = np.arange(patch_size) - patch_size // 2
    dy, dx = np.meshgrid(d, d, indexing="ij")
    mask = (dx * dx + dy * dy) <= radius * radius
    w = np.stack([(dx * mask).reshape(-1), (dy * mask).reshape(-1)], 1)
    return torch.from_numpy(w.astype(np.float32)).to(device)


def orientations(patches):
    """Intensity-centroid angle per patch: atan2(m01, m10), [N, P, P] -> [N]."""
    w = _centroid_weights(patches.shape[-1], ORIENT_RADIUS,
                          str(patches.device))
    flat = patches.reshape(patches.shape[0], -1)
    m = flat @ w
    return torch.atan2(m[:, 1], m[:, 0])

"""FAST-9/16 corner strength, gate and 3x3 NMS as dense tensor ops.

Counterpart of ``coebslam_tpu/ops/fast.py``. ``strength_and_score_plain``
is also the plain PyTorch version of the CUDA kernel in
``ops/fast_cuda.py`` (the port of ``fast_pallas._kernel``): it computes on
a zero-padded canvas exactly as that kernel does, and the kernel's wrapper
runs it for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, 16 points in circular order, as (dy, dx).
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LENGTH = 9  # FAST-9: at least 9 contiguous circle pixels


def strength_map(img, pad: str = "edge"):
    """Dense FAST-9/16 strength of [..., H, W] (no threshold gate).

    strength = max over the 16 arc starts of max(min over the 9-arc of the
    circle differences, -max over it). ``pad`` is "edge" (the reference
    ``fast.strength_map``) or "zero" (the Pallas/CUDA kernel's canvas).
    """
    H, W = img.shape[-2:]
    x3 = img.reshape(-1, H, W)
    if pad == "edge":
        padded = F.pad(x3, (3, 3, 3, 3), mode="replicate")
    else:
        padded = F.pad(x3, (3, 3, 3, 3))
    diffs = [padded[:, 3 + dy:3 + dy + H, 3 + dx:3 + dx + W] - x3
             for (dy, dx) in CIRCLE_OFFSETS]
    best = None
    for s in range(16):
        wmin = diffs[s]
        wmax = diffs[s]
        for j in range(1, ARC_LENGTH):
            d = diffs[(s + j) % 16]
            wmin = torch.minimum(wmin, d)
            wmax = torch.maximum(wmax, d)
        arc = torch.maximum(wmin, -wmax)
        best = arc if best is None else torch.maximum(best, arc)
    return best.reshape(img.shape)


def fast_score_map(img, threshold: float):
    """Dense FAST-9/16 score of [H, W]: the edge-padded strength where it
    exceeds ``threshold`` and lies 3 px inside the border, 0 elsewhere."""
    strength = strength_map(img)
    h, w = img.shape
    row = torch.arange(h, device=img.device)[:, None]
    col = torch.arange(w, device=img.device)[None, :]
    valid = (row >= 3) & (row < h - 3) & (col >= 3) & (col < w - 3)
    return torch.where(valid & (strength > threshold), strength,
                       torch.zeros_like(strength))


def nms_3x3(score):
    """Keep pixels that are the strict maximum of their 8-neighbourhood
    (-inf outside the image); [..., H, W]."""
    H, W = score.shape[-2:]
    x3 = score.reshape(-1, H, W)
    padded = F.pad(x3, (1, 1, 1, 1), value=float("-inf"))
    neigh = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            v = padded[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            neigh = v if neigh is None else torch.maximum(neigh, v)
    keep = x3 > neigh
    return torch.where(keep, x3, torch.zeros_like(x3)).reshape(score.shape)


def border_gate(strength, thr, hw):
    """Gate [L, H, W] strengths at ``strength > thr`` inside each level's
    true extent ``hw[l] = (h, w)`` minus a 3-px border."""
    L, H, W = strength.shape
    dev = strength.device
    row = torch.arange(H, device=dev)[None, :, None]
    col = torch.arange(W, device=dev)[None, None, :]
    h = hw[:, 0].to(dev)[:, None, None]
    w = hw[:, 1].to(dev)[:, None, None]
    inside = (row >= 3) & (row < h - 3) & (col >= 3) & (col < w - 3)
    return torch.where(inside & (strength > thr), strength,
                       torch.zeros_like(strength))


def strength_and_score_plain(canvas, thr, hw):
    """Plain version of the fused FAST kernel on a [L, H, W] canvas stack.

    Returns (strength, score), both [L, H, W] float32: the zero-padded
    strength, and the strength gated at ``thr`` inside each level's true
    extent minus 3 px, then strict-3x3-NMS'd.
    """
    strength = strength_map(canvas, pad="zero")
    return strength, nms_3x3(border_gate(strength, thr, hw))


def _parab_offsets(c, lx, rx, uy, dy_):
    def parab(lo, mid, hi):
        denom = lo - 2.0 * mid + hi
        big = torch.abs(denom) > 1e-6
        off = torch.where(
            big, 0.5 * (lo - hi) / torch.where(big, denom,
                                               torch.ones_like(denom)),
            torch.zeros_like(denom))
        return torch.clamp(off, -0.5, 0.5)

    return torch.stack([parab(uy, c, dy_), parab(lx, c, rx)], dim=-1)


def subpixel_refine(strength, yx):
    """Quadratic sub-pixel offsets (dy, dx) in [-0.5, 0.5] of corners
    ``yx`` [N, 2] on one [H, W] strength map: a parabola through the
    values at (p-1, p, p+1) along each axis."""
    h, w = strength.shape
    y = torch.clamp(yx[:, 0], 1, h - 2)
    x = torch.clamp(yx[:, 1], 1, w - 2)
    return _parab_offsets(strength[y, x], strength[y, x - 1],
                          strength[y, x + 1], strength[y - 1, x],
                          strength[y + 1, x])


def subpixel_refine_levels(strength, level, yx):
    """Quadratic sub-pixel offsets (dy, dx) in [-0.5, 0.5] of corners
    ``yx`` [N, 2] on levels ``level`` [N] of a [L, H, W] strength stack
    (the reference's ``subpixel_refine``, batched over levels)."""
    _, h, w = strength.shape
    y = torch.clamp(yx[:, 0], 1, h - 2)
    x = torch.clamp(yx[:, 1], 1, w - 2)
    return _parab_offsets(strength[level, y, x], strength[level, y, x - 1],
                          strength[level, y, x + 1],
                          strength[level, y - 1, x],
                          strength[level, y + 1, x])

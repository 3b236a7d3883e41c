"""Pyramidal Lucas-Kanade optical flow and Harris / Shi-Tomasi corners.

Counterpart of ``coebslam_tpu/ops/lk_flow.py``, the stand-ins for the
OpenCV calls of the reference's motion check (goodFeaturesToTrack with
the Harris response, cornerSubPix, calcOpticalFlowPyrLK). Everything is
batched over the N tracked points: patches are bilinear [N, W, W] gathers
and the LK normal equations are 2x2 closed-form solves. The reference's
``lax.fori_loop`` of LK steps is a Python loop here (a fixed count of
steps per level, no early exit, as there).
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from . import fast as fast_mod
from . import grid_select, pyramid


# --------------------------------------------------------------------- #
# corner selection (goodFeaturesToTrack semantics)
# --------------------------------------------------------------------- #

def edge_pad(img, left=1, right=1, top=1, bottom=1):
    """[H, W] padded by repeating its border (``jnp.pad(mode="edge")``)."""
    return F.pad(img[None, None], (left, right, top, bottom),
                 mode="replicate")[0, 0]


def sobel(img):
    """Unscaled 3x3 Sobel gradients (gx, gy) with edge padding."""
    p = edge_pad(img)
    gx = (p[1:-1, 2:] - p[1:-1, :-2]) * 2.0 \
        + (p[:-2, 2:] - p[:-2, :-2]) + (p[2:, 2:] - p[2:, :-2])
    gy = (p[2:, 1:-1] - p[:-2, 1:-1]) * 2.0 \
        + (p[2:, 2:] - p[:-2, 2:]) + (p[2:, :-2] - p[:-2, :-2])
    return gx, gy


def _structure_tensor(img, block: int = 3):
    """Per-pixel 2x2 structure tensor (a, b, c) = (gx², gx·gy, gy²) of the
    Sobel gradients / 8, summed over a ``block`` x ``block`` window."""
    gx, gy = sobel(img)
    gx = gx / 8.0
    gy = gy / 8.0
    h, w = img.shape
    r = block // 2

    def box(x):
        p = edge_pad(x, r, r, r, r)
        out = torch.zeros_like(x)
        for dy in range(block):
            for dx in range(block):
                out = out + p[dy:dy + h, dx:dx + w]
        return out

    return box(gx * gx), box(gx * gy), box(gy * gy)


def harris_response(img, k: float = 0.04, block: int = 3):
    """Harris corner response det - k trace² (the reference's k = 0.04)."""
    a, b, c = _structure_tensor(img, block)
    det = a * c - b * b
    trace = a + c
    return det - k * trace * trace


def min_eig_response(img, block: int = 3):
    """Shi-Tomasi response: the structure tensor's smaller eigenvalue
    (goodFeaturesToTrack's default)."""
    a, b, c = _structure_tensor(img, block)
    half_tr = 0.5 * (a + c)
    rad = torch.sqrt(torch.clamp(half_tr * half_tr - (a * c - b * b),
                                 min=0.0))
    return half_tr - rad


def good_features(img, n_points: int, quality: float = 0.01,
                  min_distance: int = 8, use_harris: bool = True):
    """Up to ``n_points`` corners: the Harris response (or with
    ``use_harris=False`` the Shi-Tomasi one) above ``quality`` x the
    maximum, strict 3x3 maxima, the strongest per ``min_distance`` cell
    (ties to the lowest index), with a quadratic sub-pixel offset.
    Returns (uv [n, 2] float32 (x, y), -1 where invalid; valid [n])."""
    resp = harris_response(img) if use_harris else min_eig_response(img)
    resp = torch.where(resp > quality * torch.max(resp), resp,
                       torch.zeros_like(resp))
    resp_nms = fast_mod.nms_3x3(resp)
    yx, _, valid = grid_select.select_grid_topk(
        resp_nms[None], cell_size=max(min_distance, 4), k_per_cell=1,
        n_out=n_points)
    yx, valid = yx[0], valid[0]
    off = fast_mod.subpixel_refine(resp, yx)
    uv = torch.stack([yx[:, 1] + off[:, 1], yx[:, 0] + off[:, 0]], dim=-1)
    return torch.where(valid[:, None], uv, torch.full_like(uv, -1.0)), valid


# --------------------------------------------------------------------- #
# bilinear patch sampling
# --------------------------------------------------------------------- #

def bilinear_gather(img, centers, size: int):
    """[N, size, size] patches of ``img`` [H, W] around float ``centers``
    [N, 2] (x, y), bilinearly interpolated and edge-clamped."""
    h, w = img.shape
    half = (size - 1) / 2.0
    d = torch.arange(size, dtype=torch.float32, device=img.device) - half
    xs = centers[:, 0:1] + d[None, :]                 # [N, size]
    ys = centers[:, 1:2] + d[None, :]
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, h - 2)
    fx = torch.clamp(xs - x0, 0.0, 1.0)[:, None, :]   # [N, 1, size(x)]
    fy = torch.clamp(ys - y0, 0.0, 1.0)[:, :, None]   # [N, size(y), 1]
    yi = y0[:, :, None]
    xi = x0[:, None, :]
    v00 = img[yi, xi]
    v01 = img[yi, xi + 1]
    v10 = img[yi + 1, xi]
    v11 = img[yi + 1, xi + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


# --------------------------------------------------------------------- #
# pyramidal LK
# --------------------------------------------------------------------- #

@functools.lru_cache(maxsize=8)
def _unit_steps(device: str):
    """The one-pixel steps (1, 0) and (0, 1) on ``device``, made once (an
    upload per call would wait for the queued work on the card)."""
    eye = torch.eye(2, dtype=torch.float32).to(device)
    return eye[0], eye[1]


class FlowResult(NamedTuple):
    points: torch.Tensor    # [N, 2] tracked positions in the next image
    valid: torch.Tensor     # [N] bool — ended in bounds with a finite error
    error: torch.Tensor     # [N] mean |residual| over the window


def lk_flow(prev_levels: List[torch.Tensor], next_levels: List[torch.Tensor],
            points, *, window: int = 21, iterations: int = 10
            ) -> FlowResult:
    """Track ``points`` ([N, 2] (x, y) in level-0 pixels of the previous
    image) into the next one, coarse to fine over matching pyramids
    (levels aligned by their width ratio), ``iterations`` Gauss-Newton
    steps per level."""
    n_levels = len(prev_levels)
    w0 = prev_levels[0].shape[1]
    scales = [prev_levels[l].shape[1] / w0 for l in range(n_levels)]
    ex, ey = _unit_steps(str(points.device))
    v = torch.zeros_like(points)          # displacement at this level

    for lvl in range(n_levels - 1, -1, -1):
        prev_img = prev_levels[lvl]
        next_img = next_levels[lvl]
        p_lvl = points * scales[lvl]
        if lvl != n_levels - 1:
            v = v * (scales[lvl] / scales[lvl + 1])

        patch_prev = bilinear_gather(prev_img, p_lvl, window)
        # Central-difference gradients of the previous patch.
        ix = 0.5 * (bilinear_gather(prev_img, p_lvl + ex, window)
                    - bilinear_gather(prev_img, p_lvl - ex, window))
        iy = 0.5 * (bilinear_gather(prev_img, p_lvl + ey, window)
                    - bilinear_gather(prev_img, p_lvl - ey, window))
        gxx = torch.sum(ix * ix, dim=(1, 2))
        gxy = torch.sum(ix * iy, dim=(1, 2))
        gyy = torch.sum(iy * iy, dim=(1, 2))
        det = gxx * gyy - gxy * gxy
        det_safe = torch.where(torch.abs(det) < 1e-6,
                               torch.full_like(det, 1e-6), det)

        for _ in range(iterations):
            di = patch_prev - bilinear_gather(next_img, p_lvl + v, window)
            bx = torch.sum(di * ix, dim=(1, 2))
            by = torch.sum(di * iy, dim=(1, 2))
            dvx = (gyy * bx - gxy * by) / det_safe
            dvy = (gxx * by - gxy * bx) / det_safe
            v = v + torch.stack([dvx, dvy], dim=-1)

    tracked = points + v
    h, w = next_levels[0].shape
    in_bounds = (tracked[:, 0] >= 0) & (tracked[:, 0] < w - 1) \
        & (tracked[:, 1] >= 0) & (tracked[:, 1] < h - 1)
    patch_next = bilinear_gather(next_levels[0], tracked, window)
    patch_prev0 = bilinear_gather(prev_levels[0], points, window)
    err = torch.mean(torch.abs(patch_prev0 - patch_next), dim=(1, 2))
    valid = in_bounds & torch.isfinite(err)
    return FlowResult(points=tracked, valid=valid, error=err)


def build_flow_pyramid(img, n_levels: int = 4) -> List[torch.Tensor]:
    """A 2x pyramid for LK: each level the antialiased linear resize of
    the previous one to half its size (rounded down)."""
    levels = [img]
    for _ in range(1, n_levels):
        h, w = levels[-1].shape
        levels.append(pyramid.resize_bilinear(levels[-1], (h // 2, w // 2)))
    return levels

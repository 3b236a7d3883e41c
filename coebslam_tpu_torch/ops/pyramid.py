"""Image pyramid and separable Gaussian blur.

Counterpart of ``coebslam_tpu/ops/pyramid.py``. The reference resizes with
``jax.image.resize(method="linear")``, which on downscale antialiases: it
is a scale-and-translate with a triangle kernel stretched by the inverse
scale. ``F.interpolate`` does not compute that (plain bilinear differs by up
to ~100 grey levels), so ``resize_bilinear`` builds the same per-axis
weight matrices in float32 and applies them as two float32 products.
"""
from __future__ import annotations

import functools
import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from ..config import OrbConfig


def pyramid_shapes(height: int, width: int, n_levels: int,
                   scale_factor: float) -> List[Tuple[int, int]]:
    """Static per-level (H, W) — matches cv::resize round semantics."""
    shapes = [(height, width)]
    for lvl in range(1, n_levels):
        inv = 1.0 / (scale_factor ** lvl)
        shapes.append((int(round(height * inv)), int(round(width * inv))))
    return shapes


def resize_weights(in_size: int, out_size: int, device=None):
    """[in, out] float32 weights of an antialiased linear resize along one
    axis (the computation of jax.image's ``compute_weight_mat`` with a
    triangle kernel and zero translation)."""
    f32 = torch.float32
    scale = out_size / in_size
    inv_scale = torch.tensor(1.0 / scale, dtype=f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=f32) + 0.5) * inv_scale
                - torch.tensor(0.0 * (1.0 / scale), dtype=f32) - 0.5)
    x = torch.abs(sample_f[None, :]
                  - torch.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(
        torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps,
        w / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    return w.to(device)


@functools.lru_cache(maxsize=64)
def _weights_cached(in_size: int, out_size: int, device: str):
    return resize_weights(in_size, out_size, device)


def resize_bilinear(img, out_shape: Tuple[int, int]):
    """Antialiased linear resize of [..., H, W] to [..., h, w] (the values
    of ``jax.image.resize(method="linear")``)."""
    h, w = img.shape[-2:]
    out = img
    if out_shape[0] != h:
        wh = _weights_cached(h, out_shape[0], str(img.device))
        out = torch.einsum("...hw,hy->...yw", out, wh)
    if out_shape[1] != w:
        ww = _weights_cached(w, out_shape[1], str(img.device))
        out = torch.einsum("...yw,wx->...yx", out, ww)
    return out


def build_pyramid(img, cfg: OrbConfig) -> List[torch.Tensor]:
    """[H, W] float32 -> n_levels images, each resized from the previous
    one (the reference's cascade)."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, cfg.n_levels, cfg.scale_factor)
    levels = [img]
    for lvl in range(1, cfg.n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[lvl]))
    return levels


def rgb_to_gray(img_rgb):
    """[H, W, 3] uint8 or float -> [H, W] float32 luma with
    cv::cvtColor's RGB2GRAY coefficients."""
    img = img_rgb.to(torch.float32)
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


@functools.lru_cache(maxsize=8)
def gaussian_kernel_1d(ksize: int = 7, sigma: float = 2.0) -> tuple:
    """1-D Gaussian taps (cv::getGaussianKernel for sigma > 0)."""
    half = (ksize - 1) / 2.0
    taps = [math.exp(-((i - half) ** 2) / (2.0 * sigma * sigma))
            for i in range(ksize)]
    s = sum(taps)
    return tuple(t / s for t in taps)


@functools.lru_cache(maxsize=8)
def _taps(ksize: int, sigma: float, dtype, device: str):
    return torch.tensor(gaussian_kernel_1d(ksize, sigma), dtype=dtype).to(device)


def gaussian_blur(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur of [..., H, W] with reflect-101 borders; taps
    are summed in the reference's order."""
    taps = _taps(ksize, sigma, img.dtype, str(img.device))
    pad = ksize // 2
    H, W = img.shape[-2:]
    x3 = img.reshape(-1, H, W)
    x = F.pad(x3, (pad, pad, 0, 0), mode="reflect")
    acc = taps[0] * x[..., :, 0:W]
    for i in range(1, ksize):
        acc = acc + taps[i] * x[..., :, i:i + W]
    x = F.pad(acc, (0, 0, pad, pad), mode="reflect")
    acc = taps[0] * x[..., 0:H, :]
    for i in range(1, ksize):
        acc = acc + taps[i] * x[..., i:i + H, :]
    return acc.reshape(img.shape)

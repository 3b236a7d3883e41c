"""Rotation-steered 256-bit BRIEF descriptors.

Counterpart of ``coebslam_tpu/ops/brief.py``; the test-point pattern is
generated by the same seeded numpy recipe, so the two packages share it
bit for bit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

N_BITS = 256
_PATTERN_SEED = 20240817
_PATTERN_CLIP = 13


@functools.lru_cache(maxsize=1)
def brief_pattern():
    """[256, 2, 2] int32 — (pair, point{a,b}, (y, x)) test coordinates."""
    rng = np.random.RandomState(_PATTERN_SEED)
    sigma = 31.0 / 5.0
    pts = rng.randn(N_BITS, 2, 2) * sigma
    pts = np.clip(np.round(pts), -_PATTERN_CLIP, _PATTERN_CLIP).astype(np.int32)
    for i in range(N_BITS):
        while (pts[i, 0] == pts[i, 1]).all():
            pts[i, 1] = np.clip(np.round(rng.randn(2) * sigma),
                                -_PATTERN_CLIP, _PATTERN_CLIP).astype(np.int32)
    return pts


@functools.lru_cache(maxsize=4)
def _pattern_on(device: str):
    return torch.from_numpy(brief_pattern()).to(device, torch.float32)


def describe(patches, angles):
    """Steered-BRIEF bits [N, 256] uint8 from patches [N, P, P] and angles
    [N]: bit b = 1 iff I(a) < I(b) after rotating the pattern."""
    n, p, _ = patches.shape
    pc = p // 2
    pat = _pattern_on(str(patches.device))
    py = pat[..., 0]
    px = pat[..., 1]
    cos = torch.cos(angles)[:, None, None]
    sin = torch.sin(angles)[:, None, None]
    rx = torch.round(px[None] * cos - py[None] * sin).to(torch.int64)
    ry = torch.round(px[None] * sin + py[None] * cos).to(torch.int64)
    rx = torch.clamp(rx + pc, 0, p - 1)
    ry = torch.clamp(ry + pc, 0, p - 1)
    flat = patches.reshape(n, p * p)
    idx = (ry * p + rx).reshape(n, -1)
    vals = torch.gather(flat, 1, idx).reshape(n, N_BITS, 2)
    return (vals[..., 0] < vals[..., 1]).to(torch.uint8)


def pack_bits(bits):
    """[N, 256] {0,1} -> [N, 32] uint8 packed little-endian within bytes."""
    n = bits.shape[0]
    shifts = torch.arange(8, device=bits.device, dtype=torch.int64)
    b = bits.reshape(n, 32, 8).to(torch.int64) << shifts
    return b.sum(-1).to(torch.uint8)


def unpack_bits(packed):
    """[..., 32] uint8 -> [..., 256] {0,1} uint8."""
    shifts = torch.arange(8, device=packed.device, dtype=torch.uint8)
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], N_BITS)


def to_signed(bits):
    """{0,1} bits -> +-1 float32 for the Hamming product (exact: the dot
    products are even integers in [-256, 256])."""
    return bits.to(torch.float32) * 2.0 - 1.0

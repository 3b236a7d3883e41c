"""Descriptor matching: Hamming distance products + masked selection.

Counterpart of ``coebslam_tpu/ops/matching.py``. The [N, M] Hamming matrix
is one float32 product of +-1 descriptors (exact: dot products are even
integers in [-256, 256]); search windows and gates are additive penalties;
selection is a row-wise argmin (first index on ties, as in the reference)
with ratio test, mutual check and rotation-histogram filter.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .brief import N_BITS

BIG = 1e9


def hamming_matrix(signed_a, signed_b):
    """[N, 256] x [M, 256] +-1 descriptors -> [N, M] float32 distances."""
    dot = signed_a @ signed_b.T
    return 0.5 * (N_BITS - dot)


class MatchResult(NamedTuple):
    idx: torch.Tensor        # [N] int64 best column per row (-1 invalid)
    dist: torch.Tensor       # [N] float32 best distance
    valid: torch.Tensor      # [N] bool


def match(dist_matrix, *, max_distance: float, ratio: Optional[float] = None,
          mutual: bool = False, row_valid=None, col_valid=None) -> MatchResult:
    """Row-wise nearest neighbour with the reference's gates."""
    d = dist_matrix
    if col_valid is not None:
        d = d + torch.where(col_valid[None, :], 0.0, BIG)
    best_idx = torch.argmin(d, dim=1)
    best = torch.amin(d, dim=1)
    if d.shape[1] > 1:
        col = torch.arange(d.shape[1], device=d.device)
        d2 = torch.where(col[None, :] == best_idx[:, None],
                         torch.full_like(d, BIG), d)
    else:
        d2 = d
    second = torch.amin(d2, dim=1)

    ok = best <= max_distance
    if ratio is not None:
        ok = ok & (best < ratio * second)
    if mutual:
        col_best_row = torch.argmin(d, dim=0)
        ok = ok & (col_best_row[best_idx]
                   == torch.arange(d.shape[0], device=d.device))
    if row_valid is not None:
        ok = ok & row_valid
    return MatchResult(torch.where(ok, best_idx, torch.full_like(best_idx, -1)),
                       best, ok)


def window_penalty(uv_query, uv_target, radius):
    """[N, M] additive penalty: 0 inside a square search window around each
    query, BIG outside (the candidate set of Frame::GetFeaturesInArea).
    ``radius`` is a scalar or an [N] per-query radius."""
    dx = torch.abs(uv_query[:, None, 0] - uv_target[None, :, 0])
    dy = torch.abs(uv_query[:, None, 1] - uv_target[None, :, 1])
    r = radius[:, None] if isinstance(radius, torch.Tensor) \
        and radius.dim() > 0 else radius
    inside = (dx <= r) & (dy <= r)
    return torch.where(inside, 0.0, BIG)


def level_penalty(level_query, level_target, min_shift: int, max_shift: int):
    """[N, M] additive penalty: 0 where the target's octave lies within
    [level_query + min_shift, level_query + max_shift], BIG elsewhere
    (SearchByProjection's octave window)."""
    diff = level_target[None, :] - level_query[:, None]
    ok = (diff >= min_shift) & (diff <= max_shift)
    return torch.where(ok, 0.0, BIG)


def stereo_penalty(ur_pred, ur_target, radius):
    """[N, M] additive penalty on the right coordinate: 0 where
    |ur_pred - ur_target| <= ``radius`` (a scalar or [N]) or the target has
    no depth (ur_target < 0), BIG elsewhere."""
    d = torch.abs(ur_pred[:, None] - ur_target[None, :])
    r = radius[:, None] if isinstance(radius, torch.Tensor) \
        and radius.dim() > 0 else radius
    ok = (ur_target[None, :] < 0) | (d <= r)
    return torch.where(ok, 0.0, BIG)


def rotation_consistency(angles_query, angles_target, match: MatchResult,
                         histo_length: int = 30, top_bins: int = 3):
    """Keep matches whose angle difference falls in the 3 most popular
    histogram bins (bins 2/3 only within 10% of the top count)."""
    dev = angles_query.device
    matched = angles_target[torch.clamp(match.idx, min=0)]
    rot = angles_query - matched
    two_pi = torch.full((), 2.0 * math.pi, dtype=torch.float32, device=dev)
    # Python-style float modulo as the reference computes it (fmod, then
    # shift a negative remainder by the divisor).
    rot = torch.fmod(rot, two_pi)
    rot = torch.where((rot != 0) & (rot < 0), rot + two_pi, rot)
    bins = torch.clamp((rot * histo_length / two_pi).to(torch.int64),
                       0, histo_length - 1)
    onehot = bins[:, None] == torch.arange(histo_length, device=dev)[None, :]
    counts = torch.sum(onehot & match.valid[:, None], dim=0)
    top_counts, top_idx = torch.sort(counts, descending=True, stable=True)
    top_counts, top_idx = top_counts[:top_bins], top_idx[:top_bins]
    keep_bin = torch.zeros(histo_length, dtype=torch.bool, device=dev)
    keep_bin = keep_bin.index_put(
        (top_idx,), top_counts.to(torch.float32) > 0.1 * top_counts[0])
    ok = match.valid & keep_bin[bins]
    return MatchResult(torch.where(ok, match.idx,
                                   torch.full_like(match.idx, -1)),
                       match.dist, ok)

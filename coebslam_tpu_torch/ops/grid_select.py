"""Spatially-uniform keypoint selection: per-cell top-k + round-robin rank.

Counterpart of ``coebslam_tpu/ops/grid_select.py``, batched over a leading
level axis. Ties order as in the reference: ``lax.top_k`` and
``jnp.argsort`` put the lowest index first, and ``torch.topk`` promises no
order on ties, so both selections here are stable sorts.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def select_grid_topk(score_map, cell_size: int, k_per_cell: int, n_out: int):
    """Select up to ``n_out`` keypoints per level from [L, H, W] scores.

    Returns:
      yx:     [L, n_out, 2] int64 (row, col), zeros where invalid.
      scores: [L, n_out] float32.
      valid:  [L, n_out] bool.
    """
    L, h, w = score_map.shape
    dev = score_map.device
    pad_h = (-h) % cell_size
    pad_w = (-w) % cell_size
    padded = F.pad(score_map, (0, pad_w, 0, pad_h))
    ncy, ncx = (h + pad_h) // cell_size, (w + pad_w) // cell_size
    cells = padded.reshape(L, ncy, cell_size, ncx, cell_size)
    cells = cells.permute(0, 1, 3, 2, 4).reshape(L, ncy * ncx,
                                                 cell_size * cell_size)

    k = min(k_per_cell, cell_size * cell_size)
    srt, idx = torch.sort(cells, dim=-1, descending=True, stable=True)
    top_scores, top_idx = srt[..., :k], idx[..., :k]

    cell_ids = torch.arange(ncy * ncx, device=dev)
    cy = (cell_ids // ncx) * cell_size
    cx = (cell_ids % ncx) * cell_size
    rows = cy[:, None] + top_idx // cell_size
    cols = cx[:, None] + top_idx % cell_size

    flat_scores = top_scores.reshape(L, -1)
    flat_rows = rows.reshape(L, -1)
    flat_cols = cols.reshape(L, -1)
    ranks = torch.arange(k, device=dev).expand(ncy * ncx, k).reshape(-1)

    valid_cand = flat_scores > 0.0
    # Key: rank dominates, score breaks ties (desc); computed in float32
    # exactly as the reference (the 1e6 scale rounds low score bits away,
    # and the resulting ties fall back to the index order).
    key = ranks.to(torch.float32) * 1e6 - flat_scores
    key = torch.where(valid_cand, key, torch.full_like(key, float("inf")))

    n_cand = key.shape[1]
    if n_cand < n_out:
        pad = n_out - n_cand
        key = F.pad(key, (0, pad), value=float("inf"))
        flat_scores = F.pad(flat_scores, (0, pad))
        flat_rows = F.pad(flat_rows, (0, pad))
        flat_cols = F.pad(flat_cols, (0, pad))
        valid_cand = F.pad(valid_cand, (0, pad))

    order = torch.sort(key, dim=-1, stable=True).indices[:, :n_out]
    sel_scores = torch.gather(flat_scores, 1, order)
    sel_valid = torch.gather(valid_cand, 1, order)
    yx = torch.stack([torch.gather(flat_rows, 1, order),
                      torch.gather(flat_cols, 1, order)], dim=-1)
    yx = torch.where(sel_valid[..., None], yx, torch.zeros_like(yx))
    return yx, torch.where(sel_valid, sel_scores,
                           torch.zeros_like(sel_scores)), sel_valid

"""ORB feature extraction: the full front-end pipeline of one frame.

Counterpart of ``coebslam_tpu/ops/extractor.py``: pyramid -> FAST on every
level -> per-cell top-k -> geometric per-level budgets (runtime-scalable)
-> COEB dynamic masking (post-selection culling, or pre-selection culling
with raised thresholds and a 0.7x budget in area mode) -> Gaussian blur,
orientation and steered BRIEF. All levels sit in one zero-padded
[L, H, W] canvas, and FAST runs on the whole stack through
``fast_cuda.strength_and_score``: one kernel launch per frame on the card.
The per-level loop of the reference is batched over the level axis;
patches, orientations and descriptors are computed for the final
``max_keypoints`` slots only (the reference computes them per level and
then compacts; the values are the same).
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple

import torch

from ..config import OrbConfig
from . import brief, fast, fast_cuda, grid_select, patches, pyramid


class Features(NamedTuple):
    """Fixed-capacity keypoint set for one frame."""

    uv: torch.Tensor           # [N, 2] float32 (u=x, v=y) at level-0 scale
    level: torch.Tensor        # [N] int64 pyramid level
    score: torch.Tensor        # [N] float32 FAST corner score
    angle: torch.Tensor        # [N] float32 orientation (radians)
    desc: torch.Tensor         # [N, 32] uint8 packed BRIEF-256
    valid: torch.Tensor        # [N] bool

    @property
    def n(self) -> int:
        return self.uv.shape[0]

    def signed_desc(self):
        return brief.to_signed(brief.unpack_bits(self.desc))


def level_budgets(cfg: OrbConfig) -> List[int]:
    """Static per-level slot capacities summing to max_keypoints."""
    f = 1.0 / cfg.scale_factor
    total = cfg.max_keypoints
    share = (1.0 - f) / (1.0 - f ** cfg.n_levels)
    caps = [int(total * share * (f ** l)) for l in range(cfg.n_levels)]
    caps[0] += total - sum(caps)
    return caps


class _Tables(NamedTuple):
    """Per-configuration constants of ``extract`` on one device."""
    quota_share: torch.Tensor  # [L] f32 share of the budget per level
    thr: torch.Tensor          # [2] f32 (normal, area-mode) FAST threshold
    hw: torch.Tensor           # [L, 2] int32 true extent per level
    scales: torch.Tensor       # [L] f32
    caps: torch.Tensor         # [L] int64 static slot capacity per level
    level_of: torch.Tensor     # [max_keypoints] int64 level of each slot
    slot_of: torch.Tensor      # [max_keypoints] int64 slot within level


@functools.lru_cache(maxsize=16)
def _tables(cfg: OrbConfig, height: int, width: int, device: str) -> _Tables:
    """Built once per (configuration, frame size, device): creating these
    from Python values on every frame would copy them to the card and
    synchronise the host each time."""
    f = 1.0 / cfg.scale_factor
    share = (1.0 - f) / (1.0 - f ** cfg.n_levels)
    L = cfg.n_levels
    caps = level_budgets(cfg)
    shapes = pyramid.pyramid_shapes(height, width, L, cfg.scale_factor)
    f32, i64 = torch.float32, torch.int64
    t = _Tables(
        quota_share=torch.tensor([share * (f ** l) for l in range(L)],
                                 dtype=f32),
        thr=torch.tensor([float(cfg.fast_threshold_min),
                          float(cfg.fast_threshold_min_masked)], dtype=f32),
        hw=torch.tensor(shapes, dtype=torch.int32),
        scales=torch.tensor([cfg.scale_factor ** l for l in range(L)],
                            dtype=f32),
        caps=torch.tensor(caps, dtype=i64),
        level_of=torch.tensor([l for l in range(L) for _ in range(caps[l])],
                              dtype=i64),
        slot_of=torch.tensor([s for l in range(L) for s in range(caps[l])],
                             dtype=i64))
    return _Tables(*[x.to(device) for x in t])


def level_canvas(img, cfg: OrbConfig):
    """The pyramid of a [H, W] frame as the FAST kernel takes it: a
    zero-padded [L, H, W] canvas (level l in ``canvas[l, :h_l, :w_l]``)
    and the [L, 2] int32 true extents."""
    H, W = img.shape
    levels = pyramid.build_pyramid(img, cfg)
    canv = torch.zeros((len(levels), H, W), dtype=torch.float32,
                       device=img.device)
    for l, li in enumerate(levels):
        canv[l, :li.shape[0], :li.shape[1]] = li
    return canv, _tables(cfg, H, W, str(img.device)).hw


def _runtime_quotas(share, n_features):
    """Per-level quotas for a runtime budget (a device scalar)."""
    return torch.ceil(share * n_features.to(torch.float32)).to(torch.int64)


def extract(img, cfg: OrbConfig, *, n_features=None, dynamic_mask=None,
            area_mode=None) -> Features:
    """Run the extraction pipeline on one [H, W] float32 frame in [0, 255].

    Args:
      n_features: runtime budget (0-d tensor; defaults to cfg.n_features).
      dynamic_mask: optional [H, W] bool, True where keypoints are forbidden.
      area_mode: optional 0-d bool tensor — the COEB area flag.
    Returns: Features with cfg.max_keypoints fixed slots.
    """
    dev = img.device
    i64, f32 = torch.int64, torch.float32
    if n_features is None:
        n_features = torch.full((), cfg.n_features, dtype=i64, device=dev)
    if area_mode is None:
        area_mode = torch.zeros((), dtype=torch.bool, device=dev)
    H, W = img.shape
    tab = _tables(cfg, H, W, str(dev))

    budget = torch.where(
        area_mode, (n_features * cfg.masked_budget_scale).to(i64), n_features)
    quotas = _runtime_quotas(tab.quota_share, budget)         # [L]

    caps = level_budgets(cfg)
    L = cfg.n_levels
    cap_max = max(caps)

    # The strength map is threshold-independent; the COEB threshold raise
    # is a different gate on the same map (min threshold, as the reference).
    thr = torch.where(area_mode, tab.thr[1], tab.thr[0])

    canv, hw = level_canvas(img, cfg)
    hs = hw[:, 0].to(i64)
    ws = hw[:, 1].to(i64)
    scales = tab.scales

    strength, score = fast_cuda.strength_and_score(canv, thr, hw)

    # Edge margin (EDGE_THRESHOLD) inside each level's true extent.
    m = cfg.edge_threshold
    row0 = torch.arange(H, device=dev)
    col0 = torch.arange(W, device=dev)
    inside = ((row0[None, :, None] >= m) & (row0[None, :, None] < hs[:, None, None] - m)
              & (col0[None, None, :] >= m) & (col0[None, None, :] < ws[:, None, None] - m))
    score = torch.where(inside, score, torch.zeros_like(score))

    lvl_mask = None
    if dynamic_mask is not None:
        # Nearest-sample the level-0 mask at each level's scale.
        sy = torch.clamp(((row0[None, :].to(f32) + 0.5) * H
                          / torch.clamp(hs, min=1)[:, None].to(f32)).to(i64),
                         0, H - 1)                             # [L, H]
        sx = torch.clamp(((col0[None, :].to(f32) + 0.5) * W
                          / torch.clamp(ws, min=1)[:, None].to(f32)).to(i64),
                         0, W - 1)                             # [L, W]
        lvl_mask = dynamic_mask[sy[:, :, None], sx[:, None, :]]  # [L, H, W]
        score = torch.where(area_mode & lvl_mask, torch.zeros_like(score),
                            score)

    yx, sc, valid = grid_select.select_grid_topk(
        score, cfg.cell_size, k_per_cell=8, n_out=cap_max)     # [L, cap, ...]
    slot = torch.arange(cap_max, device=dev)
    valid = valid & (slot[None] < tab.caps[:, None]) \
        & (slot[None] < quotas[:, None])
    if lvl_mask is not None:
        lidx = torch.arange(L, device=dev)[:, None]
        hit = lvl_mask[lidx, yx[..., 0], yx[..., 1]]
        valid = torch.where(area_mode, valid, valid & ~hit)

    # Static compaction [L, cap_max] -> [max_keypoints] (contiguous
    # per-level layout).
    level_of, slot_of = tab.level_of, tab.slot_of
    yx = yx[level_of, slot_of]
    scores = sc[level_of, slot_of]
    valids = valid[level_of, slot_of]

    # Reflect-101-fill each canvas beyond the true extent so blur and patch
    # sampling see the standalone per-level boundary handling.
    ry = torch.where(row0[None] < hs[:, None], row0[None],
                     torch.clamp(2 * hs[:, None] - 2 - row0[None], min=0))
    rx = torch.where(col0[None] < ws[:, None], col0[None],
                     torch.clamp(2 * ws[:, None] - 2 - col0[None], min=0))
    lidx = torch.arange(L, device=dev)[:, None, None]
    refl = canv[lidx, torch.clamp(ry, 0, H - 1)[:, :, None],
                torch.clamp(rx, 0, W - 1)[:, None, :]]
    blurred = pyramid.gaussian_blur(refl)
    pt = patches.gather_patches(blurred, level_of, yx)
    angles = patches.orientations(pt)

    # Sub-pixel corner positions mapped to level-0 coordinates under the
    # half-pixel-centre convention x0 = (x_l + 0.5) * scale - 0.5.
    off = fast.subpixel_refine_levels(strength, level_of, yx)
    scale = scales[level_of]
    uv = torch.stack(
        [(yx[:, 1].to(f32) + off[:, 1] + 0.5) * scale - 0.5,
         (yx[:, 0].to(f32) + off[:, 0] + 0.5) * scale - 0.5], dim=-1)

    desc = brief.pack_bits(brief.describe(pt, angles))
    uv = torch.where(valids[:, None], uv, torch.full_like(uv, -1.0))
    zero = torch.zeros_like(scores)
    return Features(uv=uv, level=level_of,
                    score=torch.where(valids, scores, zero),
                    angle=torch.where(valids, angles, zero),
                    desc=desc, valid=valids)

"""COEB dynamic-scene front-end of the realtime path.

Counterpart of ``DynState``, ``init_dyn_state``, ``classify_boxes`` and
``dynamic_step`` of ``coebslam_tpu/slam/dynamic.py``: the motion check
matches the previous frame's keypoints to the current ones, fits F by
RANSAC, and takes epipolar outliers as the dynamic point set T_M; boxes are
classified by T_M density or blur + T_M, dynamic boxes mask keypoints for
``sticky_frames`` frames, and the masked area drives the next frame's
extractor (area flag). The LK motion check of the host path is not part of
this slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import SystemConfig
from ..ops import blur as blur_ops
from ..ops import brief, fundamental, matching


class DynState(NamedTuple):
    """Dynamic-front-end state chained across frames."""
    prev_uv: torch.Tensor      # [N, 2] previous frame keypoints
    prev_desc: torch.Tensor    # [N, 32] packed BRIEF
    prev_valid: torch.Tensor   # [N] bool
    sticky: torch.Tensor       # [H, W] int64 — frames a pixel stays masked
    area_flag: torch.Tensor    # bool — fed to the NEXT frame's extractor


class DynInfo(NamedTuple):
    """Per-frame diagnostics."""
    box_dynamic: torch.Tensor  # [B] bool
    box_blurred: torch.Tensor  # [B] bool
    n_outliers: torch.Tensor   # int64
    n_culled: torch.Tensor     # int64


def init_dyn_state(cfg: SystemConfig, device) -> DynState:
    N = cfg.orb.max_keypoints
    H, W = cfg.camera.height, cfg.camera.width
    return DynState(
        prev_uv=torch.full((N, 2), -1.0, device=device),
        prev_desc=torch.zeros((N, 32), dtype=torch.uint8, device=device),
        prev_valid=torch.zeros(N, dtype=torch.bool, device=device),
        sticky=torch.zeros((H, W), dtype=torch.int64, device=device),
        area_flag=torch.tensor(False, device=device))


def classify_boxes(outliers, outlier_valid, boxes, box_blurred,
                   cfg: SystemConfig):
    """Two-tier dynamic classification of [B, 4] boxes -> [B] bool."""
    dyn = cfg.dynamic
    x, y = outliers[:, 0], outliers[:, 1]
    in_box = ((x[None, :] >= boxes[:, 0:1]) & (x[None, :] <= boxes[:, 2:3])
              & (y[None, :] >= boxes[:, 1:2]) & (y[None, :] <= boxes[:, 3:4]))
    counts = (in_box & outlier_valid[None, :]).sum(-1)
    area = torch.clamp((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]),
                       min=1.0)
    present = boxes[:, 0] >= 0.0
    tier1 = counts.to(torch.float32) * dyn.box_density_scale > area
    tier2 = box_blurred & (counts >= 1)
    return present & (tier1 | tier2)


def dynamic_step(fd, gray, state: DynState, boxes, cfg: SystemConfig, *,
                 generator: Optional[torch.Generator] = None, idx=None):
    """Dynamic check + keypoint culling of one frame.

    Args:
      fd: FrameData (extraction done, pre-cull).
      gray: [H, W] float32 current frame.
      state: previous frame's DynState.
      boxes: [B, 4] padded detector boxes (xmin < 0 = absent).
      generator / idx: RANSAC sample source (see
        ``fundamental.find_fundamental_ransac``).
    Returns (fd_culled, spawn_ok [N] bool, new_state, DynInfo).
    """
    dyn = cfg.dynamic
    h, w = gray.shape
    feats = fd.feats

    # 1. Correspondences: previous keypoints -> current keypoints.
    prev_sd = brief.to_signed(brief.unpack_bits(state.prev_desc))
    d = matching.hamming_matrix(prev_sd, feats.signed_desc())
    du = torch.abs(state.prev_uv[:, None, 0] - feats.uv[None, :, 0])
    dv = torch.abs(state.prev_uv[:, None, 1] - feats.uv[None, :, 1])
    r = dyn.match_radius
    d = d + torch.where((du <= r) & (dv <= r), 0.0, matching.BIG)
    res = matching.match(d, max_distance=cfg.matcher.th_high,
                         ratio=cfg.matcher.nn_ratio_tracking, mutual=True,
                         row_valid=state.prev_valid, col_valid=feats.valid)
    p_prev = state.prev_uv
    p_cur = feats.uv[torch.clamp(res.idx, min=0)]
    good = res.valid

    # 2. F-RANSAC -> epipolar outliers (T_M).
    fres = fundamental.find_fundamental_ransac(
        p_prev, p_cur, good, idx=idx, generator=generator,
        n_hypotheses=dyn.f_ransac_iters, threshold=dyn.f_ransac_threshold)
    dist = fundamental.epipolar_distance(fres.F, p_prev, p_cur)
    enough = good.sum() >= 24
    t_m = good & (dist > dyn.epipolar_threshold) & enough

    # 3. Blur gate + two-tier classification.
    scores = blur_ops.box_blur_scores(gray, boxes)
    box_blurred = scores < dyn.blur_threshold
    box_dynamic = classify_boxes(p_cur, t_m, boxes, box_blurred, cfg)

    # 4. Sticky mask: dynamic boxes mask for sticky_frames frames.
    masks = blur_ops.box_mask(h, w, boxes)
    dyn_mask = torch.any(masks & box_dynamic[:, None, None], dim=0)
    sticky = torch.where(dyn_mask,
                         torch.full_like(state.sticky, max(dyn.sticky_frames, 1)),
                         torch.clamp(state.sticky - 1, min=0))
    active = sticky > 0
    area_flag = active.sum() > dyn.masked_area_limit * (h * w) / (480.0 * 640.0)

    # 5. Cull keypoints inside the active mask (post-selection culling).
    u = torch.clamp(torch.round(feats.uv[:, 0]).to(torch.int64), 0, w - 1)
    v = torch.clamp(torch.round(feats.uv[:, 1]).to(torch.int64), 0, h - 1)
    hit = active[v, u] & feats.valid
    new_valid = feats.valid & ~hit
    fd_culled = fd._replace(feats=feats._replace(
        valid=new_valid,
        uv=torch.where(new_valid[:, None], feats.uv,
                       torch.full_like(feats.uv, -1.0))))

    # 6. Never spawn landmarks inside any detector box.
    if dyn.spawn_in_boxes:
        spawn_ok = torch.ones(feats.uv.shape[0], dtype=torch.bool,
                              device=gray.device)
    else:
        present = boxes[:, 0] >= 0
        in_box = ((feats.uv[:, None, 0] >= boxes[None, :, 0])
                  & (feats.uv[:, None, 0] <= boxes[None, :, 2])
                  & (feats.uv[:, None, 1] >= boxes[None, :, 1])
                  & (feats.uv[:, None, 1] <= boxes[None, :, 3])
                  & present[None, :])
        spawn_ok = ~torch.any(in_box, dim=1)

    # 7. Next-frame state keeps the PRE-cull feature set.
    new_state = DynState(prev_uv=feats.uv, prev_desc=feats.desc,
                         prev_valid=feats.valid, sticky=sticky,
                         area_flag=area_flag)
    info = DynInfo(box_dynamic=box_dynamic, box_blurred=box_blurred,
                   n_outliers=t_m.sum(), n_culled=hit.sum())
    return fd_culled, spawn_ok, new_state, info

"""COEB dynamic-scene front-end: motion check, blur gate, box classifier.

Counterpart of ``coebslam_tpu/slam/dynamic.py``. Two motion checks:

- the reference's own (``motion_check="flow"``, ``dynamic_frontend``):
  Harris corners of the previous frame, pyramidal LK into the current one,
  the border and neighbourhood-difference filters, F-RANSAC, and the
  epipolar outliers form the dynamic point set T_M;
- the realtime redesign (``dynamic_step``, chained through ``DynState``):
  the previous frame's keypoints matched to the current ones by
  descriptor, F-RANSAC, epipolar outliers as T_M, with keypoint culling,
  the sticky mask and the area flag in the same frame program.

Boxes are classified by T_M density or blur + T_M; the masked area drives
the extractor's area mode. The F-RANSAC samples come from a
``torch.Generator`` or are given (``idx``), since a torch generator cannot
reproduce ``jax.random`` draws.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import SystemConfig
from ..ops import blur as blur_ops
from ..ops import brief, fundamental, lk_flow, matching


class DynamicResult(NamedTuple):
    """Output of the flow front-end (``dynamic_frontend``)."""
    mask: torch.Tensor          # [H, W] bool — keypoints forbidden
    area_flag: torch.Tensor     # bool — masked area over the limit
    box_dynamic: torch.Tensor   # [B] bool
    box_blurred: torch.Tensor   # [B] bool
    outliers: torch.Tensor      # [N, 2] tracked points (T_M where valid)
    outlier_valid: torch.Tensor  # [N] bool
    n_outliers: torch.Tensor    # int64


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


def moving_object_check(prev_gray, gray, cfg: SystemConfig, *,
                        generator: Optional[torch.Generator] = None,
                        idx=None):
    """The reference's motion check: Harris corners of ``prev_gray``,
    pyramidal LK into ``gray``, the border margin and the 3x3
    absolute-difference filter, F-RANSAC over what is left (samples from
    ``generator`` or ``idx``), and epipolar outliers.

    Returns (tracked points [N, 2] in ``gray``'s pixels, T_M mask [N]).
    """
    dyn = cfg.dynamic
    h, w = gray.shape
    pts, pts_valid = lk_flow.good_features(
        prev_gray, dyn.n_flow_points, quality=0.01, min_distance=8)
    flow = lk_flow.lk_flow(lk_flow.build_flow_pyramid(prev_gray),
                           lk_flow.build_flow_pyramid(gray), pts)

    m = float(dyn.flow_edge_margin)
    q = flow.points
    in_border = ((pts[:, 0] >= m) & (pts[:, 0] < w - m)
                 & (pts[:, 1] >= m) & (pts[:, 1] < h - m)
                 & (q[:, 0] >= m) & (q[:, 0] < w - m)
                 & (q[:, 1] >= m) & (q[:, 1] < h - m))
    diff_sum = torch.sum(torch.abs(lk_flow.bilinear_gather(prev_gray, pts, 3)
                                   - lk_flow.bilinear_gather(gray, q, 3)),
                         dim=(1, 2))
    good = pts_valid & flow.valid & in_border \
        & (diff_sum <= dyn.flow_diff_threshold)

    fres = fundamental.find_fundamental_ransac(
        pts, q, good, idx=idx, generator=generator,
        n_hypotheses=dyn.f_ransac_iters, threshold=dyn.f_ransac_threshold)
    d = fundamental.epipolar_distance(fres.F, pts, q)
    return q, good & (d > dyn.epipolar_threshold)


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


def dynamic_frontend(prev_gray, gray, boxes, cfg: SystemConfig, *,
                     generator: Optional[torch.Generator] = None,
                     idx=None) -> DynamicResult:
    """The flow path's frame: ``moving_object_check``, the Laplacian blur
    gate and the two-tier classification of the padded [B, 4] ``boxes``;
    the mask is the union of the dynamic boxes and the area limit scales
    with the resolution."""
    outliers, outlier_valid = moving_object_check(
        prev_gray, gray, cfg, generator=generator, idx=idx)
    box_blurred = blur_ops.box_blur_scores(gray, boxes) \
        < cfg.dynamic.blur_threshold
    box_dynamic = classify_boxes(outliers, outlier_valid, boxes, box_blurred,
                                 cfg)
    h, w = gray.shape
    masks = blur_ops.box_mask(h, w, boxes)
    mask = torch.any(masks & box_dynamic[:, None, None], dim=0)
    area_flag = mask.sum() > cfg.dynamic.masked_area_limit \
        * (h * w) / (480.0 * 640.0)
    return DynamicResult(mask=mask, area_flag=area_flag,
                         box_dynamic=box_dynamic, box_blurred=box_blurred,
                         outliers=outliers, outlier_valid=outlier_valid,
                         n_outliers=outlier_valid.sum())


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

"""Per-frame front-end: extraction + RGB-D depth association or stereo
row-band matching.

Counterpart of ``coebslam_tpu/slam/frame.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CameraConfig, OrbConfig
from ..geometry import camera as cam_ops
from ..ops import extractor, matching
from ..ops.extractor import Features


class FrameData(NamedTuple):
    feats: Features
    depth: torch.Tensor        # [N] float32 metres; 0 where unknown
    ur: torch.Tensor           # [N] float32 virtual right u; -1 where no depth
    inv_sigma2: torch.Tensor   # [N] float32 per-observation information
    obs: torch.Tensor          # [N, 3] (u, v, ur) observation vector

    @property
    def n(self):
        return self.depth.shape[0]


def level_inv_sigma2(levels, scale_factor: float):
    """1 / (scale^level)^2 per keypoint (mvInvLevelSigma2)."""
    sf = torch.full((), scale_factor, dtype=torch.float32,
                    device=levels.device)
    sigma2 = torch.pow(sf, levels.to(torch.float32)) ** 2
    return 1.0 / sigma2


def match_stereo(feats_l: Features, feats_r: Features, cam: CameraConfig,
                 orb: OrbConfig, row_tolerance: float = 2.0):
    """Rectified stereo matching of left keypoints against right keypoints
    in the same row band (Frame::ComputeStereoMatches): a row band scaled
    by the left keypoint's level, disparity in (0.1, fx), levels within 1,
    then the Hamming best with ratio and mutual checks.

    Returns (depth [N], ur [N]) for the left features; 0 / -1 where
    unmatched.
    """
    d = matching.hamming_matrix(feats_l.signed_desc(), feats_r.signed_desc())
    sf = torch.full((), orb.scale_factor, dtype=torch.float32,
                    device=d.device)
    scale_l = torch.pow(sf, feats_l.level.to(torch.float32))
    # The three penalties are added in the reference's order: each adds
    # BIG in float32, so the sums (and the max_distance gate) stay equal.
    dv = torch.abs(feats_l.uv[:, None, 1] - feats_r.uv[None, :, 1])
    d = d + torch.where(dv <= row_tolerance * scale_l[:, None], 0.0,
                        matching.BIG)
    disp = feats_l.uv[:, None, 0] - feats_r.uv[None, :, 0]
    d = d + torch.where((disp > 0.1) & (disp < cam.fx), 0.0, matching.BIG)
    dl = torch.abs(feats_l.level[:, None] - feats_r.level[None, :])
    d = d + torch.where(dl <= 1, 0.0, matching.BIG)

    res = matching.match(d, max_distance=100.0, ratio=0.9, mutual=True,
                         row_valid=feats_l.valid, col_valid=feats_r.valid)
    matched_disp = torch.gather(disp, 1,
                                torch.clamp(res.idx, min=0)[:, None])[:, 0]
    ok = res.valid & (matched_disp > 0.1)
    depth = torch.where(ok, cam.bf / torch.clamp(matched_disp, min=0.1),
                        torch.zeros_like(matched_disp))
    ur = torch.where(ok, feats_l.uv[:, 0] - matched_disp,
                     torch.full_like(matched_disp, -1.0))
    return depth, ur


def process_stereo(gray_left, gray_right, cam: CameraConfig, orb: OrbConfig,
                   *, n_features=None, dynamic_mask=None,
                   area_mode=None) -> FrameData:
    """The stereo Frame constructor: extract on both images, match along
    rows, make depth from disparity. ``dynamic_mask`` and ``area_mode``
    apply to the left extraction only; the right keypoints only serve the
    disparity search."""
    feats_l = extractor.extract(gray_left, orb, n_features=n_features,
                                dynamic_mask=dynamic_mask,
                                area_mode=area_mode)
    feats_r = extractor.extract(gray_right, orb, n_features=n_features)
    depth, ur = match_stereo(feats_l, feats_r, cam, orb)
    inv_s2 = level_inv_sigma2(feats_l.level, orb.scale_factor)
    obs = torch.cat([feats_l.uv, ur[:, None]], dim=-1)
    return FrameData(feats=feats_l, depth=depth, ur=ur, inv_sigma2=inv_s2,
                     obs=obs)


def process_rgbd(gray, depth_img, cam: CameraConfig, orb: OrbConfig, *,
                 n_features=None, dynamic_mask=None,
                 area_mode=None) -> FrameData:
    """Extract features and associate depth (the RGB-D Frame constructor).

    Args:
      gray: [H, W] float32 in [0, 255].
      depth_img: [H, W] float32 metres.
    """
    feats = extractor.extract(gray, orb, n_features=n_features,
                              dynamic_mask=dynamic_mask, area_mode=area_mode)
    # Depth lookup at the raw pixel, geometry with undistorted coordinates.
    u = torch.clamp(torch.round(feats.uv[:, 0]).to(torch.int64), 0, cam.width - 1)
    v = torch.clamp(torch.round(feats.uv[:, 1]).to(torch.int64), 0, cam.height - 1)
    d = depth_img[v, u]
    uv_un = cam_ops.undistort_points(cam, feats.uv)
    feats = feats._replace(uv=torch.where(feats.valid[:, None], uv_un,
                                          torch.full_like(uv_un, -1.0)))
    has_depth = feats.valid & (d > 0.0)
    d = torch.where(has_depth, d, torch.zeros_like(d))
    ur = torch.where(
        has_depth,
        feats.uv[:, 0] - cam.bf / torch.where(d > 0, d, torch.ones_like(d)),
        torch.full_like(d, -1.0))
    inv_s2 = level_inv_sigma2(feats.level, orb.scale_factor)
    obs = torch.cat([feats.uv, ur[:, None]], dim=-1)
    return FrameData(feats=feats, depth=d, ur=ur, inv_sigma2=inv_s2, obs=obs)

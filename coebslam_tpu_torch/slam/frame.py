"""Per-frame front-end: extraction + RGB-D depth association.

Counterpart of the RGB-D parts of ``coebslam_tpu/slam/frame.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CameraConfig, OrbConfig
from ..geometry import camera as cam_ops
from ..ops import extractor
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

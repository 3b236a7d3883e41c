"""Relocalization: BoW retrieval + alignment RANSAC + pose refinement.

Counterpart of ``coebslam_tpu/slam/relocalization.py`` (the reference's
``Tracking::Relocalization``): candidate keyframes from the keyframe
database, descriptor matching against each candidate's map points
(nn-ratio 0.75, >= 15 matches to attempt), a batched RANSAC pose solve,
refined by the robust pose Gauss-Newton, accepted at
``reloc_min_inliers``. The frame's depth coverage picks the solver:

* RGB-D: 3-point Horn alignment on back-projections scored by
  reprojection (``ops/procrustes.ransac_alignment``);
* depth-free (coverage below one half): batched EPnP
  (``ops/pnp.ransac_epnp``), the reference's own solver.

The host reads the card where the reference does: the depth coverage once
per call, the match and RANSAC counts once per candidate tried, the
refined count, and the accepted pose with its point ids. The RANSAC draws
come from a generator seeded 7, or from ``sampler`` (a test hook).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..geometry import camera as cam_ops
from ..geometry.se3 import SE3
from ..ops import brief, matching, pnp, procrustes
from ..ops.fundamental import RansacSampler, draw
from ..optim import pose_gn
from ..utils.device import resolve_device
from .frame import FrameData
from .keyframe_db import KeyFrameDatabase
from .map import MapArena

RELOC_SEED = 7


class RelocResult(NamedTuple):
    ok: bool
    R: Optional[np.ndarray]
    t: Optional[np.ndarray]
    point_ids: Optional[np.ndarray]    # per-slot map point ids (-1 none)
    n_inliers: int


_FAILED = RelocResult(False, None, None, None, 0)


class Relocalizer:
    def __init__(self, cfg: SystemConfig, arena: MapArena,
                 kf_db: KeyFrameDatabase, device=None,
                 sampler: Optional[RansacSampler] = None):
        self.cfg = cfg
        self.map = arena
        self.db = kf_db
        self.device = resolve_device(device, "Relocalizer")
        self.sampler = sampler
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(RELOC_SEED)

    def _up(self, a) -> torch.Tensor:
        """Host rows -> device, through pinned memory on the card, without
        waiting for queued device work."""
        t = torch.from_numpy(np.array(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _attempt(self, frame_signed, frame_valid, frame_uv, frame_pts_cam,
                 frame_has_depth, pt_signed, pt_valid, pt_pos):
        """Depth attempt: matching + 3D-3D Horn RANSAC."""
        cfg = self.cfg
        d = matching.hamming_matrix(frame_signed, pt_signed)
        res = matching.match(d, max_distance=cfg.matcher.th_low,
                             ratio=cfg.matcher.nn_ratio_bow, mutual=True,
                             row_valid=frame_valid & frame_has_depth,
                             col_valid=pt_valid)
        src = pt_pos[torch.clamp(res.idx, min=0)]        # world points
        H = cfg.ransac.pnp_iterations
        align = procrustes.ransac_alignment(
            src, frame_pts_cam, res.valid,
            idx=draw(self.sampler, self._gen, res.valid, H, 3),
            n_hypotheses=H, cam=cfg.camera, obs_uv=frame_uv,
            px_threshold=5.0)
        return res, align

    def _attempt_pnp(self, frame_signed, frame_valid, frame_uv, pt_signed,
                     pt_valid, pt_pos):
        """Depth-free attempt: matching + 2D-3D EPnP RANSAC."""
        cfg = self.cfg
        d = matching.hamming_matrix(frame_signed, pt_signed)
        res = matching.match(d, max_distance=cfg.matcher.th_low,
                             ratio=cfg.matcher.nn_ratio_bow, mutual=True,
                             row_valid=frame_valid, col_valid=pt_valid)
        X = pt_pos[torch.clamp(res.idx, min=0)]          # world points
        H = cfg.ransac.pnp_iterations
        sol = pnp.ransac_epnp(
            X, frame_uv, res.valid, cfg.camera,
            draw(self.sampler, self._gen, res.valid, H, 6))
        return res, sol

    def _refine(self, pose0, X, obs, inv_sigma2, valid):
        return pose_gn.optimize_pose(pose0, X, obs, inv_sigma2, valid,
                                     self.cfg.camera, self.cfg.optimizer)

    def relocalize(self, fd: FrameData, words: np.ndarray) -> RelocResult:
        """Try the candidates of the frame's words (``fd`` on the device)
        in order; the first refined pose with enough inliers wins."""
        cands = self.db.detect_relocalization_candidates(words)
        if len(cands) == 0:
            return _FAILED
        f = fd.feats
        frame_signed = f.signed_desc()
        has_depth = fd.depth > 0
        pts_cam = cam_ops.unproject(self.cfg.camera, f.uv, fd.depth)
        # Depth coverage picks the solver: Horn alignment needs 3D on the
        # frame side, EPnP does not.
        n_valid, n_depth = torch.stack(
            [f.valid.sum(), (has_depth & f.valid).sum()]).tolist()
        use_pnp = n_depth / max(n_valid, 1) < 0.5

        W = self.map.kf_uv.shape[1]
        for c in cands:
            c = int(c)
            obs = self.map.kf_obs_pt[c]
            slots = np.nonzero(obs >= 0)[0]
            if len(slots) < 15:
                continue
            pids = obs[slots]
            pids = pids[self.map.pt_valid[pids]]
            if len(pids) < 15:
                continue
            pad = np.zeros(W, np.int64)
            n = min(len(pids), W)
            pad[:n] = pids[:n]
            pt_valid = np.zeros(W, bool)
            pt_valid[:n] = True

            pt_signed = brief.to_signed(brief.unpack_bits(
                self._up(self.map.pt_desc[pad])))
            pt_pos = self._up(self.map.pt_pos[pad])
            pt_ok = self._up(pt_valid)
            if use_pnp:
                res, align = self._attempt_pnp(frame_signed, f.valid, f.uv,
                                               pt_signed, pt_ok, pt_pos)
            else:
                res, align = self._attempt(frame_signed, f.valid, f.uv,
                                           pts_cam, has_depth, pt_signed,
                                           pt_ok, pt_pos)
            n_match, n_align = torch.stack(
                [res.valid.sum(), align.n_inliers]).tolist()
            if n_match < 15 or n_align < 10:
                continue

            X = pt_pos[torch.clamp(res.idx, min=0)]
            refined = self._refine(SE3(align.R, align.t), X, fd.obs,
                                   fd.inv_sigma2, res.valid & align.inliers)
            n_inl = int(refined.n_inliers)
            if n_inl >= self.cfg.tracking.reloc_min_inliers:
                sel = refined.inliers.cpu().numpy()
                idx = res.idx.cpu().numpy()
                point_ids = np.full(fd.n, -1, np.int32)
                point_ids[sel] = pad[idx[sel]]
                return RelocResult(True, refined.pose.R.cpu().numpy(),
                                   refined.pose.t.cpu().numpy(), point_ids,
                                   n_inl)
        return _FAILED

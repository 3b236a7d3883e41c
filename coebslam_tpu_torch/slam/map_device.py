"""Device mirrors of a host map arena, updated row by row.

Counterpart of ``DeviceMap`` and ``sync`` of
``coebslam_tpu/slam/map_device.py``. The arena (``slam/map.py``) marks
the rows it changes; ``DeviceMap.sync`` uploads the whole arena the first
time and afterwards writes only the dirty rows, in place with
``index_copy_``. (The reference pads the rows to a few bucket sizes and
donates the buffers to its scatter program; both serve the TPU compiler
and are not needed here.) Point descriptors are mirrored as +-1 float32
for the Hamming product, keyframe descriptors stay packed uint8.
``adopt_keyframe_row`` writes a new keyframe's feature row straight from
the frame already on the device, so the host copy is not uploaded again.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import SystemConfig
from ..ops import brief
from ..utils.device import resolve_device


class DeviceMap:
    """Device mirrors of one MapArena.

    ``points``   (pos, signed_desc, valid, angle, normal, min_dist,
                 max_dist);
    ``kf_feats`` (uv, desc_u8, level, ur, kp_valid) per keyframe slot;
    ``kf_poses`` (R [K, 3, 3], t [K, 3]), uploaded whole when they change.
    ``mirror_keyframes=False`` keeps no keyframe feature rows.
    """

    def __init__(self, cfg: SystemConfig, device=None,
                 mirror_keyframes: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device, "DeviceMap")
        self.mirror_keyframes = mirror_keyframes
        self._arena = None
        self._pts = None
        self._kf = None
        self._kf_pose = None
        self._kf_pose_version = -1

    def _up(self, a) -> torch.Tensor:
        """Host rows -> device; on the card through pinned memory, without
        waiting for the queued device work."""
        t = torch.from_numpy(np.array(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _point_rows(self, m, idx=slice(None)):
        return (self._up(m.pt_pos[idx]),
                brief.to_signed(brief.unpack_bits(self._up(m.pt_desc[idx]))),
                self._up(m.pt_valid[idx]), self._up(m.pt_angle[idx]),
                self._up(m.pt_normal[idx]), self._up(m.pt_min_dist[idx]),
                self._up(m.pt_max_dist[idx]))

    def _kf_rows(self, m, idx=slice(None)):
        return (self._up(m.kf_uv[idx]), self._up(m.kf_desc[idx]),
                self._up(m.kf_level[idx]), self._up(m.kf_ur[idx]),
                self._up(m.kf_kp_valid[idx]))

    def _full_upload(self, m) -> None:
        self._pts = self._point_rows(m)
        if self.mirror_keyframes:
            self._kf = self._kf_rows(m)
        self._arena = m
        m._dirty_pt[:] = False
        m._dirty_kf[:] = False
        m._dirty_all = False
        self._sync_poses(m, force=True)

    def _sync_poses(self, m, force: bool = False) -> None:
        if force or m._pose_version != self._kf_pose_version:
            self._kf_pose = (self._up(m.kf_R), self._up(m.kf_t))
            self._kf_pose_version = m._pose_version

    def sync(self, m) -> "DeviceMap":
        """Apply all pending arena changes to the device mirrors."""
        if self._arena is not m or m._dirty_all or self._pts is None:
            self._full_upload(m)
            return self
        mirrors = [(m._dirty_pt, self._pts, self._point_rows)]
        if self.mirror_keyframes:
            mirrors.append((m._dirty_kf, self._kf, self._kf_rows))
        for dirty, mirror, rows in mirrors:
            ids = np.nonzero(dirty)[0]
            if len(ids):
                idx = self._up(ids)
                for dst, src in zip(mirror, rows(m, ids)):
                    dst.index_copy_(0, idx, src)
                dirty[:] = False
        self._sync_poses(m)
        return self

    def adopt_keyframe_row(self, m, k: int, fd) -> None:
        """Write keyframe k's feature row from the device FrameData ``fd``
        it was made from, and clear the row's dirty flag."""
        if self._kf is None or self._arena is not m:
            return
        f = fd.feats
        for dst, src in zip(self._kf, (f.uv, f.desc, f.level, fd.ur,
                                       f.valid)):
            dst[k] = src.to(dst.dtype)
        m._dirty_kf[k] = False

    @property
    def points(self) -> Tuple:
        return self._pts

    @property
    def kf_feats(self) -> Tuple:
        """(uv, desc_u8, level, ur, kp_valid) device tensors."""
        return self._kf

    @property
    def kf_poses(self) -> Tuple:
        return self._kf_pose


def sync(arena, cfg: SystemConfig, device=None) -> DeviceMap:
    """The arena's one DeviceMap (the dirty flags support one mirror per
    arena), created on ``device`` at the first call, synced."""
    dm = arena.__dict__.get("_devmap")
    if dm is None:
        dm = DeviceMap(cfg, device)
        arena._devmap = dm
    return dm.sync(arena)

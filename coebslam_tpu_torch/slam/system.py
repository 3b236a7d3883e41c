"""The ``System`` facade of the host-orchestrated path.

Counterpart of ``coebslam_tpu/slam/system.py``: construction wires the
``Tracker`` and the ``LocalMapper`` around one ``MapArena``;
``track_rgbd``, ``track_stereo`` and ``track_monocular`` take a frame
(RGB-D with optional detector boxes, a rectified pair, one image with
optional boxes); localization mode, reset, the realtime (pipelined) mode
and the trajectory exports follow the reference's surface.

The dynamic front-end of ``track_rgbd`` is one of two motion checks:

- ``"feature"`` (default): the fused check inside the frame's program;
  given boxes win, otherwise the detector's ``detect_device`` runs every
  ``detector_cadence`` frames; while the system is not initialised every
  box is treated as dynamic (a host mask, the reference's conservative
  initialisation);
- ``"flow"``: the reference's LK-flow check (``dynamic.dynamic_frontend``)
  on the previous and the current image, before the frame is tracked;
  boxes come from the caller or ``detector.detect``. The frame's mask and
  area flag are read in one transfer, and a mask stays on for
  ``sticky_frames`` frames; before there is a previous frame every box is
  dynamic, and no point is spawned inside a box unless
  ``spawn_in_boxes``.

``track_monocular`` with boxes runs the flow check too, whatever
``motion_check`` says, as the reference does.

With a ``vocabulary`` the BoW half is wired in as in the reference: the
keyframe database (culled keyframes leave it), relocalization as the
tracker's ``reloc_fn`` and loop closing after each keyframe's local
mapping. The vocabulary goes to the device once; each keyframe's and each
relocalizing frame's words are computed there and read once.

The system runs on ``device`` (default CUDA; no CPU fallback).
"""
from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import SystemConfig
from ..io import trajectory
from ..ops import pyramid as pyramid_ops
from ..ops.fundamental import RansacSampler
from ..utils.device import resolve_device
from ..utils.metrics import MetricsCollector
from . import vocabulary as voc_mod
from .keyframe_db import KeyFrameDatabase
from .local_mapping import LocalMapper
from .loop_closing import LoopCloser
from .map import MapArena
from .relocalization import Relocalizer
from . import dynamic as dynamic_mod
from .tracking import InitSampler, LOST, NOT_INITIALIZED, Sampler, Tracker

SENSOR_RGBD = "rgbd"
SENSOR_MONOCULAR = "monocular"
SENSOR_STEREO = "stereo"


def _np_box_mask(h: int, w: int, boxes: np.ndarray) -> np.ndarray:
    """Host union of box masks (absent boxes have xmin < 0)."""
    mask = np.zeros((h, w), bool)
    for b in boxes:
        if b[0] >= 0:
            x0, y0 = max(0, int(b[0])), max(0, int(b[1]))
            x1, y1 = min(w - 1, int(b[2])), min(h - 1, int(b[3]))
            mask[y0:y1 + 1, x0:x1 + 1] = True
    return mask


class System:
    def __init__(self, cfg: SystemConfig, detector=None,
                 vocabulary: Optional[voc_mod.Vocabulary] = None,
                 device=None, sampler: Optional[Sampler] = None,
                 reloc_sampler: Optional[RansacSampler] = None,
                 loop_sampler: Optional[RansacSampler] = None,
                 init_sampler: Optional[InitSampler] = None):
        """Args:
          cfg: the configuration.
          detector: optional detector with ``detect_device(gray)`` and
            ``detect(gray)`` (the port's ``models.detector.YoloDetector``),
            run when no boxes are passed.
          vocabulary: optional ``slam.vocabulary.Vocabulary``: enables the
            keyframe database, relocalization and loop closing.
          device: where it runs (default CUDA).
          sampler: injects the F-RANSAC draws of the motion check:
            ``sampler(seed, valid)`` with the frame's seed of the fused
            check (``Tracker.sampler``), or the flow check's count so far
            (1 for the first).
          reloc_sampler, loop_sampler: inject the relocalizer's and the
            loop closer's RANSAC draws (``Relocalizer.sampler``,
            ``LoopCloser.sampler``).
          init_sampler: injects the monocular initializer's draws
            (``Tracker.init_sampler``).
        """
        self.cfg = cfg
        self.device = resolve_device(device, "System")
        self.detector = detector
        self.map = MapArena(cfg)
        self.tracker = Tracker(cfg, self.map, self.device, sampler=sampler,
                               init_sampler=init_sampler)
        self.mapper = LocalMapper(cfg, self.map, self.device)
        self.tracker.on_keyframe = self._on_keyframe
        self.localization_only = False
        self.voc = vocabulary
        self.kf_db = None
        self.relocalizer = None
        self.loop_closer = None
        if vocabulary is not None:
            self._dev_voc = voc_mod.to_device(vocabulary, self.device)
            self.kf_db = KeyFrameDatabase(vocabulary, self.map,
                                          cfg.map.max_keyframes)
            # Culled keyframes leave the database, or they stay loop and
            # relocalization candidates and crowd out real ones.
            self.map.on_keyframe_removed.append(self.kf_db.erase)
            self.relocalizer = Relocalizer(cfg, self.map, self.kf_db,
                                           self.device, sampler=reloc_sampler)
            self.loop_closer = LoopCloser(cfg, self.map, self.kf_db,
                                          mapper=self.mapper,
                                          device=self.device,
                                          sampler=loop_sampler)
            self.tracker.reloc_fn = self._relocalize
        self._boxes_dev: Optional[torch.Tensor] = None
        self._frame_count = 0
        self.metrics = MetricsCollector()
        self.sampler = sampler
        self._prev_gray: Optional[torch.Tensor] = None   # on the device
        self._recent_masks = []
        self._last_flow: Optional[dynamic_mod.DynamicResult] = None
        self._flow_seed = 0
        self._flow_gen = torch.Generator(device=self.device)

    # ------------------------------------------------------------------ #

    def _words(self, desc_u8, valid) -> np.ndarray:
        """Word ids [N] of device descriptors, read once."""
        return voc_mod.transform_words(self._dev_voc, desc_u8,
                                       valid)[0].cpu().numpy()

    def _relocalize(self, fd):
        return self.relocalizer.relocalize(
            fd, self._words(fd.feats.desc, fd.feats.valid))

    def _on_keyframe(self, kf_id: int) -> None:
        if self.localization_only:
            return
        if self.kf_db is not None:
            up = self.tracker._up
            self.kf_db.add(kf_id, self._words(up(self.map.kf_desc[kf_id]),
                                              up(self.map.kf_kp_valid[kf_id])))
        self.mapper.process_keyframe(kf_id)
        if self.loop_closer is not None:
            self.loop_closer.insert_keyframe(kf_id)

    def track_rgbd(self, rgb_or_gray, depth, stamp: float,
                   boxes: Optional[Sequence] = None):
        """One RGB-D frame.

        Args:
          rgb_or_gray: [H, W] grey or [H, W, 3] colour, 0..255.
          depth: [H, W] float metres (or raw integer units).
          boxes: optional [B, 4] (xmin, ymin, xmax, ymax) detector boxes.
        Returns (state, n_inliers).
        """
        gray = self._to_gray(rgb_or_gray)
        mask = None
        area_mode = False
        spawn_mask = None
        boxes_dev = None
        h, w = (int(x) for x in gray.shape)
        if self.cfg.use_dynamic_filtering \
                and self.cfg.dynamic.motion_check == "feature":
            boxes_dev = self._device_boxes(gray, boxes)
            if boxes_dev is not None \
                    and self.tracker.state.mode == NOT_INITIALIZED:
                # Conservative initialisation: every box is dynamic until
                # there is motion evidence (host mask, initialisation only).
                mask = _np_box_mask(h, w, boxes_dev.cpu().numpy())
                boxes_dev = None
        elif self.cfg.use_dynamic_filtering:
            if boxes is None and self.detector is not None:
                boxes = self.detector.detect(gray)
            if boxes is not None:
                padded = self._pad_boxes(boxes)
                all_box_mask = _np_box_mask(h, w, padded)
                if not self.cfg.dynamic.spawn_in_boxes:
                    # Never create points inside a box: one unclassified
                    # frame would otherwise bake a mover into the map.
                    spawn_mask = all_box_mask
                if self._prev_gray is not None:
                    dres = self._flow_check(gray, padded)
                    # The mask and the area flag in one transfer.
                    flat = torch.cat([dres.mask.reshape(-1),
                                      dres.area_flag.reshape(1)]).cpu()
                    mask = flat[:-1].numpy().reshape(h, w)
                    area_mode = bool(flat[-1])
                    # Sticky masking: movers stay masked for a few frames
                    # when the epipolar evidence is intermittent.
                    if self.cfg.dynamic.sticky_frames > 0:
                        if mask.any():
                            self._recent_masks.append(mask)
                        self._recent_masks = self._recent_masks[
                            -self.cfg.dynamic.sticky_frames:]
                        for rm in self._recent_masks:
                            mask = mask | rm
                elif self.tracker.state.mode == NOT_INITIALIZED:
                    # No previous frame, no motion evidence: every box is
                    # dynamic at initialisation.
                    mask = all_box_mask
        t0 = time.perf_counter()
        state, n = self.tracker.process_frame(
            gray, depth, stamp, dynamic_mask=mask, area_mode=area_mode,
            spawn_mask=spawn_mask, boxes_dev=boxes_dev)
        return self._after_frame(gray, stamp, state, n, t0)

    def track_monocular(self, rgb_or_gray, stamp: float,
                        boxes: Optional[Sequence] = None):
        """One monocular frame: two-view initialisation, then tracking with
        the map grown by triangulation. With boxes (and dynamic filtering)
        the flow check masks the dynamic ones. Returns (state,
        n_inliers)."""
        assert self.cfg.sensor == "monocular", \
            "construct the System with cfg.sensor='monocular'"
        gray = self._to_gray(rgb_or_gray)
        mask = None
        if self.cfg.use_dynamic_filtering and boxes is not None \
                and self._prev_gray is not None:
            mask = self._flow_check(gray, self._pad_boxes(boxes)).mask
        t0 = time.perf_counter()
        state, n = self.tracker.process_frame(gray, None, stamp,
                                              dynamic_mask=mask)
        return self._after_frame(gray, stamp, state, n, t0)

    def track_stereo(self, left, right, stamp: float):
        """One rectified stereo pair: depth from row-band matching, then
        the RGB-D tracking path. Returns (state, n_inliers)."""
        assert self.cfg.sensor == "stereo", \
            "construct the System with cfg.sensor='stereo'"
        gl = self._to_gray(left)
        gr = self._to_gray(right)
        t0 = time.perf_counter()
        state, n = self.tracker.process_frame_stereo(gl, gr, stamp)
        return self._after_frame(gl, stamp, state, n, t0)

    def _flow_check(self, gray, padded) -> dynamic_mod.DynamicResult:
        """``dynamic_frontend`` on the previous and the current image with
        the padded boxes; its F-RANSAC draws come from the injected
        ``sampler`` (seeded with the count of flow checks) or a generator
        seeded the same way."""
        self._flow_seed += 1
        seed = self._flow_seed
        if self.sampler is not None:
            idx, gen = (lambda valid: self.sampler(seed, valid)
                        .to(valid.device)), None
        else:
            idx, gen = None, self._flow_gen.manual_seed(seed)
        dres = dynamic_mod.dynamic_frontend(
            self._prev_gray, gray, self.tracker._up(padded), self.cfg,
            generator=gen, idx=idx)
        self._last_flow = dres
        return dres

    def _after_frame(self, gray, stamp, state, n, t0):
        self.metrics.record(
            frame=self._frame_count, stamp=stamp, state=state, n_inliers=n,
            n_map_points=len(self.map.valid_points()),
            n_keyframes=len(self.map.valid_keyframes()),
            budget=self.tracker.state.budget,
            wall_ms=(time.perf_counter() - t0) * 1e3)
        self._prev_gray = gray
        self._frame_count += 1
        self._maybe_reset(state)
        return state, n

    # ------------------------------------------------------------------ #

    @property
    def last_dynamic(self):
        """The newest dynamic result, read from the device when asked for:
        the flow check's (its frame's mask, before the sticky union, the
        box classes and the T_M points), else the fused step's (box
        classes, counts and the sticky mask)."""
        if self._last_flow is not None:
            f = self._last_flow
            return SimpleNamespace(
                box_dynamic=f.box_dynamic.cpu().numpy(),
                box_blurred=f.box_blurred.cpu().numpy(),
                n_outliers=int(f.n_outliers), mask=f.mask.cpu().numpy(),
                area_flag=bool(f.area_flag),
                outliers=f.outliers.cpu().numpy(),
                outlier_valid=f.outlier_valid.cpu().numpy())
        tr = self.tracker
        if tr.last_dyn_info is None or tr._dyn_state is None:
            return None
        info = tr.last_dyn_info
        return SimpleNamespace(
            box_dynamic=info.box_dynamic.cpu().numpy(),
            box_blurred=info.box_blurred.cpu().numpy(),
            n_outliers=int(info.n_outliers),
            n_culled=int(info.n_culled),
            mask=tr._dyn_state.sticky.cpu().numpy() > 0)

    def _device_boxes(self, gray, boxes) -> Optional[torch.Tensor]:
        """Detector boxes as a [max_boxes, 4] device tensor: given boxes
        win; otherwise the detector runs every ``detector_cadence`` frames
        and its boxes are reused in between."""
        if boxes is not None:
            return self.tracker._up(self._pad_boxes(boxes))
        if self.detector is None:
            return None
        cad = max(1, self.cfg.dynamic.detector_cadence)
        if self._frame_count % cad == 0 or self._boxes_dev is None:
            self._boxes_dev = self.detector.detect_device(gray)
        return self._boxes_dev

    def activate_localization_mode(self) -> None:
        """Track against the frozen map: no keyframes, no new points."""
        self.localization_only = True
        self.tracker.localization_only = True

    def deactivate_localization_mode(self) -> None:
        self.localization_only = False
        self.tracker.localization_only = False

    def reset(self) -> None:
        """Clear the map and start initialisation again. As in the
        reference, only the tracker and the mapper get the new arena: the
        keyframe database, the relocalizer and the loop closer keep the
        old one (and the database its registered keyframes)."""
        self.tracker.flush()
        self.tracker.freeze_trajectory()
        self.map = MapArena(self.cfg)
        self.tracker.map = self.map
        self.mapper.map = self.map
        self.tracker.state.__init__(budget=self.cfg.orb.n_features)
        self.tracker.reset_runtime()
        self.tracker.ref_kf = -1
        self._prev_gray = None

    def _maybe_reset(self, state: str) -> None:
        """Reset when lost with a small map (fewer than
        ``reset_if_lost_with_kfs_below`` keyframes)."""
        if state == LOST and len(self.map.valid_keyframes()) \
                < self.cfg.tracking.reset_if_lost_with_kfs_below:
            n_traj = len(self.tracker.trajectory)
            self.reset()
            del self.tracker.trajectory[n_traj:]

    def enable_realtime(self, finalize_batch: int = 8) -> None:
        """Pipeline the tracker (frame i-1's decisions after frame i's
        dispatch, ``finalize_batch`` frames per transfer) and run the
        mapper's stage machine one stage per frame."""
        self.tracker.pipelined = True
        self.tracker.finalize_batch = max(1, int(finalize_batch))
        self.mapper.async_mode = True
        self.tracker.on_frame = self.mapper.poll
        self.tracker.mapper_idle_fn = self.mapper.idle

    def shutdown(self) -> None:
        """Finalize in-flight frames and finish the mapping stages."""
        self.tracker.flush()
        self.mapper.flush()

    # ------------------------------------------------------------------ #

    def get_tracking_state(self) -> str:
        return self.tracker.state.mode

    def get_tracked_map_points(self) -> np.ndarray:
        pids = self.tracker._last_pids
        if pids is None:
            return np.zeros(0, np.int32)
        return pids[pids >= 0]

    def save_trajectory_tum(self, path: str) -> None:
        """Every frame's pose, composed against the current keyframe poses
        at save time."""
        traj = self.tracker.export_trajectory()
        trajectory.save_tum(path, [s for s, _, _ in traj],
                            [(R, t) for _, R, t in traj])

    def save_keyframe_trajectory_tum(self, path: str) -> None:
        kfs = self.map.valid_keyframes()
        trajectory.save_tum(path, self.map.kf_stamp[kfs],
                            [(self.map.kf_R[k], self.map.kf_t[k])
                             for k in kfs])

    def save_trajectory_kitti(self, path: str) -> None:
        trajectory.save_kitti(
            path, [(R, t) for _, R, t in self.tracker.export_trajectory()])

    # ------------------------------------------------------------------ #

    def _to_gray(self, img) -> torch.Tensor:
        img = self.tracker._up(img)
        if img.dim() == 3:
            return pyramid_ops.rgb_to_gray(img)
        return img.to(torch.float32)

    def _pad_boxes(self, boxes) -> np.ndarray:
        if isinstance(boxes, torch.Tensor):
            boxes = boxes.cpu().numpy()
        b = np.asarray(boxes, np.float32).reshape(-1, 4)
        out = np.full((self.cfg.dynamic.max_boxes, 4), -1.0, np.float32)
        out[:min(len(b), len(out))] = b[:len(out)]
        return out

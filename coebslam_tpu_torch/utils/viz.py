"""Offline visualization: the reference's Viewer, FrameDrawer and
MapDrawer as image and point-cloud files.

Counterpart of ``coebslam_tpu/utils/viz.py``:

* ``save_ply``             map points and keyframe centres as ASCII PLY.
* ``draw_frame``           keypoint overlay of a frame (FrameDrawer).
* ``render_map_topdown``   orthographic map and trajectory (MapDrawer).
* ``save_png``             through ``io/png.py``.
* ``LiveViewer``           the top-down map rewritten every k frames of a
                           running ``System``.

All drawing is numpy on the host; no GL, no windows.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from ..io import png

# FrameDrawer palette (FrameDrawer.cc: green = tracked map point,
# blue = newly created / untracked keypoint, red = dynamic-masked).
COLOR_TRACKED = (0, 255, 0)
COLOR_UNTRACKED = (80, 160, 255)
COLOR_DYNAMIC = (255, 64, 64)
COLOR_BOX = (255, 220, 0)


def save_ply(path: str, points: np.ndarray,
             colors: Optional[np.ndarray] = None,
             keyframe_positions: Optional[np.ndarray] = None) -> None:
    """Write map points (and optionally keyframe centers, colored red) as an
    ASCII PLY point cloud."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    if colors is None:
        colors = np.full((len(points), 3), 200, np.uint8)
    colors = np.asarray(colors, np.uint8).reshape(-1, 3)
    kf = (np.zeros((0, 3), np.float32) if keyframe_positions is None
          else np.asarray(keyframe_positions, np.float32).reshape(-1, 3))
    n = len(points) + len(kf)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {n}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for p, c in zip(points, colors):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
                    f"{c[0]} {c[1]} {c[2]}\n")
        for p in kf:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} 255 0 0\n")


def _put_disc(img: np.ndarray, u: int, v: int, color, r: int = 2) -> None:
    h, w = img.shape[:2]
    v0, v1 = max(0, v - r), min(h, v + r + 1)
    u0, u1 = max(0, u - r), min(w, u + r + 1)
    img[v0:v1, u0:u1] = color


def _put_rect(img: np.ndarray, box, color, t: int = 2) -> None:
    h, w = img.shape[:2]
    x0, y0, x1, y1 = [int(round(b)) for b in box]
    x0, x1 = max(0, x0), min(w - 1, x1)
    y0, y1 = max(0, y0), min(h - 1, y1)
    if x1 <= x0 or y1 <= y0:
        return
    img[y0:y0 + t, x0:x1] = color
    img[max(0, y1 - t):y1, x0:x1] = color
    img[y0:y1, x0:x0 + t] = color
    img[y0:y1, max(0, x1 - t):x1] = color


def draw_frame(gray: np.ndarray, uv: np.ndarray, valid: np.ndarray,
               point_ids: Optional[np.ndarray] = None,
               dynamic_mask: Optional[np.ndarray] = None,
               boxes: Optional[Sequence] = None,
               state: str = "") -> np.ndarray:
    """FrameDrawer::DrawFrame parity: RGB uint8 overlay of the current frame.

    Tracked keypoints (point_ids >= 0) draw green, untracked blue; keypoints
    inside the dynamic mask draw red; detector boxes draw yellow.
    """
    gray = np.asarray(gray)
    img = np.repeat(np.clip(gray, 0, 255).astype(np.uint8)[..., None], 3, -1)
    img = np.ascontiguousarray(img)
    uv = np.asarray(uv)
    valid = np.asarray(valid, bool)
    h, w = gray.shape
    if boxes is not None:
        for b in np.asarray(boxes, np.float32).reshape(-1, 4):
            if b[0] >= 0:
                _put_rect(img, b, COLOR_BOX)
    for i in np.nonzero(valid)[0]:
        u, v = int(round(float(uv[i, 0]))), int(round(float(uv[i, 1])))
        if not (0 <= u < w and 0 <= v < h):
            continue
        if dynamic_mask is not None and dynamic_mask[v, u]:
            c = COLOR_DYNAMIC
        elif point_ids is not None and point_ids[i] >= 0:
            c = COLOR_TRACKED
        else:
            c = COLOR_UNTRACKED
        _put_disc(img, u, v, c)
    if state:
        # 5x7 bitmap text is overkill; encode state as a colored banner strip
        # (green OK / red LOST / gray other) like the reference's status bar.
        band = {"OK": (0, 160, 0), "LOST": (200, 0, 0)}.get(state, (90, 90, 90))
        img[:6, :] = band
    return img


def render_map_topdown(pt_pos: np.ndarray, pt_valid: np.ndarray,
                       kf_t: Optional[np.ndarray] = None,
                       kf_R: Optional[np.ndarray] = None,
                       trajectory: Optional[np.ndarray] = None,
                       size: int = 800, axes: Tuple[int, int] = (0, 2)
                       ) -> np.ndarray:
    """MapDrawer parity as an orthographic top-down PNG image (uint8 RGB).

    Args:
      pt_pos: [P, 3] world points; pt_valid: [P] bool.
      kf_t/kf_R: keyframe poses T_cw — camera centers drawn as red squares.
      trajectory: [N, 3] camera centers drawn as a cyan polyline.
      axes: which world axes map to image (x, y); default (x, z) top-down.
    """
    pts = np.asarray(pt_pos).reshape(-1, 3)[np.asarray(pt_valid, bool)]
    ax, ay = axes
    centers = np.zeros((0, 3), np.float32)
    if kf_t is not None:
        kf_t = np.asarray(kf_t).reshape(-1, 3)
        if kf_R is not None:
            kf_R = np.asarray(kf_R).reshape(-1, 3, 3)
            centers = -np.einsum("kji,kj->ki", kf_R, kf_t)
        else:
            centers = kf_t
    everything = [p for p in (pts, centers, trajectory) if p is not None
                  and len(p)]
    img = np.full((size, size, 3), 20, np.uint8)
    if not everything:
        return img
    allp = np.concatenate([np.asarray(p).reshape(-1, 3) for p in everything])
    lo = allp[:, [ax, ay]].min(axis=0)
    hi = allp[:, [ax, ay]].max(axis=0)
    span = np.maximum(hi - lo, 1e-6).max()
    margin = 0.05 * span

    def to_px(p3):
        q = (np.asarray(p3).reshape(-1, 3)[:, [ax, ay]] - lo + margin) \
            / (span + 2 * margin)
        px = np.clip((q * (size - 1)).astype(int), 0, size - 1)
        return px

    for u, v in to_px(pts):
        img[size - 1 - v, u] = (200, 200, 200)
    if trajectory is not None and len(trajectory):
        tp = to_px(trajectory)
        for k in range(len(tp) - 1):
            _draw_line(img, tp[k], tp[k + 1], (0, 220, 220))
    for u, v in to_px(centers):
        _put_disc(img, u, size - 1 - v, (255, 0, 0), r=3)
    return img


def _draw_line(img: np.ndarray, p0, p1, color) -> None:
    size = img.shape[0]
    n = int(max(abs(int(p1[0]) - int(p0[0])),
                abs(int(p1[1]) - int(p0[1])), 1))
    us = np.linspace(p0[0], p1[0], n + 1).astype(int)
    vs = np.linspace(p0[1], p1[1], n + 1).astype(int)
    img[np.clip(size - 1 - vs, 0, size - 1), np.clip(us, 0, size - 1)] = color


def save_png(path: str, img: np.ndarray) -> None:
    """Write a grey [H, W] or RGB [H, W, 3] image as PNG (cast to uint8)."""
    png.write(path, np.asarray(img, np.uint8))


class LiveViewer:
    """A map view kept up to date during a run, in place of the reference's
    Pangolin Viewer thread: every ``every``-th frame the top-down render of
    the map and trajectory is written to ``out_dir/map_topdown.png`` (via
    a temporary file and a rename), for an image watcher to poll. It reads
    the host ``System``'s map, which is on the host anyway; for the
    realtime path render after ``finish()``.

    Chain the existing ``on_frame`` (the pipelined mode's mapper poll is
    installed there):
        viewer = LiveViewer(out_dir, every=15)
        sysm.tracker.on_frame = viewer.hook(sysm,
                                            chain=sysm.tracker.on_frame)
    """

    def __init__(self, out_dir: str, every: int = 15):
        self.out_dir = out_dir
        self.every = max(1, int(every))
        self.n = 0
        os.makedirs(out_dir, exist_ok=True)

    def tick(self, sysm) -> None:
        self.n += 1
        if self.n % self.every:
            return
        m = sysm.map
        kfs = m.valid_keyframes()
        traj = np.asarray([-R.T @ t for _, R, t in
                           sysm.tracker.trajectory]) \
            if sysm.tracker.trajectory else None
        img = render_map_topdown(
            m.pt_pos, m.pt_valid,
            kf_t=m.kf_t[kfs] if len(kfs) else None,
            kf_R=m.kf_R[kfs] if len(kfs) else None,
            trajectory=traj)
        tmp = os.path.join(self.out_dir, ".map_topdown.tmp.png")
        save_png(tmp, img)
        os.replace(tmp, os.path.join(self.out_dir, "map_topdown.png"))

    def hook(self, sysm, chain=None):
        """An ``on_frame`` callback, calling ``chain`` (e.g. the mapper
        poll) first."""
        def cb():
            if chain is not None:
                chain()
            self.tick(sysm)
        return cb

"""The TUM-format replica scenes, rendered in memory.

Counterpart of ``coebslam_tpu/utils/replica.py``: the handheld walking and
out-and-back trajectories, the separable box blur, and ``generate``, the
replica sequence of the TUM fr3 wire format (640x480, fr3 intrinsics, a
walking person, motion-blur windows and a camera-shake segment). The JAX
package writes the frames as PNG files through PIL. Here ``generate``
yields each frame in memory, rendered only when it is asked for, in the
wire's quantisation (8-bit grey, 16-bit depth at metres x 5000) with the
ground-truth line and the boxes as the text files carry them (``%.1f``),
so a caller gets what the JAX package's ``io/tum.py`` and ``load_boxes``
read back from its files; ``write`` writes those files (through
``io/png.py``), the file set of the JAX package's ``generate(root)``.
"""
from __future__ import annotations

import os
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import CameraConfig
from ..geometry import so3
from ..geometry.se3 import SE3
from ..io import png
from . import synthetic

DEPTH_FACTOR = 5000.0


def walking_trajectory(n_frames: int, seed: int = 3) -> List[SE3]:
    """Handheld fr3_walking_xyz-like camera path: multi-frequency sway in
    x/y/z plus gentle yaw/pitch, bounded so the room stays in view.
    Returns world-to-camera poses (SE3 of float32 CPU tensors)."""
    rng = np.random.RandomState(seed)
    ph = rng.uniform(0, 2 * np.pi, size=8)
    poses = []
    for i in range(n_frames):
        s = i / 30.0                      # seconds
        c = np.array([
            0.35 * np.sin(0.55 * s + ph[0]) + 0.12 * np.sin(1.3 * s + ph[1]),
            0.15 * np.sin(0.75 * s + ph[2]) + 0.05 * np.sin(1.7 * s + ph[3]),
            -1.2 + 0.25 * np.sin(0.4 * s + ph[4]),
        ], np.float32)
        yaw = 0.10 * np.sin(0.6 * s + ph[5]) + 0.04 * np.sin(1.9 * s + ph[6])
        pitch = 0.05 * np.sin(0.8 * s + ph[7])
        Rwc = (synthetic._rot_y(yaw) @ synthetic._rot_x(pitch)).astype(
            np.float32)
        Rcw = Rwc.T
        poses.append(SE3(torch.from_numpy(np.ascontiguousarray(Rcw)),
                         torch.from_numpy((-Rcw @ c).astype(np.float32))))
    return poses


def closure_trajectory(n_frames: int, seed: int = 3) -> List[SE3]:
    """Out-and-back path: the camera pans (~46 deg) and translates (~0.9 m)
    away from its start view and returns to it over the last frames, with
    a small handheld sway. Returns world-to-camera poses (SE3 of float32
    CPU tensors)."""
    rng = np.random.RandomState(seed)
    ph = rng.uniform(0, 2 * np.pi, size=4)
    poses = []
    for i in range(n_frames):
        u = i / max(n_frames - 1, 1)
        e = 0.5 * (1.0 - np.cos(2.0 * np.pi * u))     # 0 -> 1 -> 0 smooth
        s = i / 30.0
        c = np.array([
            0.9 * e + 0.05 * np.sin(1.3 * s + ph[0]),
            0.04 * np.sin(0.9 * s + ph[1]),
            -1.2 + 0.25 * e,
        ], np.float32)
        yaw = 0.8 * e + 0.03 * np.sin(1.1 * s + ph[2])
        pitch = 0.02 * np.sin(0.7 * s + ph[3])
        Rwc = (synthetic._rot_y(yaw) @ synthetic._rot_x(pitch)).astype(
            np.float32)
        Rcw = Rwc.T
        poses.append(SE3(torch.from_numpy(np.ascontiguousarray(Rcw)),
                         torch.from_numpy((-Rcw @ c).astype(np.float32))))
    return poses


def box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """Separable box blur (motion-blur stand-in), edge-padded."""
    if k <= 1:
        return img
    pad = k // 2
    x = np.pad(img, ((0, 0), (pad, pad)), mode="edge")
    c = np.cumsum(x, axis=1, dtype=np.float64)
    x = (np.concatenate([c[:, k - 1:k], c[:, k:] - c[:, :-k]], axis=1)) / k
    x = np.pad(x, ((pad, pad), (0, 0)), mode="edge")
    c = np.cumsum(x, axis=0, dtype=np.float64)
    x = (np.concatenate([c[k - 1:k, :], c[k:, :] - c[:-k, :]], axis=0)) / k
    return x.astype(np.float32)


class ReplicaFrame(NamedTuple):
    """One frame of the replica sequence, as its files would hold it."""
    index: int
    stamp: float               # the stamp as the lists print it (%.6f)
    gray: np.ndarray           # [H, W] uint8
    depth: np.ndarray          # [H, W] uint16, metres * DEPTH_FACTOR
    boxes: np.ndarray          # [n, 4] float32 walker boxes (%.1f)
    pose: SE3                  # ground-truth Tcw (float32 CPU tensors)
    gt_line: str               # "stamp tx ty tz qx qy qz qw" (Twc)
    box_lines: Tuple[str, ...]


def schedule(n_frames: int = 400, seed: int = 0,
             shake_window: Optional[Tuple[int, int]] = None,
             closure: bool = False) -> List[SE3]:
    """The ground-truth Tcw poses of ``generate``, shake included."""
    if shake_window is None:
        s = int(n_frames * 0.55)
        shake_window = (s, s + max(10, n_frames // 20))
    poses = (closure_trajectory(n_frames, seed=seed + 3) if closure
             else walking_trajectory(n_frames, seed=seed + 3))
    s0, s1 = shake_window
    rng = np.random.RandomState(seed + 7)
    for i in range(max(s0, 1), min(s1, n_frames)):
        jyaw = 0.035 * rng.randn()
        jpitch = 0.02 * rng.randn()
        J = (synthetic._rot_y(jyaw) @ synthetic._rot_x(jpitch)).astype(
            np.float32)
        R = poses[i].R.numpy() @ J
        poses[i] = SE3(torch.from_numpy(R), poses[i].t)
    return poses


def generate(n_frames: int = 400, seed: int = 0,
             cam: Optional[CameraConfig] = None,
             blur_windows: Tuple[Tuple[int, int, int], ...] = (),
             shake_window: Optional[Tuple[int, int]] = None,
             walkers: int = 1, closure: bool = False, frames=None,
             device=None) -> Iterator[ReplicaFrame]:
    """Render the replica sequence, one frame at a time, on ``device``
    (default CUDA). Deterministic in (n_frames, seed, options).

    blur_windows: (start, end, kernel) frame windows convolved with a box
      blur; by default two windows at 1/3 and 2/3 of the run.
    shake_window: frame range with extra camera shake (default: around
      55 % of the run).
    closure: the out-and-back ``closure_trajectory`` instead of the sway.
    frames: the frame indices to render (default all ``n_frames``), so a
      caller can take a prefix of a long schedule without rendering the
      rest.
    """
    if cam is None:
        cam = CameraConfig()
    if not blur_windows:
        a, b = int(n_frames * 0.33), int(n_frames * 0.66)
        blur_windows = ((a, a + max(8, n_frames // 25), 9),
                        (b, b + max(8, n_frames // 25), 13))
    poses = schedule(n_frames, seed, shake_window, closure)
    planes = synthetic.make_room(seed=seed, device=device)
    dev = planes[0].tex.device
    quads = [synthetic.make_walker(
        seed=seed + 17 * wi + 1,
        start=(-1.1 + 0.8 * wi, -0.25 + 0.1 * wi, 1.9 + 0.3 * wi),
        velocity=(0.011 + 0.003 * wi, 0.004 * (1 - wi), 0.0),
        half_w=0.28, half_h=0.62, device=dev) for wi in range(walkers)]
    for i in (range(n_frames) if frames is None else frames):
        pose = poses[i]
        frame_boxes = []
        gray = depth = None
        for q in quads:
            g, d, b, _ = synthetic.render(cam, pose, planes, q, i)
            g, d, b = g.cpu().numpy(), d.cpu().numpy(), b.cpu().numpy()
            if gray is None:
                gray, depth = g, d
            else:
                # Later walkers overwrite where closer (depth 0 = no return).
                closer = (d > 0) & ((depth <= 0) | (d < depth))
                gray = np.where(closer, g, gray)
                depth = np.where(closer, d, depth)
            if b[0] >= 0:
                frame_boxes.append(b)
        for (b0, b1, k) in blur_windows:
            if b0 <= i < b1:
                gray = box_blur(gray, k)
                break
        stamp = i / cam.fps
        g8 = np.clip(gray, 0, 255).astype(np.uint8)
        d16 = np.clip(depth * DEPTH_FACTOR, 0, 65535).astype(np.uint16)
        R_cw, t_cw = pose.R.numpy(), pose.t.numpy()
        R_wc = R_cw.T
        c = -R_wc @ t_cw
        qw, qx, qy, qz = so3.matrix_to_quat(
            torch.from_numpy(np.ascontiguousarray(R_wc))).numpy()
        gt_line = (f"{stamp:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                   f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}")
        box_lines = tuple(f"{stamp:.6f} {b[0]:.1f} {b[1]:.1f} "
                          f"{b[2]:.1f} {b[3]:.1f}" for b in frame_boxes)
        boxes = np.asarray([[float(x) for x in ln.split()[1:5]]
                            for ln in box_lines], np.float32).reshape(-1, 4)
        yield ReplicaFrame(i, float(f"{stamp:.6f}"), g8, d16, boxes, pose,
                           gt_line, box_lines)


HEADER = "# replica of TUM RGB-D wire format (coebslam_tpu)\n"


def write(root: str, n_frames: int = 400, seed: int = 0,
          cam: Optional[CameraConfig] = None,
          blur_windows: Tuple[Tuple[int, int, int], ...] = (),
          shake_window: Optional[Tuple[int, int]] = None,
          walkers: int = 1, closure: bool = False, frames=None,
          device=None, progress: bool = False) -> dict:
    """Render the replica sequence (``generate``'s arguments) and write it
    to ``root`` as a TUM sequence: ``rgb/*.png`` (8-bit grey),
    ``depth/*.png`` (16-bit, metres x 5000), ``rgb.txt``, ``depth.txt``,
    ``groundtruth.txt`` and ``boxes.txt``, with the JAX package's header
    and line formats. ``frames`` writes those frames of the
    ``n_frames`` schedule only (e.g. a prefix), rendering no other.
    Returns {"stamps", "poses", "boxes", "bytes"} of the frames written.
    """
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rgb_lines, depth_lines, gt_lines, box_lines = [], [], [], []
    stamps, poses, boxes = [], [], []
    n_bytes = 0
    for k, f in enumerate(generate(n_frames, seed, cam, blur_windows,
                                   shake_window, walkers, closure, frames,
                                   device)):
        name = f"{f.stamp:.6f}.png"
        for sub, img in (("rgb", f.gray), ("depth", f.depth)):
            path = os.path.join(root, sub, name)
            png.write(path, img)
            n_bytes += os.path.getsize(path)
        rgb_lines.append(f"{f.stamp:.6f} rgb/{name}")
        depth_lines.append(f"{f.stamp:.6f} depth/{name}")
        gt_lines.append(f.gt_line)
        box_lines.extend(f.box_lines)
        stamps.append(f.stamp)
        poses.append(f.pose)
        boxes.append(f.boxes)
        if progress and k % 50 == 0:
            print(f"  wrote frame {f.index} of {n_frames}", flush=True)
    for fname, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                         ("groundtruth.txt", gt_lines),
                         ("boxes.txt", box_lines)):
        path = os.path.join(root, fname)
        with open(path, "w") as fh:
            fh.write(HEADER + "\n".join(lines) + "\n")
        n_bytes += os.path.getsize(path)
    return {"stamps": np.asarray(stamps), "poses": poses, "boxes": boxes,
            "bytes": n_bytes}


def load_boxes(path: str, max_boxes: int = 8):
    """Read a boxes.txt -> (stamps [N], boxes [N, max_boxes, 4]) grouped by
    stamp, padded with -1."""
    groups = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            groups.setdefault(float(parts[0]), []).append(
                [float(x) for x in parts[1:5]])
    stamps = np.asarray(sorted(groups))
    out = np.full((len(stamps), max_boxes, 4), -1.0, np.float32)
    for i, s in enumerate(stamps):
        for j, b in enumerate(groups[s][:max_boxes]):
            out[i, j] = b
    return stamps, out

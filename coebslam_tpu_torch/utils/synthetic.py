"""Synthetic RGB-D world: ray-cast textured planes with exact depth + poses.

Counterpart of ``coebslam_tpu/utils/synthetic.py``: a textured box room
(5 planes) ray-cast per pixel on the device, optionally with a moving
textured quad standing in for a walking person (exact ground-truth box).
Textures come from the same seeded numpy recipe, so both packages render
the same world.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import CameraConfig
from ..geometry.se3 import SE3
from .device import resolve_device

TEX_SIZE = 512


class Plane(NamedTuple):
    origin: torch.Tensor   # [3] a corner of the rectangle
    e1: torch.Tensor       # [3] first edge vector (texture u)
    e2: torch.Tensor       # [3] second edge vector (texture v)
    tex: torch.Tensor      # [T, T] float32 texture in [0, 255]


class MovingQuad(NamedTuple):
    """A textured rectangle moving along a linear path."""
    half_w: float
    half_h: float
    center0: torch.Tensor  # [3] world position at frame 0
    velocity: torch.Tensor # [3] units per frame
    tex: torch.Tensor      # [T, T]


def _smooth_noise(rng: np.random.RandomState, size=TEX_SIZE, octaves=4):
    """Aperiodic multi-scale texture: band-passed white noise."""
    from scipy.ndimage import gaussian_filter

    img = np.zeros((size, size), np.float32)
    for o in range(octaves):
        layer = gaussian_filter(rng.randn(size, size).astype(np.float32),
                                sigma=1.5 * (2 ** o))
        layer /= max(layer.std(), 1e-6)
        img += layer * (1.3 ** o)
    img -= img.min()
    img /= img.max()
    return (img * 255.0).astype(np.float32)


def make_room(seed: int = 0, size: float = 6.0, height: float = 2.5,
              device=None) -> Tuple[Plane, ...]:
    """A box room centred at the origin: back, left and right walls, floor
    and ceiling, each with its own texture, on ``device`` (default CUDA)."""
    device = resolve_device(device, "make_room")
    rng = np.random.RandomState(seed)
    s = size / 2.0
    h = height / 2.0

    def plane(origin, e1, e2):
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return Plane(f(origin), f(e1), f(e2),
                     torch.from_numpy(_smooth_noise(rng)).to(device))

    return (
        plane([-s, -h, s], [size, 0, 0], [0, height, 0]),     # back wall
        plane([-s, -h, -s], [0, 0, size], [0, height, 0]),    # left wall
        plane([s, -h, -s], [0, 0, size], [0, height, 0]),     # right wall
        plane([-s, h, -s], [size, 0, 0], [0, 0, size]),       # floor
        plane([-s, -h, -s], [size, 0, 0], [0, 0, size]),      # ceiling
    )


def make_walker(seed: int = 1, start=(-1.5, 0.2, 2.5),
                velocity=(0.03, 0.0, 0.0), half_w=0.35, half_h=0.8,
                device=None) -> MovingQuad:
    """A person-sized textured quad translating through the room, on
    ``device`` (default CUDA)."""
    device = resolve_device(device, "make_walker")
    rng = np.random.RandomState(seed)
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return MovingQuad(half_w, half_h, f(start), f(velocity),
                      torch.from_numpy(_smooth_noise(rng)).to(device))


def _sample_tex(tex, u, v):
    """Bilinear texture lookup, u/v in [0, 1]."""
    t = tex.shape[0]
    x = torch.clamp(u, 0.0, 1.0) * (t - 1)
    y = torch.clamp(v, 0.0, 1.0) * (t - 1)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=t - 1)
    y1 = torch.clamp(y0 + 1, max=t - 1)
    fx, fy = x - x0, y - y0
    v00, v01 = tex[y0, x0], tex[y0, x1]
    v10, v11 = tex[y1, x0], tex[y1, x1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def _intersect_plane(plane: Plane, origin, dirs):
    """Ray-rectangle intersection -> (t [H, W], +inf where missed; grey)."""
    n = torch.linalg.cross(plane.e1, plane.e2)
    n = n / torch.linalg.norm(n)
    denom = torch.einsum("hwc,c->hw", dirs, n)
    denom = torch.where(torch.abs(denom) < 1e-9, torch.full_like(denom, 1e-9),
                        denom)
    t = torch.dot(plane.origin - origin, n) / denom
    hit = origin + t[..., None] * dirs
    rel = hit - plane.origin
    u = torch.einsum("hwc,c->hw", rel, plane.e1) / torch.dot(plane.e1, plane.e1)
    v = torch.einsum("hwc,c->hw", rel, plane.e2) / torch.dot(plane.e2, plane.e2)
    ok = (t > 1e-4) & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
    gray = _sample_tex(plane.tex, u, v)
    return torch.where(ok, t, torch.full_like(t, float("inf"))), gray


def render(cam: CameraConfig, pose_cw: SE3, planes: Tuple[Plane, ...],
           quad: Optional[MovingQuad] = None, frame_idx=0):
    """Render one RGB-D frame on the planes' device.

    Returns (gray [H, W] float32 in [0, 255], depth [H, W] metres with 0 =
    no depth, box [4] (xmin, ymin, xmax, ymax) of the quad or all -1,
    dyn_mask [H, W] bool).
    """
    dev = planes[0].tex.device
    h, w = cam.height, cam.width
    us = torch.arange(w, dtype=torch.float32, device=dev)
    vs = torch.arange(h, dtype=torch.float32, device=dev)
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    dirs_cam = torch.stack([(uu - cam.cx) / cam.fx, (vv - cam.cy) / cam.fy,
                            torch.ones_like(uu)], dim=-1)
    pose_wc = SE3(pose_cw.R.to(dev), pose_cw.t.to(dev)).inverse()
    dirs_w = torch.einsum("ij,hwj->hwi", pose_wc.R, dirs_cam)
    origin = pose_wc.t

    depth = torch.full((h, w), float("inf"), device=dev)
    gray = torch.zeros((h, w), device=dev)
    for plane in planes:
        t, g = _intersect_plane(plane, origin, dirs_w)
        closer = t < depth
        depth = torch.where(closer, t, depth)
        gray = torch.where(closer, g, gray)

    box = torch.full((4,), -1.0, device=dev)
    dyn_mask = torch.zeros((h, w), dtype=torch.bool, device=dev)
    if quad is not None:
        center = quad.center0 + quad.velocity * float(frame_idx)
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        qplane = Plane(origin=center + f([-quad.half_w, -quad.half_h, 0.0]),
                       e1=f([2.0 * quad.half_w, 0.0, 0.0]),
                       e2=f([0.0, 2.0 * quad.half_h, 0.0]), tex=quad.tex)
        tq, gq = _intersect_plane(qplane, origin, dirs_w)
        closer = tq < depth
        depth = torch.where(closer, tq, depth)
        gray = torch.where(closer, gq, gray)
        dyn_mask = closer
        inf = torch.full_like(uu, float("inf"))
        xmin = torch.where(closer, uu, inf).min()
        ymin = torch.where(closer, vv, inf).min()
        xmax = torch.where(closer, uu, -inf).max()
        ymax = torch.where(closer, vv, -inf).max()
        box = torch.where(closer.any(), torch.stack([xmin, ymin, xmax, ymax]),
                          box)

    depth = torch.where(torch.isinf(depth), torch.zeros_like(depth), depth)
    return gray, depth, box, dyn_mask


def camera_trajectory(n_frames: int, radius: float = 0.4,
                      forward: float = 0.0) -> list:
    """Smooth looping orbit of world-to-camera poses (list of SE3 of float32
    CPU tensors) looking at the back wall."""
    poses = []
    for i in range(n_frames):
        a = 2.0 * np.pi * i / max(n_frames, 1)
        c = np.array([radius * np.sin(a), 0.15 * np.sin(2 * a),
                      -1.2 + forward * i + 0.1 * np.cos(a)], np.float32)
        yaw = 0.12 * np.sin(a)
        pitch = 0.06 * np.cos(a)
        Rwc = (_rot_y(yaw) @ _rot_x(pitch)).astype(np.float32)
        Rcw = Rwc.T
        tcw = -Rcw @ c
        poses.append(SE3(torch.from_numpy(np.ascontiguousarray(Rcw)),
                         torch.from_numpy(np.ascontiguousarray(tcw))))
    return poses


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def dynamic_orbit(cam: CameraConfig, n_frames: int = 150, device=None):
    """bench.py's dynamic orbit: the room, the walker crossing it and a
    0.35 m orbit, rendered on ``device`` (default CUDA).

    Returns numpy lists gray (uint8), depth (uint16, ``depth_map_factor``
    units) and box ([4] float32 ground-truth walker box), and the
    ground-truth camera centres [n_frames, 3].
    """
    device = resolve_device(device, "dynamic_orbit")
    planes = make_room(seed=0, device=device)
    walker = make_walker(start=(-0.9, -0.2, 1.8), velocity=(0.012, 0.004, 0.0),
                         half_w=0.3, half_h=0.65, device=device)
    poses = camera_trajectory(n_frames, radius=0.35)
    gray, depth, boxes = [], [], []
    for i, p in enumerate(poses):
        g, d, b, _ = render(cam, p, planes, walker, i)
        gray.append(torch.clamp(g, 0, 255).to(torch.uint8).cpu().numpy())
        depth.append((d * cam.depth_map_factor).to(torch.int32).cpu().numpy()
                     .astype(np.uint16))
        boxes.append(b.cpu().numpy().astype(np.float32))
    centres = np.asarray([-p.R.numpy().T @ p.t.numpy() for p in poses])
    return gray, depth, boxes, centres


# The loop-closing scene: a camera circuit in a closed six-wall room.
N_CIRCUIT = 96       # frames for the full circuit
N_OVERLAP = 14       # frames past closure (re-visiting the start)
DEPTH_BIAS = 1.06    # systematic depth scale error -> translation drift


def six_wall_room(seed: int = 0, size: float = 6.0, height: float = 2.5,
                  device=None) -> Tuple[Plane, ...]:
    """``make_room`` plus a front wall, so a full yaw circuit always sees
    texture, on ``device`` (default CUDA)."""
    device = resolve_device(device, "six_wall_room")
    planes = list(make_room(seed=seed, size=size, height=height,
                            device=device))
    rng = np.random.RandomState(seed + 7)
    s, h = size / 2.0, height / 2.0
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    front = Plane(f([-s, -h, -s]), f([size, 0, 0]), f([0, height, 0]),
                  torch.from_numpy(_smooth_noise(rng)).to(device))
    return tuple(planes + [front])


def circuit_poses(n: int) -> list:
    """World-to-camera poses (SE3 of float32 CPU tensors) with centres on a
    circle of radius 1 m, facing along the direction of travel: views
    diverge over the circuit and re-align after N_CIRCUIT frames."""
    poses = []
    for i in range(n):
        a = 2.0 * np.pi * (i % N_CIRCUIT) / N_CIRCUIT
        c = np.array([np.sin(a), 0.0, -np.cos(a)], np.float32)
        Rcw = _rot_y(a).astype(np.float32).T
        poses.append(SE3(torch.from_numpy(np.ascontiguousarray(Rcw)),
                         torch.from_numpy(np.ascontiguousarray(-Rcw @ c))))
    return poses

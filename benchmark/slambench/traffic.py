"""The frames each session feeds, made from ``--seed``.

A frozen copy of the port's renderer (``utils/synthetic.py``: the textured
box room ray-cast per pixel on the card, the walking quad with its exact
box) and of the replica schedule (``utils/replica.py``: the handheld
walking trajectory, the camera-shake segment and the two motion-blur
windows, the TUM wire quantisation). It is kept here so that a change to
the port's copy cannot change the benchmark's traffic. Two departures
from the port's copy, neither of which changes what a frame shows: the
room is ray-cast once per frame and each walker composited onto it (the
port re-casts the room for every walker), and a stereo pair is the room
seen from the left camera and from the camera ``baseline`` metres to its
right.

A session's frames depend on (seed, session index) only; every session of
every seed gets the same number of frames at the same size.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

TEX_SIZE = 512
DEPTH_FACTOR = 5000.0
RENDER_BATCH = 10        # frames ray-cast in one batch


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    fps: float


class Plane(NamedTuple):
    origin: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    tex: torch.Tensor


class Quad(NamedTuple):
    half_w: float
    half_h: float
    center0: torch.Tensor
    velocity: torch.Tensor
    tex: torch.Tensor


def session_seed(seed: int, index: int) -> int:
    """The seed of session ``index`` of a run seeded ``seed`` (any whole
    number): below 2**30, so the renderer's offsets stay in numpy's
    range."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), int(index)])
    return int(ss.generate_state(1, np.uint32)[0]) % (2 ** 30)


def ping_pong(step: int, n: int) -> int:
    """The frame shown at ``step`` when n frames play 0..n-1, n-2..1, ..."""
    period = 2 * (n - 1)
    k = step % period
    return k if k < n else period - k


def _smooth_noise(rng, size=TEX_SIZE, octaves=4):
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


def make_room(seed, device, size=6.0, height=2.5):
    rng = np.random.RandomState(seed)
    s, h = size / 2.0, height / 2.0

    def plane(origin, e1, e2):
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return Plane(f(origin), f(e1), f(e2),
                     torch.from_numpy(_smooth_noise(rng)).to(device))

    return (plane([-s, -h, s], [size, 0, 0], [0, height, 0]),
            plane([-s, -h, -s], [0, 0, size], [0, height, 0]),
            plane([s, -h, -s], [0, 0, size], [0, height, 0]),
            plane([-s, h, -s], [size, 0, 0], [0, 0, size]),
            plane([-s, -h, -s], [size, 0, 0], [0, 0, size]))


def make_walker(seed, start, velocity, half_w, half_h, device):
    rng = np.random.RandomState(seed)
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return Quad(half_w, half_h, f(start), f(velocity),
                torch.from_numpy(_smooth_noise(rng)).to(device))


def _sample_tex(tex, u, v):
    t = tex.shape[0]
    x = torch.clamp(u, 0.0, 1.0) * (t - 1)
    y = torch.clamp(v, 0.0, 1.0) * (t - 1)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=t - 1)
    y1 = torch.clamp(y0 + 1, max=t - 1)
    fx, fy = x - x0, y - y0
    return ((1 - fy) * ((1 - fx) * tex[y0, x0] + fx * tex[y0, x1])
            + fy * ((1 - fx) * tex[y1, x0] + fx * tex[y1, x1]))


def _intersect(plane, origin, dirs):
    """Ray-rectangle hits of rays ``dirs`` [B, H, W, 3] from ``origin``
    [B, 3]: (distance [B, H, W], +inf where missed; texture grey)."""
    n = torch.linalg.cross(plane.e1, plane.e2)
    n = n / torch.linalg.norm(n)
    denom = torch.einsum("bhwc,c->bhw", dirs, n)
    denom = torch.where(torch.abs(denom) < 1e-9, torch.full_like(denom, 1e-9),
                        denom)
    t = ((plane.origin - origin) @ n)[:, None, None] / denom
    rel = origin[:, None, None, :] + t[..., None] * dirs - plane.origin
    u = torch.einsum("bhwc,c->bhw", rel, plane.e1) / torch.dot(plane.e1,
                                                               plane.e1)
    v = torch.einsum("bhwc,c->bhw", rel, plane.e2) / torch.dot(plane.e2,
                                                               plane.e2)
    ok = (t > 1e-4) & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
    return (torch.where(ok, t, torch.full_like(t, float("inf"))),
            _sample_tex(plane.tex, u, v))


def render(cam: Camera, R_cw, t_cw, planes, quads=(), frame_idx=None):
    """A batch of B frames seen from poses R_cw [B, 3, 3], t_cw [B, 3]:
    (grey [B, H, W] float32 in [0, 255], depth [B, H, W] metres with 0 =
    no return, boxes [B, len(quads), 4], all -1 for a walker out of
    view). Walkers stand where they are at ``frame_idx`` [B]."""
    dev = planes[0].tex.device
    h, w = cam.height, cam.width
    B = R_cw.shape[0]
    vv, uu = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    dirs_cam = torch.stack([(uu - cam.cx) / cam.fx, (vv - cam.cy) / cam.fy,
                            torch.ones_like(uu)], dim=-1)
    R_wc = R_cw.transpose(1, 2)
    dirs = torch.einsum("bij,hwj->bhwi", R_wc, dirs_cam)
    origin = -torch.einsum("bij,bj->bi", R_wc, t_cw)
    depth = torch.full((B, h, w), float("inf"), device=dev)
    gray = torch.zeros((B, h, w), device=dev)
    for plane in planes:
        t, g = _intersect(plane, origin, dirs)
        closer = t < depth
        depth = torch.where(closer, t, depth)
        gray = torch.where(closer, g, gray)
    room = depth
    boxes = []
    inf = torch.full_like(uu, float("inf"))
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    for q in quads:
        hits = []
        for b in range(B):
            c = q.center0 + q.velocity * float(frame_idx[b])
            qp = Plane(c + f([-q.half_w, -q.half_h, 0.0]),
                       f([2 * q.half_w, 0, 0]), f([0, 2 * q.half_h, 0]), q.tex)
            hits.append(_intersect(qp, origin[b:b + 1], dirs[b:b + 1]))
        tq = torch.cat([x[0] for x in hits])
        gq = torch.cat([x[1] for x in hits])
        seen = tq < room
        box = torch.stack([torch.where(seen, uu, inf).amin((1, 2)),
                           torch.where(seen, vv, inf).amin((1, 2)),
                           torch.where(seen, uu, -inf).amax((1, 2)),
                           torch.where(seen, vv, -inf).amax((1, 2))], 1)
        boxes.append(torch.where(seen.any(2).any(1)[:, None], box,
                                 torch.full_like(box, -1.0)))
        closer = tq < depth
        depth = torch.where(closer, tq, depth)
        gray = torch.where(closer, gq, gray)
    depth = torch.where(torch.isinf(depth), torch.zeros_like(depth), depth)
    boxes = torch.stack(boxes, 1) if boxes else torch.zeros((B, 0, 4),
                                                            device=dev)
    return gray, depth, boxes


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def walking_poses(n_frames: int, seed: int):
    """The replica schedule's world-to-camera poses (R [n, 3, 3], t [n,
    3]): the handheld fr3_walking sway (time in 30 fps frames), with the
    camera-shake segment at 55 % of the run."""
    rng = np.random.RandomState(seed + 3)
    ph = rng.uniform(0, 2 * np.pi, size=8)
    Rs, ts = [], []
    for i in range(n_frames):
        s = i / 30.0
        c = np.array([
            0.35 * np.sin(0.55 * s + ph[0]) + 0.12 * np.sin(1.3 * s + ph[1]),
            0.15 * np.sin(0.75 * s + ph[2]) + 0.05 * np.sin(1.7 * s + ph[3]),
            -1.2 + 0.25 * np.sin(0.4 * s + ph[4])], np.float32)
        yaw = 0.10 * np.sin(0.6 * s + ph[5]) + 0.04 * np.sin(1.9 * s + ph[6])
        pitch = 0.05 * np.sin(0.8 * s + ph[7])
        Rcw = (_rot_y(yaw) @ _rot_x(pitch)).astype(np.float32).T
        Rs.append(np.ascontiguousarray(Rcw))
        ts.append((-Rcw @ c).astype(np.float32))
    s0 = int(n_frames * 0.55)
    s1 = s0 + max(10, n_frames // 20)
    rng = np.random.RandomState(seed + 7)
    for i in range(max(s0, 1), min(s1, n_frames)):
        J = (_rot_y(0.035 * rng.randn()) @ _rot_x(0.02 * rng.randn())
             ).astype(np.float32)
        Rs[i] = Rs[i] @ J
    return np.stack(Rs), np.stack(ts)


def blur_windows(n_frames: int):
    """The replica's two motion-blur windows (start, end, box size)."""
    a, b = int(n_frames * 0.33), int(n_frames * 0.66)
    return ((a, a + max(8, n_frames // 25), 9),
            (b, b + max(8, n_frames // 25), 13))


def box_blur(img: np.ndarray, k: int) -> np.ndarray:
    pad = k // 2
    x = np.pad(img, ((0, 0), (pad, pad)), mode="edge")
    c = np.cumsum(x, axis=1, dtype=np.float64)
    x = np.concatenate([c[:, k - 1:k], c[:, k:] - c[:, :-k]], axis=1) / k
    x = np.pad(x, ((pad, pad), (0, 0)), mode="edge")
    c = np.cumsum(x, axis=0, dtype=np.float64)
    x = np.concatenate([c[k - 1:k, :], c[k:, :] - c[:-k, :]], axis=0) / k
    return x.astype(np.float32)


class Frames(NamedTuple):
    """A session's frames on the host, in the wire's dtypes."""
    gray: np.ndarray        # [n, H, W] uint8 (the left image for stereo)
    second: np.ndarray      # [n, H, W] uint16 depth x 5000, or uint8 right
    boxes: list             # n arrays [k, 4] float32 walker boxes (%.1f)
    R_cw: np.ndarray        # [n, 3, 3] ground truth
    t_cw: np.ndarray        # [n, 3]

    @property
    def centres(self):
        return -np.einsum("nji,nj->ni", self.R_cw, self.t_cw)


def _quantize_gray(g, blur_k):
    if blur_k:
        g = torch.from_numpy(box_blur(g.cpu().numpy(), blur_k)).to(g.device)
    return torch.clamp(g, 0, 255).to(torch.uint8)


def make_frames(traffic: dict, cam: Camera, sensor: str, seed: int,
                index: int, device, baseline: float = 0.0) -> Frames:
    """Session ``index``'s frames under the traffic mix ``traffic`` (keys
    ``frames``, ``walkers``, a list cycled over the session index,
    ``world_scale`` and ``depth_scale``); a stereo pair's right camera
    sits ``baseline`` metres to the right. ``world_scale`` scales the whole
    world about its origin, the room, the walkers and the camera path
    alike: the images stay as they are, depths and ground-truth
    translations scale. ``depth_scale`` biases the RGB-D depth images
    alone (a sensor whose depth reads long), not the ground truth."""
    n = int(traffic["frames"])
    s = session_seed(seed, index)
    scale = float(traffic.get("world_scale", 1.0))
    depth_scale = float(traffic.get("depth_scale", 1.0))
    Rs, ts = walking_poses(n, s)
    planes = make_room(s, device)
    walkers = int(traffic["walkers"][index % len(traffic["walkers"])])
    quads = [make_walker(s + 17 * wi + 1,
                         (-1.1 + 0.8 * wi, -0.25 + 0.1 * wi, 1.9 + 0.3 * wi),
                         (0.011 + 0.003 * wi, 0.004 * (1 - wi), 0.0),
                         0.28, 0.62, device) for wi in range(walkers)]
    blur = {i: k for (a, b, k) in blur_windows(n) for i in range(a, b)}
    base = torch.tensor([baseline / scale, 0.0, 0.0], device=device)
    gray = torch.empty((n, cam.height, cam.width), dtype=torch.uint8,
                       device=device)
    second = torch.empty((n, cam.height, cam.width),
                         dtype=torch.uint8 if sensor == "stereo"
                         else torch.int32, device=device)
    boxes = []
    stereo_pair = sensor == "stereo"
    Rd = torch.from_numpy(Rs).to(device)
    td = torch.from_numpy(ts).to(device)
    for lo in range(0, n, RENDER_BATCH):
        hi = min(n, lo + RENDER_BATCH)
        g, d, b = render(cam, Rd[lo:hi], td[lo:hi], planes, quads,
                         range(lo, hi))
        if stereo_pair:
            g2, _, _ = render(cam, Rd[lo:hi], td[lo:hi] - base, planes)
        for k, i in enumerate(range(lo, hi)):
            gray[i] = _quantize_gray(g[k], blur.get(i))
            if stereo_pair:
                second[i] = _quantize_gray(g2[k], blur.get(i))
        if not stereo_pair:
            second[lo:hi] = torch.clamp(
                d * (scale * depth_scale * DEPTH_FACTOR), 0,
                65535).to(torch.int32)
        boxes.append(b)
    gray = gray.cpu().numpy()
    second = second.cpu().numpy()
    if sensor != "stereo":
        second = second.astype(np.uint16)
    out_boxes = []
    for b in torch.cat(boxes).cpu().numpy():
        b = b[b[:, 0] >= 0]
        out_boxes.append(np.asarray([[float(f"{x:.1f}") for x in row]
                                     for row in b], np.float32).reshape(-1, 4))
    return Frames(gray, second, out_boxes, Rs, (ts * scale).astype(np.float32))

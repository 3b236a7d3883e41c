"""The plain reference that decides ``correct``.

Plain PyTorch, frozen here: ORB extraction (antialiased pyramid, FAST-9/16
as dense tensor ops, grid top-k, intensity-centroid orientation, steered
BRIEF), the RGB-D depth association and the stereo row-band match, one
tracking stage (projection search, Hamming match with ratio, mutual and
rotation checks, then the 4 x 10 robust Gauss-Newton pose solve), a
monocular keyframe's two-view triangulation and its gates, the keyframe's
windowed bundle adjustment and the YOLOv5s v6.0 network. The
arithmetic follows ORB-SLAM2 and ultralytics v6.0 as the port describes
it, and is computed here again from the inputs the benchmark made
(frames, weights) or, where a stage only exists inside a session's state
(the tracking stages' map points, the extraction budget and dynamic mask,
a monocular keyframe's pairs, the BA's window), from the inputs the timed
path handed that stage.

The reference computes in float32 with TF32 off (``tf32(False)``, the
configurations' stated precision) and solves poses and the BA in float64.
The control computes one precision lower: TF32 products (``tf32(True)``)
in the pyramid and the detector, bfloat16 (the ``dtype`` arguments) in
the depth, the pose solve and the BA.

Imports neither JAX, nor the JAX package, nor anything of the port.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BIG = 1e9
N_BITS = 256


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 products in matmul and cuDNN on (the control) or off."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


# ------------------------------------------------------------------ #
# ORB extraction
# ------------------------------------------------------------------ #

class Orb(NamedTuple):
    n_features: int
    scale_factor: float
    n_levels: int
    fast_min: int
    fast_min_masked: int
    cell_size: int = 32
    edge_threshold: int = 19
    masked_budget_scale: float = 0.7
    max_keypoints: int = 2048


class Feats(NamedTuple):
    uv: torch.Tensor
    level: torch.Tensor
    score: torch.Tensor
    angle: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor


def pyramid_shapes(h, w, n_levels, sf):
    shapes = [(h, w)]
    for lvl in range(1, n_levels):
        inv = 1.0 / (sf ** lvl)
        shapes.append((int(round(h * inv)), int(round(w * inv))))
    return shapes


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int, device: str):
    """[in, out] weights of an antialiased linear resize (a triangle kernel
    stretched by the inverse scale on downscale)."""
    f32 = torch.float32
    scale = out_size / in_size
    inv_scale = torch.tensor(1.0 / scale, dtype=f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=f32) + 0.5) * inv_scale
                - torch.tensor(0.0, dtype=f32) - 0.5)
    x = torch.abs(sample_f[None, :]
                  - torch.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    return w.to(device)


def resize(img, out_shape):
    h, w = img.shape[-2:]
    out = img
    if out_shape[0] != h:
        out = torch.einsum("...hw,hy->...yw", out,
                           resize_weights(h, out_shape[0], str(img.device)))
    if out_shape[1] != w:
        out = torch.einsum("...yw,wx->...yx", out,
                           resize_weights(w, out_shape[1], str(img.device)))
    return out


def gaussian_taps(ksize=7, sigma=2.0):
    half = (ksize - 1) / 2.0
    taps = [math.exp(-((i - half) ** 2) / (2.0 * sigma * sigma))
            for i in range(ksize)]
    s = sum(taps)
    return tuple(t / s for t in taps)


def gaussian_blur(img, ksize=7, sigma=2.0):
    taps = torch.tensor(gaussian_taps(ksize, sigma), dtype=img.dtype).to(
        img.device)
    pad = ksize // 2
    H, W = img.shape[-2:]
    x = F.pad(img.reshape(-1, H, W), (pad, pad, 0, 0), mode="reflect")
    acc = taps[0] * x[..., :, 0:W]
    for i in range(1, ksize):
        acc = acc + taps[i] * x[..., :, i:i + W]
    x = F.pad(acc, (0, 0, pad, pad), mode="reflect")
    acc = taps[0] * x[..., 0:H, :]
    for i in range(1, ksize):
        acc = acc + taps[i] * x[..., i:i + H, :]
    return acc.reshape(img.shape)


CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
          (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2),
          (-3, -1))


def fast_strength(canvas):
    """FAST-9/16 strength of a zero-padded [L, H, W] canvas: the max over
    the 16 arc starts of max(min over the 9-arc of the circle differences,
    -max over it)."""
    L, H, W = canvas.shape
    p = F.pad(canvas, (3, 3, 3, 3))
    diffs = [p[:, 3 + dy:3 + dy + H, 3 + dx:3 + dx + W] - canvas
             for dy, dx in CIRCLE]
    best = None
    for s in range(16):
        wmin = wmax = diffs[s]
        for j in range(1, 9):
            d = diffs[(s + j) % 16]
            wmin = torch.minimum(wmin, d)
            wmax = torch.maximum(wmax, d)
        arc = torch.maximum(wmin, -wmax)
        best = arc if best is None else torch.maximum(best, arc)
    return best


def fast_score(strength, thr, hw):
    """The strength gated at ``thr`` inside each level's extent less 3 px,
    then kept where it is the strict maximum of its 3 x 3 neighbours."""
    L, H, W = strength.shape
    dev = strength.device
    row = torch.arange(H, device=dev)[None, :, None]
    col = torch.arange(W, device=dev)[None, None, :]
    h = hw[:, 0][:, None, None]
    w = hw[:, 1][:, None, None]
    inside = (row >= 3) & (row < h - 3) & (col >= 3) & (col < w - 3)
    s = torch.where(inside & (strength > thr), strength,
                    torch.zeros_like(strength))
    p = F.pad(s, (1, 1, 1, 1), value=float("-inf"))
    neigh = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                v = p[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                neigh = v if neigh is None else torch.maximum(neigh, v)
    return torch.where(s > neigh, s, torch.zeros_like(s))


def grid_topk(score, cell, k_per_cell, n_out):
    L, h, w = score.shape
    dev = score.device
    pad_h, pad_w = (-h) % cell, (-w) % cell
    p = F.pad(score, (0, pad_w, 0, pad_h))
    ncy, ncx = (h + pad_h) // cell, (w + pad_w) // cell
    cells = p.reshape(L, ncy, cell, ncx, cell).permute(0, 1, 3, 2, 4).reshape(
        L, ncy * ncx, cell * cell)
    k = min(k_per_cell, cell * cell)
    srt, idx = torch.sort(cells, dim=-1, descending=True, stable=True)
    top_s, top_i = srt[..., :k], idx[..., :k]
    ids = torch.arange(ncy * ncx, device=dev)
    rows = ((ids // ncx) * cell)[:, None] + top_i // cell
    cols = ((ids % ncx) * cell)[:, None] + top_i % cell
    fs, fr, fc = top_s.reshape(L, -1), rows.reshape(L, -1), cols.reshape(L, -1)
    ranks = torch.arange(k, device=dev).expand(ncy * ncx, k).reshape(-1)
    ok = fs > 0.0
    key = ranks.to(torch.float32) * 1e6 - fs
    key = torch.where(ok, key, torch.full_like(key, float("inf")))
    if key.shape[1] < n_out:
        pad = n_out - key.shape[1]
        key = F.pad(key, (0, pad), value=float("inf"))
        fs, fr, fc, ok = (F.pad(fs, (0, pad)), F.pad(fr, (0, pad)),
                          F.pad(fc, (0, pad)), F.pad(ok, (0, pad)))
    order = torch.sort(key, dim=-1, stable=True).indices[:, :n_out]
    sel_s = torch.gather(fs, 1, order)
    sel_ok = torch.gather(ok, 1, order)
    yx = torch.stack([torch.gather(fr, 1, order), torch.gather(fc, 1, order)],
                     -1)
    yx = torch.where(sel_ok[..., None], yx, torch.zeros_like(yx))
    return yx, torch.where(sel_ok, sel_s, torch.zeros_like(sel_s)), sel_ok


def level_caps(orb: Orb):
    f = 1.0 / orb.scale_factor
    share = (1.0 - f) / (1.0 - f ** orb.n_levels)
    caps = [int(orb.max_keypoints * share * (f ** l))
            for l in range(orb.n_levels)]
    caps[0] += orb.max_keypoints - sum(caps)
    return caps, share


PATCH = 48
ORIENT_RADIUS = 15


@functools.lru_cache(maxsize=4)
def _centroid_w(device: str):
    d = np.arange(PATCH) - PATCH // 2
    dy, dx = np.meshgrid(d, d, indexing="ij")
    m = (dx * dx + dy * dy) <= ORIENT_RADIUS ** 2
    w = np.stack([(dx * m).reshape(-1), (dy * m).reshape(-1)], 1)
    return torch.from_numpy(w.astype(np.float32)).to(device)


@functools.lru_cache(maxsize=1)
def brief_pattern():
    """The 256 steered-BRIEF test pairs (pair, point, (y, x)), from the
    port's seeded recipe."""
    rng = np.random.RandomState(20240817)
    pts = rng.randn(N_BITS, 2, 2) * (31.0 / 5.0)
    pts = np.clip(np.round(pts), -13, 13).astype(np.int32)
    for i in range(N_BITS):
        while (pts[i, 0] == pts[i, 1]).all():
            pts[i, 1] = np.clip(np.round(rng.randn(2) * (31.0 / 5.0)),
                                -13, 13).astype(np.int32)
    return pts


def unpack_bits(packed):
    shifts = torch.arange(8, device=packed.device, dtype=torch.uint8)
    return ((packed[..., :, None] >> shifts) & 1).reshape(
        *packed.shape[:-1], N_BITS)


def signed(desc_u8):
    return unpack_bits(desc_u8).to(torch.float32) * 2.0 - 1.0


def extract(img, orb: Orb, n_features=None, dynamic_mask=None,
            area_mode=None) -> Feats:
    """ORB extraction of a [H, W] float32 frame into ``max_keypoints``
    fixed slots, levels laid out one after another."""
    dev = img.device
    i64, f32 = torch.int64, torch.float32
    if n_features is None:
        n_features = torch.full((), orb.n_features, dtype=i64, device=dev)
    if area_mode is None:
        area_mode = torch.zeros((), dtype=torch.bool, device=dev)
    H, W = img.shape
    L = orb.n_levels
    caps, share = level_caps(orb)
    f = 1.0 / orb.scale_factor
    budget = torch.where(area_mode,
                         (n_features * orb.masked_budget_scale).to(i64),
                         n_features)
    qshare = torch.tensor([share * (f ** l) for l in range(L)],
                          dtype=f32).to(dev)
    quotas = torch.ceil(qshare * budget.to(f32)).to(i64)
    thr = torch.where(area_mode,
                      torch.tensor(float(orb.fast_min_masked), device=dev),
                      torch.tensor(float(orb.fast_min), device=dev))
    shapes = pyramid_shapes(H, W, L, orb.scale_factor)
    levels = [img]
    for lvl in range(1, L):
        levels.append(resize(levels[-1], shapes[lvl]))
    canv = torch.zeros((L, H, W), dtype=f32, device=dev)
    for l, li in enumerate(levels):
        canv[l, :li.shape[0], :li.shape[1]] = li
    hw = torch.tensor(shapes, dtype=torch.int32).to(dev)
    hs, ws = hw[:, 0].to(i64), hw[:, 1].to(i64)
    strength = fast_strength(canv)
    score = fast_score(strength, thr, hw)
    m = orb.edge_threshold
    row0 = torch.arange(H, device=dev)
    col0 = torch.arange(W, device=dev)
    inside = ((row0[None, :, None] >= m)
              & (row0[None, :, None] < hs[:, None, None] - m)
              & (col0[None, None, :] >= m)
              & (col0[None, None, :] < ws[:, None, None] - m))
    score = torch.where(inside, score, torch.zeros_like(score))
    lvl_mask = None
    if dynamic_mask is not None:
        sy = torch.clamp(((row0[None, :].to(f32) + 0.5) * H
                          / torch.clamp(hs, min=1)[:, None].to(f32)).to(i64),
                         0, H - 1)
        sx = torch.clamp(((col0[None, :].to(f32) + 0.5) * W
                          / torch.clamp(ws, min=1)[:, None].to(f32)).to(i64),
                         0, W - 1)
        lvl_mask = dynamic_mask[sy[:, :, None], sx[:, None, :]]
        score = torch.where(area_mode & lvl_mask, torch.zeros_like(score),
                            score)
    cap_max = max(caps)
    yx, sc, valid = grid_topk(score, orb.cell_size, 8, cap_max)
    slot = torch.arange(cap_max, device=dev)
    caps_t = torch.tensor(caps, dtype=i64).to(dev)
    valid = valid & (slot[None] < caps_t[:, None]) & (slot[None] < quotas[:, None])
    if lvl_mask is not None:
        hit = lvl_mask[torch.arange(L, device=dev)[:, None], yx[..., 0],
                       yx[..., 1]]
        valid = torch.where(area_mode, valid, valid & ~hit)
    level_of = torch.tensor([l for l in range(L) for _ in range(caps[l])],
                            dtype=i64).to(dev)
    slot_of = torch.tensor([s for l in range(L) for s in range(caps[l])],
                           dtype=i64).to(dev)
    yx = yx[level_of, slot_of]
    scores = sc[level_of, slot_of]
    valids = valid[level_of, slot_of]
    ry = torch.where(row0[None] < hs[:, None], row0[None],
                     torch.clamp(2 * hs[:, None] - 2 - row0[None], min=0))
    rx = torch.where(col0[None] < ws[:, None], col0[None],
                     torch.clamp(2 * ws[:, None] - 2 - col0[None], min=0))
    lidx = torch.arange(L, device=dev)[:, None, None]
    refl = canv[lidx, torch.clamp(ry, 0, H - 1)[:, :, None],
                torch.clamp(rx, 0, W - 1)[:, None, :]]
    blurred = gaussian_blur(refl)
    pad = PATCH // 2
    padded = F.pad(blurred, (pad, pad, pad, pad), mode="replicate")
    ar = torch.arange(PATCH, device=dev)
    rows = yx[:, 0, None] + ar[None, :]
    cols = yx[:, 1, None] + ar[None, :]
    pt = padded[level_of[:, None, None], rows[:, :, None], cols[:, None, :]]
    mom = pt.reshape(pt.shape[0], -1) @ _centroid_w(str(dev))
    angles = torch.atan2(mom[:, 1], mom[:, 0])
    # Sub-pixel offsets: a parabola through (p-1, p, p+1) on each axis.
    _, h, w = strength.shape
    y = torch.clamp(yx[:, 0], 1, h - 2)
    x = torch.clamp(yx[:, 1], 1, w - 2)
    c = strength[level_of, y, x]

    def parab(lo, hi):
        denom = lo - 2.0 * c + hi
        big = torch.abs(denom) > 1e-6
        off = torch.where(big, 0.5 * (lo - hi) / torch.where(
            big, denom, torch.ones_like(denom)), torch.zeros_like(denom))
        return torch.clamp(off, -0.5, 0.5)

    off = torch.stack([parab(strength[level_of, y - 1, x],
                             strength[level_of, y + 1, x]),
                       parab(strength[level_of, y, x - 1],
                             strength[level_of, y, x + 1])], -1)
    scales = torch.tensor([orb.scale_factor ** l for l in range(L)],
                          dtype=f32).to(dev)
    scale = scales[level_of]
    uv = torch.stack([(yx[:, 1].to(f32) + off[:, 1] + 0.5) * scale - 0.5,
                      (yx[:, 0].to(f32) + off[:, 0] + 0.5) * scale - 0.5], -1)
    # Steered BRIEF.
    n, p = pt.shape[0], PATCH
    pat = torch.from_numpy(brief_pattern()).to(dev, f32)
    cos, sin = torch.cos(angles)[:, None, None], torch.sin(angles)[:, None, None]
    rxp = torch.round(pat[..., 1][None] * cos - pat[..., 0][None] * sin).to(i64)
    ryp = torch.round(pat[..., 1][None] * sin + pat[..., 0][None] * cos).to(i64)
    rxp = torch.clamp(rxp + p // 2, 0, p - 1)
    ryp = torch.clamp(ryp + p // 2, 0, p - 1)
    vals = torch.gather(pt.reshape(n, p * p), 1,
                        (ryp * p + rxp).reshape(n, -1)).reshape(n, N_BITS, 2)
    bits = (vals[..., 0] < vals[..., 1]).to(torch.uint8)
    shifts = torch.arange(8, device=dev, dtype=i64)
    desc = (bits.reshape(n, 32, 8).to(i64) << shifts).sum(-1).to(torch.uint8)
    uv = torch.where(valids[:, None], uv, torch.full_like(uv, -1.0))
    zero = torch.zeros_like(scores)
    return Feats(uv, level_of, torch.where(valids, scores, zero),
                 torch.where(valids, angles, zero), desc, valids)


def inv_sigma2(levels, sf):
    s = torch.pow(torch.full((), sf, dtype=torch.float32, device=levels.device),
                  levels.to(torch.float32)) ** 2
    return 1.0 / s


def depth_rgbd(feats: Feats, depth_m, cam):
    """The RGB-D frame's depth per keypoint (0 = none) at the rounded pixel
    (the configurations have no distortion, so positions are as
    extracted)."""
    u = torch.clamp(torch.round(feats.uv[:, 0]).to(torch.int64), 0,
                    cam.width - 1)
    v = torch.clamp(torch.round(feats.uv[:, 1]).to(torch.int64), 0,
                    cam.height - 1)
    d = depth_m[v, u]
    return torch.where(feats.valid & (d > 0.0), d, torch.zeros_like(d))


def hamming(sa, sb):
    return 0.5 * (N_BITS - sa @ sb.T)


class Match(NamedTuple):
    idx: torch.Tensor
    dist: torch.Tensor
    valid: torch.Tensor


def match(d, max_distance, ratio=None, mutual=False, row_valid=None,
          col_valid=None) -> Match:
    if col_valid is not None:
        d = d + torch.where(col_valid[None, :], 0.0, BIG)
    bi = torch.argmin(d, dim=1)
    best = torch.amin(d, dim=1)
    if d.shape[1] > 1:
        col = torch.arange(d.shape[1], device=d.device)
        d2 = torch.where(col[None, :] == bi[:, None], torch.full_like(d, BIG), d)
    else:
        d2 = d
    second = torch.amin(d2, dim=1)
    ok = best <= max_distance
    if ratio is not None:
        ok = ok & (best < ratio * second)
    if mutual:
        ok = ok & (torch.argmin(d, dim=0)[bi]
                   == torch.arange(d.shape[0], device=d.device))
    if row_valid is not None:
        ok = ok & row_valid
    return Match(torch.where(ok, bi, torch.full_like(bi, -1)), best, ok)


def stereo_depth(fl: Feats, fr: Feats, cam, sf, dtype=torch.float32):
    """Rectified row-band stereo matching (Frame::ComputeStereoMatches):
    (depth [N], u_right [N]) of the left keypoints, 0 / -1 where
    unmatched. ``dtype`` is the precision of the disparity and depth
    arithmetic (bfloat16 for the control)."""
    d = hamming(signed(fl.desc), signed(fr.desc))
    scale_l = torch.pow(torch.full((), sf, dtype=torch.float32,
                                   device=d.device), fl.level.to(torch.float32))
    ul, vl = fl.uv[:, 0].to(dtype), fl.uv[:, 1].to(dtype)
    ur_, vr = fr.uv[:, 0].to(dtype), fr.uv[:, 1].to(dtype)
    dv = torch.abs(vl[:, None] - vr[None, :]).to(torch.float32)
    d = d + torch.where(dv <= 2.0 * scale_l[:, None], 0.0, BIG)
    disp = ul[:, None] - ur_[None, :]
    d = d + torch.where((disp > 0.1) & (disp < cam.fx), 0.0, BIG)
    dl = torch.abs(fl.level[:, None] - fr.level[None, :])
    d = d + torch.where(dl <= 1, 0.0, BIG)
    res = match(d, 100.0, ratio=0.9, mutual=True, row_valid=fl.valid,
                col_valid=fr.valid)
    md = torch.gather(disp, 1, torch.clamp(res.idx, min=0)[:, None])[:, 0]
    ok = res.valid & (md > 0.1)
    depth = torch.where(ok, cam.bf / torch.clamp(md, min=0.1),
                        torch.zeros_like(md))
    ur = torch.where(ok, ul - md, torch.full_like(md, -1.0))
    return depth.to(torch.float32), ur.to(torch.float32)


# ------------------------------------------------------------------ #
# A monocular keyframe's spawn: two-view triangulation and its gates
# ------------------------------------------------------------------ #

def triangulate(uv1, level1, uv2, level2, R1, t1, R2, t2, cam, sf,
                chi2_mono):
    """LocalMapping::CreateNewMapPoints on pairs of keypoints already
    matched: ``uv1`` [n, 2] at pyramid levels ``level1`` in keyframe 1 with
    pose (R1, t1) against ``uv2``, ``level2`` in keyframe 2, all arithmetic
    in the dtype of ``uv1``. The linear DLT of Initializer::Triangulate on
    normalised coordinates, the 4 x 4 system built from both projection
    matrices, solved for the point with its fourth coordinate 1 by least
    squares, the estimator the port states. (ORB-SLAM2 takes the right
    singular vector of the smallest singular value instead, which at a
    parallax of 1.6 degrees moves a point by up to 6 % of its depth.)
    Then its gates: a positive depth in both views; the parallax
    cosine between the rays from both camera centres to the point below
    0.9998; the reprojection error within ``chi2_mono`` x sigma^2 of the
    keypoint's level in both views; the ratio of the point's distances to
    the two centres within 1.5 x ``sf`` of the ratio of the levels'
    scales. Returns (X [n, 3] in the world, passes every gate [n])."""
    dt, dev = uv1.dtype, uv1.device
    R1, t1, R2, t2, uv2 = (x.to(dt) for x in (R1, t1, R2, t2, uv2))
    off = torch.tensor([cam.cx, cam.cy], dtype=dt, device=dev)
    foc = torch.tensor([cam.fx, cam.fy], dtype=dt, device=dev)
    x1, x2 = (uv1 - off) / foc, (uv2 - off) / foc
    P1 = torch.cat([R1, t1[:, None]], 1)
    P2 = torch.cat([R2, t2[:, None]], 1)
    A = torch.stack([x1[:, :1] * P1[2] - P1[0], x1[:, 1:] * P1[2] - P1[1],
                     x2[:, :1] * P2[2] - P2[0], x2[:, 1:] * P2[2] - P2[1]],
                    1)
    M = A[..., :3]
    X = torch.linalg.solve_ex(M.transpose(1, 2) @ M,
                              -(M.transpose(1, 2) @ A[..., 3:]))[0][..., 0]
    sf_t = torch.full((), sf, dtype=dt, device=dev)
    l1, l2 = level1.to(dt), level2.to(dt)

    def seen(R, t, uv, level):
        p = X @ R.T + t
        z = p[:, 2]
        e = torch.stack([cam.fx * p[:, 0] / z + cam.cx,
                         cam.fy * p[:, 1] / z + cam.cy], -1) - uv
        return (z > 0) & (torch.sum(e * e, -1)
                          <= chi2_mono * torch.pow(sf_t, 2.0 * level))

    r1, r2 = X + t1 @ R1, X + t2 @ R2          # X minus each camera centre
    d1, d2 = torch.linalg.norm(r1, dim=-1), torch.linalg.norm(r2, dim=-1)
    parallax = torch.sum(r1 * r2, -1) / (d1 * d2) < 0.9998
    ratio_dist = d2 / d1
    ratio_octave = torch.pow(sf_t, l1 - l2)
    rf = 1.5 * sf
    scale = (ratio_dist * rf >= ratio_octave) \
        & (ratio_dist <= ratio_octave * rf)
    return X, seen(R1, t1, uv1, l1) & seen(R2, t2, uv2, l2) & parallax \
        & scale


# ------------------------------------------------------------------ #
# One tracking stage: projection search, match, robust pose solve
# ------------------------------------------------------------------ #

def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def se3_exp(xi):
    """exp of xi = [omega | upsilon]: (R, t)."""
    w, u = xi[:3], xi[3:]
    th2 = torch.sum(w * w)
    th = torch.sqrt(torch.clamp(th2, min=1e-16))
    small = th2 < 1e-4
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2)
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (th - torch.sin(th)) / (th2 * th))
    Wm = _hat(w)
    I = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = I + a * Wm + b * (Wm @ Wm)
    V = I + b * Wm + c * (Wm @ Wm)
    return R, V @ u


def orthonormalize(R, iterations=2):
    for _ in range(iterations):
        R = 1.5 * R - 0.5 * R @ R.transpose(-1, -2) @ R
    return R


# ORB-SLAM2's Optimizer::PoseOptimization solves no pose from fewer matches.
MIN_POSE_MATCHES = 3


def solve_pose(R, t, X, obs, w_info, valid, cam, opt, dtype):
    """ORB-SLAM2's PoseOptimization as the port schedules it: ``rounds``
    rounds of ``iters`` Gauss-Newton steps on the (u, v, u_right) edges,
    Huber weights in the first two rounds, chi^2 gating after each, the
    step clipped at 0.5. All arithmetic in ``dtype``. Returns (R, t,
    inliers).

    With fewer than ``MIN_POSE_MATCHES`` valid matches there is no pose to
    solve for (6 unknowns, 2-3 rows a match): the input pose comes back
    unchanged with no inliers, as ORB-SLAM2's
    ``Optimizer::PoseOptimization`` returns before optimising when
    ``nInitialCorrespondences < 3``. The check (``checks.compare_stage``)
    compares no pose there, whatever this returns; the early return is for
    the control, which puts this solve in the port's place and so skips
    these solves as ORB-SLAM2 does."""
    R, t, X, obs, w_info = (x.to(dtype) for x in (R, t, X, obs, w_info))
    if int(valid.sum()) < MIN_POSE_MATCHES:
        return R, t, torch.zeros_like(valid)
    stereo = obs[:, 2] >= 0.0
    chi2_th = torch.where(stereo, torch.tensor(opt["chi2_stereo"], dtype=dtype,
                                               device=X.device),
                          torch.tensor(opt["chi2_mono"], dtype=dtype,
                                       device=X.device))
    delta = torch.sqrt(chi2_th)
    eye6 = 1e-6 * torch.eye(6, dtype=dtype, device=X.device)
    fx, fy, cx, cy, bf = cam.fx, cam.fy, cam.cx, cam.cy, cam.bf

    def residual(R, t):
        p = X @ R.T + t
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        iz = 1.0 / torch.where(z < 1e-6, torch.full_like(z, 1e-6), z)
        u = fx * x * iz + cx
        v = fy * y * iz + cy
        e = obs - torch.stack([u, v, u - bf * iz], -1)
        e = torch.cat([e[:, :2], torch.where(stereo, e[:, 2],
                                             torch.zeros_like(x))[:, None]], 1)
        return e, (x, y, z, iz)

    active = valid
    for rnd in range(opt["rounds"]):
        for _ in range(opt["iters"]):
            e, (x, y, z, iz) = residual(R, t)
            c2 = torch.sum(e * e, -1) * w_info
            err = torch.sqrt(torch.clamp(c2, min=1e-12))
            wr = torch.where(err > delta, delta / err, torch.ones_like(err)) \
                if rnd < 2 else torch.ones_like(err)
            w = wr * w_info * active.to(dtype)
            iz2 = iz * iz
            zero, one = torch.zeros_like(x), torch.ones_like(x)
            dp = torch.stack([
                torch.stack([fx * iz, zero, -fx * x * iz2], -1),
                torch.stack([zero, fy * iz, -fy * y * iz2], -1),
                torch.stack([fx * iz, zero, -fx * x * iz2 + bf * iz2], -1)], -2)
            dxi = torch.stack([
                torch.stack([zero, z, -y, one, zero, zero], -1),
                torch.stack([-z, zero, x, zero, one, zero], -1),
                torch.stack([y, -x, zero, zero, zero, one], -1)], -2)
            J = dp @ dxi
            J = torch.cat([J[:, :2], torch.where(stereo[:, None], J[:, 2],
                                                 torch.zeros_like(J[:, 2]))
                           [:, None]], 1)
            H = torch.einsum("nri,n,nrj->ij", J, w, J) + eye6
            b = torch.einsum("nri,n,nr->i", J, w, e)
            step = torch.linalg.solve_ex(H.to(torch.float64) if dtype ==
                                         torch.bfloat16 else H,
                                         b.to(torch.float64) if dtype ==
                                         torch.bfloat16 else b)[0].to(dtype)
            nrm = torch.linalg.norm(step)
            step = step * torch.clamp(0.5 / torch.clamp(nrm, min=1e-12),
                                      max=1.0)
            dR, dt = se3_exp(step)
            R, t = orthonormalize(dR @ R), dR @ t + dt
        e, _ = residual(R, t)
        active = valid & (torch.sum(e * e, -1) * w_info <= chi2_th)
    return R, t, active


def _se3_exp_batch(xi):
    """exp of xi [K, 6] = [omega | upsilon]: (R [K, 3, 3], t [K, 3])."""
    w, u = xi[:, :3], xi[:, 3:]
    th2 = torch.sum(w * w, -1)[:, None, None]
    th = torch.sqrt(torch.clamp(th2, min=1e-16))
    small = th2 < 1e-4
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2)
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (th - torch.sin(th)) / (th2 * th))
    Wm = _hat(w)
    I = torch.eye(3, dtype=xi.dtype, device=xi.device)
    V = I + b * Wm + c * (Wm @ Wm)
    return I + a * Wm + b * (Wm @ Wm), torch.einsum("kij,kj->ki", V, u)


def _inv3(H):
    """Inverses of [..., 3, 3] by the adjugate (any dtype)."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    g, h, k = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    adj = torch.stack([
        torch.stack([e * k - f * h, c * h - b * k, b * f - c * e], -1),
        torch.stack([f * g - d * k, a * k - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1)], -2)
    det = a * adj[..., 0, 0] + b * adj[..., 1, 0] + c * adj[..., 2, 0]
    det = torch.where(torch.abs(det) < 1e-18, torch.full_like(det, 1e-18),
                      det)
    return adj / det[..., None, None]


def windowed_ba(R, t, kf_fixed, kf_valid, X, pt_valid, obs_kf, obs_uvr,
                obs_w, obs_valid, cam, opt, dtype):
    """ORB-SLAM2's LocalBundleAdjustment as the port schedules it, on the
    window the timed path built (keyframe poses R [K, 3, 3], t [K, 3];
    points X [P, 3]; per point up to M observations: keyframe index,
    (u, v, u_right) with u_right < 0 for a monocular edge, information,
    validity): ``ba_first`` Gauss-Newton steps with Huber weights, the
    chi^2 gate, ``ba_second`` more, the final gate. Each step marginalises
    the points (Schur complement), solves the free cameras with damping,
    clips each camera's and each point's step at 0.5 and back-substitutes.
    All arithmetic in ``dtype`` (the dense camera solve in float64 for
    bfloat16, which has none). Returns (R, t, X, final observation
    validity)."""
    R, t, X, obs_uvr, obs_w = (x.to(dtype) for x in (R, t, X, obs_uvr,
                                                     obs_w))
    dev = X.device
    K = R.shape[0]
    fx, fy, cx, cy, bf = cam.fx, cam.fy, cam.cx, cam.cy, cam.bf
    stereo = obs_uvr[..., 2] >= 0.0
    th = torch.where(stereo, torch.tensor(opt["chi2_stereo"], dtype=dtype,
                                          device=dev),
                     torch.tensor(opt["chi2_mono"], dtype=dtype, device=dev))
    delta = torch.sqrt(th)
    kidx = torch.clamp(obs_kf, min=0)
    has = (obs_kf >= 0) & pt_valid[:, None]
    free = ~kf_fixed & kf_valid
    damping = 1e-5

    def residual(R, t, X):
        Rk = R[kidx]                                          # [P, M, 3, 3]
        p = torch.einsum("pmij,pj->pmi", Rk, X) + t[kidx]
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        iz = 1.0 / torch.where(z < 1e-6, torch.full_like(z, 1e-6), z)
        u = fx * x * iz + cx
        e = obs_uvr - torch.stack([u, fy * y * iz + cy, u - bf * iz], -1)
        e = torch.stack([e[..., 0], e[..., 1],
                         torch.where(stereo, e[..., 2],
                                     torch.zeros_like(x))], -1)
        return e, (x, y, z, iz, Rk)

    def gate(R, t, X, active):
        e, _ = residual(R, t, X)
        return active & (torch.sum(e * e, -1) * obs_w <= th)

    def step(R, t, X, active):
        e, (x, y, z, iz, Rk) = residual(R, t, X)
        c2 = torch.sum(e * e, -1) * obs_w
        err = torch.sqrt(torch.clamp(c2, min=1e-12))
        w = torch.where(err > delta, delta / err, torch.ones_like(err)) \
            * obs_w * (active & has).to(dtype)
        zero, one = torch.zeros_like(x), torch.ones_like(x)
        iz2 = iz * iz
        dpred = torch.stack([
            torch.stack([fx * iz, zero, -fx * x * iz2], -1),
            torch.stack([zero, fy * iz, -fy * y * iz2], -1),
            torch.stack([torch.where(stereo, fx * iz, zero), zero,
                         torch.where(stereo, -fx * x * iz2 + bf * iz2,
                                     zero)], -1)], -2)
        dxi = torch.stack([
            torch.stack([zero, z, -y, one, zero, zero], -1),
            torch.stack([-z, zero, x, zero, one, zero], -1),
            torch.stack([y, -x, zero, zero, zero, one], -1)], -2)
        Jc = dpred @ dxi                                      # [P, M, 3, 6]
        Jp = dpred @ Rk                                       # [P, M, 3, 3]
        Hpp = torch.einsum("pmri,pm,pmrj->pij", Jp, w, Jp)
        Hpp = Hpp + torch.diag_embed(
            1e-3 * torch.diagonal(Hpp, dim1=-2, dim2=-1) + damping)
        Hi = _inv3(Hpp)
        bp = torch.einsum("pmri,pm,pmr->pi", Jp, w, e)
        A = torch.einsum("pmri,pm,pmrj->pmij", Jc, w, Jp)     # [P, M, 6, 3]
        oh = (kidx[..., None] == torch.arange(K, device=dev)).to(dtype) \
            * has[..., None].to(dtype)                        # [P, M, K]
        Hcc = torch.einsum("pmk,pmri,pm,pmrj->kij", oh, Jc, w, Jc)
        bc = torch.einsum("pmk,pmri,pm,pmr->ki", oh, Jc, w, e)
        T = torch.einsum("pmk,pmis->pkis", oh, A @ Hi[:, None])
        U = torch.einsum("pmk,pmis->pkis", oh, A)
        S = -torch.einsum("pkis,pljs->kilj", T, U)            # [K, 6, K, 6]
        for k in range(K):
            S[k, :, k, :] += Hcc[k]
        b = bc - torch.einsum("pkis,ps->ki", T, bp)
        f = free.to(dtype)
        S = S * f[:, None, None, None] * f[None, None, :, None]
        eye = torch.eye(6, dtype=dtype, device=dev)
        for k in range(K):
            S[k, :, k, :] += eye * (damping if bool(free[k]) else 1.0)
        b = b * f[:, None]
        solve_t = torch.float64 if dtype == torch.bfloat16 else dtype
        d = torch.linalg.solve_ex(S.reshape(6 * K, 6 * K).to(solve_t),
                                  b.reshape(6 * K).to(solve_t))[0]
        d = d.to(dtype).reshape(K, 6)
        d = d * torch.clamp(0.5 / torch.clamp(torch.linalg.norm(
            d, dim=-1, keepdim=True), min=1e-12), max=1.0) * f[:, None]
        dp = torch.einsum("psj,pj->ps", Hi,
                          bp - torch.einsum("pmij,pmi->pj", A, d[kidx]))
        dp = dp * torch.clamp(0.5 / torch.clamp(torch.linalg.norm(
            dp, dim=-1, keepdim=True), min=1e-12), max=1.0)
        X = X + dp * pt_valid[:, None].to(dtype)
        dR, dt = _se3_exp_batch(d)
        return (orthonormalize(dR @ R),
                torch.einsum("kij,kj->ki", dR, t) + dt, X)

    active = obs_valid
    for _ in range(opt["ba_first"]):
        R, t, X = step(R, t, X, active)
    active = gate(R, t, X, active)
    for _ in range(opt["ba_second"]):
        R, t, X = step(R, t, X, active)
    return R, t, X, gate(R, t, X, active)


def rotation_filter(aq, at, m: Match, histo=30, top_bins=3):
    dev = aq.device
    rot = aq - at[torch.clamp(m.idx, min=0)]
    two_pi = torch.full((), 2.0 * math.pi, dtype=torch.float32, device=dev)
    rot = torch.fmod(rot, two_pi)
    rot = torch.where((rot != 0) & (rot < 0), rot + two_pi, rot)
    bins = torch.clamp((rot * histo / two_pi).to(torch.int64), 0, histo - 1)
    onehot = bins[:, None] == torch.arange(histo, device=dev)[None, :]
    counts = torch.sum(onehot & m.valid[:, None], dim=0)
    tc, ti = torch.sort(counts, descending=True, stable=True)
    tc, ti = tc[:top_bins], ti[:top_bins]
    keep = torch.zeros(histo, dtype=torch.bool, device=dev).index_put(
        (ti,), tc.to(torch.float32) > 0.1 * tc[0])
    ok = m.valid & keep[bins]
    return Match(torch.where(ok, m.idx, torch.full_like(m.idx, -1)), m.dist, ok)


def track_stage(uv, level, angle, desc_signed, valid, obs, w_info, R, t,
                pts, pt_sd, pt_valid, pt_angle, pt_normal, pt_min, pt_max,
                radius, cam, orb_sf, n_levels, match_cfg, opt, dtype):
    """One tracking stage (Tracking's SearchByProjection then
    PoseOptimization): project the candidate points from (R, t), match the
    keypoints within ``radius`` x level scale and +-1 octave of the
    predicted one, keep the rotation-consistent matches, then solve the
    pose (``solve_pose``: none from fewer than 3 matches). Returns (R, t,
    point index per keypoint of the final inliers or -1, the number of
    matches that entered the solve)."""
    pc = pts @ R.T + t
    z = pc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = cam.fx * pc[:, 0] / zs + cam.cx
    v = cam.fy * pc[:, 1] / zs + cam.cy
    vis = pt_valid & (z > 1e-6) & (u >= -radius) & (u < cam.width + radius) \
        & (v >= -radius) & (v < cam.height + radius)
    center = -R.T @ t
    vec = pts - center
    dist = torch.linalg.norm(vec, dim=-1)
    vis = vis & (dist > 0.8 * pt_min) & (dist < 1.2 * pt_max) \
        & (torch.einsum("mi,mi->m", vec / torch.clamp(dist, min=1e-9)[:, None],
                        pt_normal) > 0.5)
    d = hamming(desc_signed, pt_sd)
    sf = torch.full((), orb_sf, dtype=torch.float32, device=pts.device)
    scale = torch.pow(sf, level.to(torch.float32))
    r = radius * scale[:, None]
    d = d + torch.where((torch.abs(uv[:, None, 0] - u[None, :]) <= r)
                        & (torch.abs(uv[:, None, 1] - v[None, :]) <= r),
                        0.0, BIG)
    pred = torch.ceil(torch.log(torch.clamp(pt_max, min=1e-6)
                                / torch.clamp(dist, min=1e-6)) / torch.log(sf))
    pred = torch.clamp(pred, 0, n_levels - 1)
    d = d + torch.where(torch.abs(level[:, None].to(torch.float32)
                                  - pred[None, :]) <= 1.0, 0.0, BIG)
    m = match(d, match_cfg["th_high"], ratio=match_cfg["nn_ratio_tracking"],
              mutual=True, row_valid=valid, col_valid=vis)
    m = rotation_filter(angle, pt_angle, m, match_cfg["histo_length"])
    X = pts[torch.clamp(m.idx, min=0)]
    R2, t2, inl = solve_pose(R, t, X, obs, w_info, m.valid, cam, opt, dtype)
    return (R2, t2, torch.where(inl, m.idx, torch.full_like(m.idx, -1)),
            int(m.valid.sum()))


# ------------------------------------------------------------------ #
# YOLOv5s v6.0 (depth 0.33, width 0.50), inference BatchNorm
# ------------------------------------------------------------------ #

def _width(c, mult):
    return int(math.ceil(c * mult / 8) * 8)


def _depth(n, mult):
    return max(int(round(n * mult)), 1)


class ConvBN(nn.Module):
    def __init__(self, cin, cout, k=1, s=1, pad=-1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, s, k // 2 if pad < 0 else pad,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3, momentum=0.03)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, cin, cout, shortcut=True):
        super().__init__()
        self.cv1 = ConvBN(cin, cout, 1)
        self.cv2 = ConvBN(cout, cout, 3)
        self.add = shortcut and cin == cout

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    def __init__(self, cin, cout, n=1, shortcut=True):
        super().__init__()
        h = cout // 2
        self.cv1 = ConvBN(cin, h, 1)
        self.cv2 = ConvBN(cin, h, 1)
        self.cv3 = ConvBN(2 * h, cout, 1)
        self.m = nn.Sequential(*(Bottleneck(h, h, shortcut) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class SPPF(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        h = cin // 2
        self.cv1 = ConvBN(cin, h, 1)
        self.cv2 = ConvBN(4 * h, cout, 1)

    def forward(self, x):
        x = self.cv1(x)
        p1 = F.max_pool2d(x, 5, 1, 2)
        p2 = F.max_pool2d(p1, 5, 1, 2)
        return self.cv2(torch.cat([x, p1, p2, F.max_pool2d(p2, 5, 1, 2)], 1))


def _up2(x):
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class YoloV5s(nn.Module):
    """yolov5s.yaml v6.0: backbone rows 0-9, head rows 10-23, Detect on P3,
    P4, P5. Returns the raw heads [B, H, W, 3, 5 + nc]."""

    def __init__(self, nc=80, wm=0.50, dm=0.33):
        super().__init__()
        w = lambda c: _width(c, wm)
        d = lambda n: _depth(n, dm)
        self.nc = nc
        self.b0 = ConvBN(3, w(64), 6, 2, pad=2)
        self.b1 = ConvBN(w(64), w(128), 3, 2)
        self.b2 = C3(w(128), w(128), d(3))
        self.b3 = ConvBN(w(128), w(256), 3, 2)
        self.b4 = C3(w(256), w(256), d(6))
        self.b5 = ConvBN(w(256), w(512), 3, 2)
        self.b6 = C3(w(512), w(512), d(9))
        self.b7 = ConvBN(w(512), w(1024), 3, 2)
        self.b8 = C3(w(1024), w(1024), d(3))
        self.b9 = SPPF(w(1024), w(1024))
        self.h10 = ConvBN(w(1024), w(512), 1)
        self.h13 = C3(2 * w(512), w(512), d(3), shortcut=False)
        self.h14 = ConvBN(w(512), w(256), 1)
        self.h17 = C3(2 * w(256), w(256), d(3), shortcut=False)
        self.h18 = ConvBN(w(256), w(256), 3, 2)
        self.h20 = C3(2 * w(256), w(512), d(3), shortcut=False)
        self.h21 = ConvBN(w(512), w(512), 3, 2)
        self.h23 = C3(2 * w(512), w(1024), d(3), shortcut=False)
        self.detect = nn.ModuleList(nn.Conv2d(c, 3 * (5 + nc), 1)
                                    for c in (w(256), w(512), w(1024)))

    def forward(self, x) -> List[torch.Tensor]:
        x = self.b3(self.b2(self.b1(self.b0(x))))
        p3 = self.b4(x)
        p4 = self.b6(self.b5(p3))
        p5 = self.b9(self.b8(self.b7(p4)))
        h10 = self.h10(p5)
        h14 = self.h14(self.h13(torch.cat([_up2(h10), p4], 1)))
        o3 = self.h17(torch.cat([_up2(h14), p3], 1))
        o4 = self.h20(torch.cat([self.h18(o3), h14], 1))
        o5 = self.h23(torch.cat([self.h21(o4), h10], 1))
        outs = []
        for conv, feat in zip(self.detect, (o3, o4, o5)):
            y = conv(feat)
            b, _, hh, ww = y.shape
            outs.append(y.view(b, 3, 5 + self.nc, hh, ww).permute(0, 3, 4, 1, 2))
        return outs


def detector_input(gray_u8, size):
    """An [H, W] grey frame as the network's [1, 3, size, size] input:
    / 255, antialiased linear resize, three equal channels."""
    img = resize(gray_u8.to(torch.float32) / 255.0, (size, size))
    return img[None, None].expand(1, 3, size, size)


def make_detector(det: dict, seed: int, calib, device) -> YoloV5s:
    """YOLOv5s with weights from ``seed``: every convolution kernel drawn
    in one call of a generator on ``device`` (normal, variance 1 /
    fan_in), then each BatchNorm's statistics set to those of its input on
    ``calib`` and each Detect channel scaled and shifted to zero mean and
    unit variance there, so the logits have unit scale on such frames."""
    model = YoloV5s(det["num_classes"], det["width_multiple"],
                    det["depth_multiple"]).to(device)
    convs = [m for m in model.modules() if isinstance(m, nn.Conv2d)]
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2 ** 63 - 1))
    flat = torch.randn(sum(m.weight.numel() for m in convs), generator=gen,
                       device=device)
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    with torch.no_grad():
        o = 0
        for m in convs:
            n = m.weight.numel()
            m.weight.copy_(flat[o:o + n].view_as(m.weight)
                           / math.sqrt(m.weight[0].numel()))
            o += n
            if m.bias is not None:
                m.bias.zero_()
        for bn in bns:
            bn.reset_parameters()
            bn.momentum = 1.0
        model.train()
        with tf32(False):
            model(calib)
            for bn in bns:
                bn.momentum = 0.03
                bn.num_batches_tracked.zero_()
            model.eval()
            for conv, r in zip(model.detect, model(calib)):
                r = r.reshape(-1, conv.out_channels)
                mean, std = r.mean(0), r.std(0)
                conv.weight /= std[:, None, None, None]
                conv.bias.copy_(-mean / std)
    return model.eval()

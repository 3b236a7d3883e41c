"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the repository root:  python3 chip_smoke.py

Phases (each one failing the run with a non-zero exit when it fails):
  1. The card's name and power limit; build the CUDA FAST kernel
     (coebslam_tpu_torch/csrc/fast.cu -> build/) and print the build time.
  2. The kernel against its plain PyTorch version on the card: a rendered
     640x480 frame's 8-level pyramid in the extractor's canvas, and a random
     123x161 image, at thr 7 and 10. Score bit-equal; strength equal to the
     plain (zero-padded) version everywhere and to the edge-padded
     reference formula inside each level.
  3. The extractor on the card through the kernel against the extractor
     with the plain FAST: valid equal, uv within 1e-4, descriptors
     bit-equal.
  4. The main path: RealtimeSlam at full width (SystemConfig() and
     RTLimits() defaults) over the two-pass dynamic orbit of bench.py
     (150 rendered frames with the walker and its ground-truth boxes, run
     twice). Every frame must track, ATE < 2.5 cm, and the kernel must be
     launched once per frame. Prints fps of the second pass, keyframes,
     live points and host synchronisations per frame.
  5. The kernel's time on the card beside the plain version's and the
     bound, at the main path's shape: CUDA events around one call queued
     behind a device-side sleep (so host dispatch is not timed), median of
     200 calls (50 for the plain version).
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. There is no CPU fallback: without CUDA the
script exits with code 2 and prints no result.
"""
import contextlib
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

N_FRAMES = 150
ATE_LIMIT_M = 0.025
JAX_CPU_ATE_M = 0.0181       # the JAX package on CPU, same scene and config
MEM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
FP32_OPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
# Operations per pixel of the fused FAST function as csrc/fast.cu counts
# them (16 differences, 128 windowed min/max, 32 + 15 arc maxima, 3 gate,
# 9 NMS).
FAST_OPS_PER_PIXEL = 203


def _fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        _fail(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def track_frames(rt, frames, lo, hi):
    """Track frames lo..hi-1 of a looped sequence ``frames = (gray, depth,
    boxes)`` at 30 fps stamps, then wait for the card."""
    gray, depth, boxes = frames
    for i in range(lo, hi):
        k = i % len(gray)
        rt.track(gray[k], depth[k], stamp=i / 30.0, boxes=boxes[k][None])
    rt.block()


@contextlib.contextmanager
def count_host_syncs(torch):
    """Count the host synchronisations made inside the block. Yields a dict
    that is filled, on exit, with the count at each source line."""
    sites = {}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield sites
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.basename(w.filename)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1


@contextlib.contextmanager
def _plain_fast(fast, fast_cuda):
    """Route the extractor's FAST call to the plain version (comparison
    runs only)."""
    orig = fast_cuda.strength_and_score
    fast_cuda.strength_and_score = fast.strength_and_score_plain
    try:
        yield
    finally:
        fast_cuda.strength_and_score = orig


def _events(torch):
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _device_ms(torch, fn, n):
    """Median over n calls of one call's time on the card (CUDA events).

    Each call is queued behind a device-side sleep that outlasts the call's
    host work, so the card meets the call's whole work already queued: the
    events time the device's work alone, not the host's dispatch.
    """
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    a, b = _events(torch)
    a.record()
    torch.cuda._sleep(10 ** 7)
    b.record()
    b.synchronize()
    cycles = int(10 ** 7 / a.elapsed_time(b) * (2.0 * host_ms + 1.0))
    times = []
    for _ in range(n):
        a, b = _events(torch)
        torch.cuda._sleep(cycles)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from coebslam_tpu_torch.config import SystemConfig
    from coebslam_tpu_torch.eval import ate
    from coebslam_tpu_torch.ops import extractor, fast, fast_cuda
    from coebslam_tpu_torch.slam.realtime import RealtimeSlam, RTLimits
    from coebslam_tpu_torch.utils import synthetic

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    # ---- 1. card + build
    card_line = card()
    print(card_line, flush=True)
    t0 = time.perf_counter()
    lib = fast_cuda.build()
    fast_cuda._load()
    print(f"[1] built {os.path.relpath(lib)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 2. kernel vs plain on the card
    cfg = SystemConfig()
    cam = cfg.camera
    planes = synthetic.make_room(seed=0, device=dev)
    pose = synthetic.camera_trajectory(10, radius=0.35)[3]
    frame = torch.clamp(synthetic.render(cam, pose, planes)[0], 0, 255)
    canv, hw = extractor.level_canvas(frame, cfg.orb)
    rnd = torch.from_numpy((np.random.RandomState(3).rand(1, 123, 161)
                            * 255).astype(np.float32)).to(dev)
    cases = [(canv, hw), (rnd, torch.tensor([[123, 161]], dtype=torch.int32,
                                            device=dev))]
    max_err = 0.0
    for c, ext in cases:
        for thr in (7.0, 10.0):
            t = torch.tensor(thr, device=dev)
            st_k, sc_k = fast_cuda.strength_and_score(c, t, ext)
            st_p, sc_p = fast.strength_and_score_plain(c, t, ext)
            st_e = fast.strength_map(c)          # edge-padded reference
            torch.cuda.synchronize()
            if not torch.equal(sc_k, sc_p):
                _fail(f"FAST score differs from plain at {tuple(c.shape)}, "
                      f"thr {thr}")
            if not torch.equal(st_k, st_p):
                _fail(f"FAST strength differs from plain at {tuple(c.shape)}")
            for l, (h, w) in enumerate(ext.tolist()):
                if not torch.equal(st_k[l, 4:h - 4, 4:w - 4],
                                   st_e[l, 4:h - 4, 4:w - 4]):
                    _fail(f"FAST strength differs inside level {l}")
            max_err = max(max_err, float((sc_k - sc_p).abs().max()),
                          float((st_k - st_p).abs().max()))
            print(f"[2] FAST {tuple(c.shape)} thr {thr:g}: score and "
                  f"strength bit-equal, {int((sc_k > 0).sum())} corners",
                  flush=True)

    # ---- 3. extractor: kernel path vs plain path on the card
    mask = torch.zeros((cam.height, cam.width), dtype=torch.bool, device=dev)
    mask[:, :200] = True
    for area in (False, True):
        kw = dict(dynamic_mask=mask, area_mode=torch.tensor(area, device=dev))
        fk = extractor.extract(frame, cfg.orb, **kw)
        with _plain_fast(fast, fast_cuda):
            fp = extractor.extract(frame, cfg.orb, **kw)
        if not torch.equal(fk.valid, fp.valid):
            _fail("extractor: valid differs between kernel and plain FAST")
        uv_err = float((fk.uv - fp.uv).abs().max())
        if uv_err > 1e-4 or not torch.equal(fk.desc, fp.desc):
            _fail(f"extractor: uv err {uv_err} / descriptors differ")
        print(f"[3] extractor area_mode={area}: {int(fk.valid.sum())} "
              f"keypoints, valid equal, uv err {uv_err:g}, desc bit-equal",
              flush=True)

    # ---- 4. the main path
    t0 = time.perf_counter()
    G, D, B, C = synthetic.dynamic_orbit(cam, N_FRAMES)
    print(f"[4] rendered {N_FRAMES} frames in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rt = RealtimeSlam(cfg, RTLimits())
    fast_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    track_frames(rt, (G, D, B), 0, N_FRAMES)
    pass1_s = time.perf_counter() - t0
    with count_host_syncs(torch) as sync_sites:
        t0 = time.perf_counter()
        track_frames(rt, (G, D, B), N_FRAMES, 2 * N_FRAMES)
        pass2_s = time.perf_counter() - t0
    launches = fast_cuda.LAUNCHES
    n_syncs = sum(sync_sites.values())
    res = rt.finish()
    n = len(res["ok"])
    gt = np.tile(C, (2, 1))[:n]
    est = np.asarray([-R.T @ t for R, t in zip(res["R"], res["t"])])
    rmse = ate.ate_rmse(res["stamps"], est, np.arange(n) / 30.0, gt)["rmse"]
    fps = N_FRAMES / pass2_s
    print(f"[4] frames OK {int(res['ok'].sum())}/{n}, ATE {rmse * 100:.3f} cm "
          f"(limit {ATE_LIMIT_M * 100:.1f} cm; JAX package on CPU "
          f"{JAX_CPU_ATE_M * 100:.2f} cm), keyframes {res['n_kf']}, live "
          f"points {int(res['pt_valid'].sum())}, BA-culled "
          f"{res['n_ba_culled']}, fused {res['n_assoc']}", flush=True)
    print(f"[4] pass 1 {pass1_s:.1f} s ({N_FRAMES / pass1_s:.2f} fps), "
          f"pass 2 {pass2_s:.1f} s ({fps:.2f} fps); host syncs "
          f"{n_syncs} in pass 2 = {n_syncs / N_FRAMES:.2f} per frame "
          f"{sync_sites}; FAST launches {launches} for {n} frames",
          flush=True)
    if n != 2 * N_FRAMES or not res["ok"].all():
        _fail(f"{int(res['ok'].sum())}/{n} frames tracked")
    if not np.isfinite(est).all() or rmse >= ATE_LIMIT_M:
        _fail(f"ATE {rmse} m >= {ATE_LIMIT_M} m")
    if launches != n:
        _fail(f"FAST kernel launched {launches} times for {n} frames")

    # ---- 5. kernel time beside the plain version and the bound
    thr = torch.tensor(float(cfg.orb.fast_threshold_min), device=dev)
    ms = _device_ms(torch,
                    lambda: fast_cuda.strength_and_score(canv, thr, hw), 200)
    plain_ms = _device_ms(
        torch, lambda: fast.strength_and_score_plain(canv, thr, hw), 50)
    ms_2 = _device_ms(torch,
                      lambda: fast_cuda.strength_and_score(canv, thr, hw), 200)
    px = canv.numel()
    bytes_ms = px * 4 * 3 / MEM_BYTES_PER_S * 1e3
    ops_ms = px * FAST_OPS_PER_PIXEL / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[5] FAST {tuple(canv.shape)}: kernel {ms:.4f} / {ms_2:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes "
          f"{bytes_ms:.4f}, ops {ops_ms:.4f}) on {card_line}", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    kernels = [{
        "name": "fast_strength_score", "route": "cuda",
        "source": "coebslam_tpu_torch/csrc/fast.cu",
        "replaces": "coebslam_tpu/ops/fast_pallas.py:37",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

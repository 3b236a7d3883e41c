"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the repository root:  python3 chip_smoke.py

Phases (each one failing the run with a non-zero exit when it fails):
  1. The card's name and power limit; build the CUDA FAST kernel
     (coebslam_tpu_torch/csrc/fast.cu -> build/) and print the build time
     and the registers, shared memory and spills ptxas reports.
  2. The kernel against its plain PyTorch version on the card, at thr 7
     and 10: a rendered 640x480 frame's 8-level pyramid in the extractor's
     canvas, and the canvases of FAST_EDGE_CASES (extents one pixel below,
     at and above the kernel's 64x32 tile, an extent + 3 on a tile seam,
     W % 4 == 0 and != 0, integer-valued images for NMS ties, negative
     samples for the kernel's float path). Score and
     strength bit-equal over the whole canvas; strength also equal to the
     edge-padded reference formula inside each level.
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
     bound (fast_cuda.work: live input bytes read once, both outputs
     written once), at the main path's shape: CUDA events around one call
     queued behind a device-side sleep (so host dispatch is not timed),
     median of 200 calls (50 for the plain version). Cold: a 128 MiB
     buffer (over twice the L2) is written between the sleep and the call,
     so the call finds nothing in L2; warm: without it, as the main path
     finds the canvas that level_canvas has just written. An empty kernel
     timed the same way shows what the method cannot go below. Fails only
     on a time that is not finite.
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
L2_FLUSH_BYTES = 128 << 20   # written before a cold call: over twice the L2

# Canvases for the FAST kernel's edges (its tiles are 64 x 32 px): name,
# H, W, the true extent of each level, and the values in it: "uniform" in
# [0, 255), "integer" (multiples of 16 in [0, 48], for NMS ties) or
# "signed" (uniform in [-100, 155), which takes the kernel's float path).
FAST_EDGE_CASES = (
    ("extents at the tile size -1/0/+1", 70, 132,
     ((31, 63), (32, 64), (33, 65)), "uniform"),
    ("extent + 3 on a tile seam", 96, 192, ((61, 125), (29, 61)), "uniform"),
    ("W % 4 != 0", 123, 161, ((123, 161), (64, 97)), "uniform"),
    ("integer, W % 4 == 0", 100, 200, ((100, 200), (70, 129)), "integer"),
    ("integer, W % 4 != 0", 99, 133, ((99, 133), (61, 125)), "integer"),
    ("negative samples", 96, 200, ((96, 200), (70, 129)), "signed"),
)


def fast_edge_cases(torch, device, seed=3):
    """[(name, canvas [L, H, W] f32, hw [L, 2] i32)] of FAST_EDGE_CASES on
    ``device``: each level random in its extent and zero beyond it (the
    kernel's contract), from a numpy seed."""
    rng = np.random.RandomState(seed)
    cases = []
    for name, H, W, exts, values in FAST_EDGE_CASES:
        canvas = np.zeros((len(exts), H, W), np.float32)
        for l, (h, w) in enumerate(exts):
            if values == "integer":
                canvas[l, :h, :w] = rng.randint(0, 4, (h, w)) * 16.0
            else:
                canvas[l, :h, :w] = rng.rand(h, w) * 255 - (
                    100.0 if values == "signed" else 0.0)
        cases.append((name, torch.from_numpy(canvas).to(device),
                      torch.tensor(exts, dtype=torch.int32, device=device)))
    return cases


def ptxas_report(lib):
    """The lines of a built library's ``-Xptxas -v`` report that give each
    kernel's registers, shared memory and spills."""
    text = lib.with_name(f"{lib.stem}.ptxas.txt").read_text()
    return [line.strip() for line in text.splitlines()
            if "Used" in line or "spill" in line or "Compiling" in line]


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


def l2_flush(torch):
    """A callable that writes L2_FLUSH_BYTES on the card, evicting L2 (the
    last of those lines stay in L2, dirty, and the timed call pays for
    writing them back)."""
    buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    return lambda: buf.fill_(1.0)


def _device_ms(torch, fn, n, flush=None):
    """Median over n calls of one call's time on the card (CUDA events).

    Each call is queued behind a device-side sleep that outlasts the call's
    host work, so the card meets the call's whole work already queued: the
    events time the device's work alone, not the host's dispatch. With
    ``flush`` (from ``l2_flush``), it runs after the sleep and before the
    first event, so the call starts with a cold L2.
    """
    pre = flush or (lambda: None)
    for _ in range(5):
        pre()
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre()
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
        pre()
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
    fast_cuda.load(lib)
    print(f"[1] built {os.path.relpath(lib)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in ptxas_report(lib):
        print(f"[1] ptxas: {line}", flush=True)

    # ---- 2. kernel vs plain on the card
    cfg = SystemConfig()
    cam = cfg.camera
    planes = synthetic.make_room(seed=0, device=dev)
    pose = synthetic.camera_trajectory(10, radius=0.35)[3]
    frame = torch.clamp(synthetic.render(cam, pose, planes)[0], 0, 255)
    canv, hw = extractor.level_canvas(frame, cfg.orb)
    cases = [("main path", canv, hw)] + fast_edge_cases(torch, dev)
    max_err = 0.0
    for name, c, ext in cases:
        for thr in (7.0, 10.0):
            t = torch.tensor(thr, device=dev)
            st_k, sc_k = fast_cuda.strength_and_score(c, t, ext)
            st_p, sc_p = fast.strength_and_score_plain(c, t, ext)
            st_e = fast.strength_map(c)          # edge-padded reference
            torch.cuda.synchronize()
            if not torch.equal(sc_k, sc_p):
                _fail(f"FAST score differs from plain: {name}, thr {thr}")
            if not torch.equal(st_k, st_p):
                _fail(f"FAST strength differs from plain: {name}")
            for l, (h, w) in enumerate(ext.tolist()):
                if not torch.equal(st_k[l, 4:h - 4, 4:w - 4],
                                   st_e[l, 4:h - 4, 4:w - 4]):
                    _fail(f"FAST strength differs inside level {l}")
            max_err = max(max_err, float((sc_k - sc_p).abs().max()),
                          float((st_k - st_p).abs().max()))
            print(f"[2] FAST {name} {tuple(c.shape)} thr {thr:g}: score and "
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
    flush = l2_flush(torch)

    def kernel():
        return fast_cuda.strength_and_score(canv, thr, hw)

    def plain():
        return fast.strength_and_score_plain(canv, thr, hw)

    ms = _device_ms(torch, kernel, 200, flush)
    ms_warm = _device_ms(torch, kernel, 200)
    plain_ms = _device_ms(torch, plain, 50, flush)
    plain_warm = _device_ms(torch, plain, 50)
    ms_2 = _device_ms(torch, kernel, 200, flush)
    empty_ms = _device_ms(torch, lambda: torch.cuda._sleep(0), 200, flush)
    n_bytes, n_ops = fast_cuda.work(hw.tolist(), *canv.shape)
    bytes_ms = n_bytes / MEM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    times = (ms, ms_warm, plain_ms, plain_warm, ms_2, empty_ms)
    print(f"[5] FAST {tuple(canv.shape)}: kernel cold {ms:.4f} / {ms_2:.4f} "
          f"ms, warm {ms_warm:.4f} ms; plain cold {plain_ms:.4f} ms, warm "
          f"{plain_warm:.4f} ms; bound {bound_ms:.4f} ms (bytes {n_bytes} -> "
          f"{bytes_ms:.4f} ms, ops {n_ops} -> {ops_ms:.4f} ms), "
          f"{bound_ms / ms:.1%} of it cold; an empty kernel reads "
          f"{empty_ms:.4f} ms the same way; on {card_line}", flush=True)
    if not all(np.isfinite(t) and t > 0 for t in times):
        _fail(f"FAST times not finite: {times}")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    kernels = [{
        "name": "fast_strength_score", "route": "cuda",
        "source": "coebslam_tpu_torch/csrc/fast.cu",
        "replaces": "coebslam_tpu/ops/fast_pallas.py:37",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "ms_warm": ms_warm, "plain_ms": plain_ms,
        "plain_ms_warm": plain_warm, "empty_kernel_ms": empty_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bound_share": bound_ms / ms, "bytes": n_bytes, "ops": n_ops,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

"""Where the time of the port's realtime RGB-D path goes, on one NVIDIA GPU.

Run from the repository root:

    python3 profile_torch_realtime.py [--json PATH]

Renders bench.py's dynamic orbit with the port's renderer and runs
``RealtimeSlam`` at full width (``SystemConfig()``, ``RTLimits()``):
``WARM`` frames first, then ``TIMED`` frames timed with the host clock
(fps, host synchronisations per frame), then ``TRACED`` frames under
``torch.profiler``, which give per frame: the device's kernel time and busy
share, the kernel count, and the host and device time of each stage of
``rt_step`` (extraction, dynamic front-end, tracking, keyframe + BA), plus
the operators that take the most device and host time. The summary is
printed, and written as JSON to ``--json`` when given. There is no CPU
fallback: without CUDA the script exits with code 2.
"""
import argparse
import functools
import json
import os
import sys
import time

from chip_smoke import card, count_host_syncs, track_frames

STAGES = ("rt.extract", "rt.dynamic", "rt.track", "rt.keyframe_ba")
WARM, TIMED, TRACED = 30, 60, 20


def _annotate(torch, module, name, label):
    """Wrap ``module.name`` in a profiler range called ``label``."""
    fn = getattr(module, name)

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)

    setattr(module, name, wrapped)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the summary to this file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_realtime: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from coebslam_tpu_torch.config import SystemConfig
    from coebslam_tpu_torch.slam import dynamic, frame, realtime
    from coebslam_tpu_torch.utils import synthetic

    card_line = card()
    cfg = SystemConfig()
    frames = synthetic.dynamic_orbit(cfg.camera, 150)[:3]
    rt = realtime.RealtimeSlam(cfg, realtime.RTLimits())
    _annotate(torch, frame, "process_rgbd", STAGES[0])
    _annotate(torch, dynamic, "dynamic_step", STAGES[1])
    _annotate(torch, realtime, "fused_step", STAGES[2])
    _annotate(torch, realtime, "_create_keyframe", STAGES[3])

    track_frames(rt, frames, 0, WARM)
    with count_host_syncs(torch) as sites:
        t0 = time.perf_counter()
        track_frames(rt, frames, WARM, WARM + TIMED)
        timed_s = time.perf_counter() - t0

    kf0 = int(rt.state.n_kf)
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        track_frames(rt, frames, WARM + TIMED, WARM + TIMED + TRACED)
        traced_s = time.perf_counter() - t0
    n_kf = int(rt.state.n_kf) - kf0
    nt = TRACED
    # Device-side events are kernels, copies and fills, plus the stage
    # ranges mirrored on the device timeline (spans, not busy time).
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events()
               if e.device_type == cuda and e.name not in STAGES]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    avg = prof.key_averages()
    stage = {e.key: e for e in avg
             if e.key in STAGES and e.device_type == cpu}
    ops = [e for e in avg if e.key not in STAGES and e.device_type == cpu]
    top_dev = sorted(ops, key=lambda e: e.self_device_time_total,
                     reverse=True)[:12]
    top_cpu = sorted(ops, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:12]
    top_kernels = sorted(
        (e for e in avg if e.key not in STAGES and e.device_type == cuda),
        key=lambda e: e.self_device_time_total, reverse=True)[:8]

    summary = {
        "card": card_line, "frames_timed": TIMED,
        "fps": TIMED / timed_s,
        "ms_per_frame": timed_s / TIMED * 1e3,
        "host_syncs_per_frame": sum(sites.values()) / TIMED,
        "sync_sites": sites,
        "frames_traced": nt, "keyframes_traced": n_kf,
        "traced_ms_per_frame": traced_s / nt * 1e3,
        "device_ms_per_frame": dev_ms / nt,
        "device_busy_share": dev_ms / (traced_s * 1e3),
        "kernels_per_frame": len(kernels) / nt,
        "stages": {k: {"calls": stage[k].count,
                       "host_ms_per_frame":
                           stage[k].cpu_time_total / 1e3 / nt,
                       "device_ms_per_frame":
                           stage[k].device_time_total / 1e3 / nt}
                   for k in STAGES if k in stage},
        "top_device_ops": [(e.key, e.count,
                            e.self_device_time_total / 1e3 / nt)
                           for e in top_dev],
        "top_host_ops": [(e.key, e.count, e.self_cpu_time_total / 1e3 / nt)
                         for e in top_cpu],
        "top_kernels": [(e.key, e.count, e.self_device_time_total / 1e3 / nt)
                        for e in top_kernels],
    }
    print(card_line)
    print(f"timed {TIMED} frames: {summary['fps']:.3f} fps "
          f"({summary['ms_per_frame']:.1f} ms/frame), host syncs "
          f"{summary['host_syncs_per_frame']:.2f}/frame {sites}")
    print(f"traced {nt} frames ({n_kf} keyframes): "
          f"{summary['traced_ms_per_frame']:.1f} ms/frame wall, device "
          f"{summary['device_ms_per_frame']:.2f} ms/frame (busy share "
          f"{summary['device_busy_share']:.4f}), "
          f"{summary['kernels_per_frame']:.0f} kernels/frame")
    for k, v in summary["stages"].items():
        print(f"  {k:16s} calls {v['calls']:3d}  host "
              f"{v['host_ms_per_frame']:8.2f} ms/frame  device "
              f"{v['device_ms_per_frame']:7.3f} ms/frame")
    print("top operators by the device time of their kernels (ms/frame):")
    for k, c, ms in summary["top_device_ops"]:
        print(f"  {ms:8.3f}  x{c:<7d} {k[:90]}")
    print("top host ops (self ms/frame):")
    for k, c, ms in summary["top_host_ops"]:
        print(f"  {ms:8.3f}  x{c:<7d} {k[:90]}")
    print("top kernels (ms/frame):")
    for k, c, ms in summary["top_kernels"]:
        print(f"  {ms:8.3f}  x{c:<7d} {k[:90]}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()

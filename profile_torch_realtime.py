"""Where the time of the port's realtime RGB-D path goes, on one NVIDIA GPU.

Run from the repository root:

    python3 profile_torch_realtime.py [--json PATH]

Renders bench.py's dynamic orbit with the port's renderer and runs
``RealtimeSlam`` at full width (``SystemConfig()``, ``RTLimits()``):
``WARM`` frames first, then ``TIMED`` frames timed with the host clock
(fps, host synchronisations per frame), then what the recorder costs:
``COST_ROUNDS`` rounds of two blocks of ``COST_FRAMES`` frames, one with
the port's recorder off and one with it on (the order alternating), each
timed to the card's drain, then ``TRACED`` frames under
``torch.profiler`` with the port's recorder on (``utils.metrics``), which
give per frame: the device's kernel time and busy share, the kernel count,
and the host and device time of each stage of ``rt_step`` (extraction,
dynamic front-end, tracking, keyframe + BA) and of every span the port
records, the reads to the host per site, plus the operators that take the
most device and host time. A stage's device time is that of the operations
launched inside its spans (``benchmark/slambench/trace.py``). The summary
is printed, and written as JSON to ``--json`` when given. There is no CPU
fallback: without CUDA the script exits with code 2.
"""
import argparse
import json
import os
import sys
import time

from chip_smoke import card, count_host_syncs, track_frames

# The printed stages and the port's spans they read.
STAGES = {"rt.extract": "step/frontend", "rt.dynamic": "step/dynamic_frontend",
          "rt.track": "step/tracking", "rt.keyframe_ba": "step/keyframe_ba"}
WARM, TIMED, TRACED = 30, 60, 20
COST_ROUNDS, COST_FRAMES = 4, 15
T0 = time.monotonic()


def _progress(what):
    print(f"[{time.monotonic() - T0:8.1f} s] {what}", file=sys.stderr,
          flush=True)


def span_table(prof, rec, lo_ns, hi_ns):
    """Per path of the recorder's spans ``rec["spans"]`` in [lo, hi]: calls,
    host ms, and the device ms and kernels launched inside (from the
    profiler's events, on the same clock)."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "benchmark"))
    from slambench import trace
    iv = {}
    for s in rec["spans"]:
        iv.setdefault(s["path"], []).append((s["t0"], s["t1"]))
    red = trace.reduce(prof.profiler.kineto_results.events(), iv, lo_ns,
                       hi_ns)
    return {k: {"calls": v["calls"], "host_ms": v["host_ns"] / 1e6,
                "device_ms": v["device_ns"] / 1e6, "kernels": v["kernels"]}
            for k, v in red["spans"].items()}


def read_sites(rec):
    """{site: reads} of the recorder's ``read:<site>`` spans."""
    out = {}
    for s in rec["spans"]:
        if s["reads"]:
            site = s["name"][len("read:"):]
            out[site] = out.get(site, 0) + s["reads"]
    return out


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
    from coebslam_tpu_torch.slam import realtime
    from coebslam_tpu_torch.utils import metrics, synthetic

    card_line = card()
    cfg = SystemConfig()
    frames = synthetic.dynamic_orbit(cfg.camera, 150)[:3]
    rt = realtime.RealtimeSlam(cfg, realtime.RTLimits())

    track_frames(rt, frames, 0, WARM)
    with count_host_syncs(torch) as sites:
        t0 = time.perf_counter()
        track_frames(rt, frames, WARM, WARM + TIMED)
        timed_s = time.perf_counter() - t0

    cost = {"off": [], "on": []}
    at = WARM + TIMED
    for r in range(COST_ROUNDS):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            metrics.tracing(on)
            t0 = time.perf_counter()
            track_frames(rt, frames, at, at + COST_FRAMES)
            cost["on" if on else "off"].append(
                (time.perf_counter() - t0) / COST_FRAMES * 1e3)
            at += COST_FRAMES
    metrics.tracing(False)
    metrics.drain()
    _progress(f"recorder cost blocks done at frame {at}")

    kf0 = int(rt.state.n_kf)
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    metrics.tracing(True)
    with torch.profiler.profile(activities=act) as prof:
        lo_ns = time.time_ns()
        t0 = time.perf_counter()
        track_frames(rt, frames, at, at + TRACED)
        traced_s = time.perf_counter() - t0
        hi_ns = time.time_ns()
    metrics.tracing(False)
    _progress("traced frames done")
    rec = metrics.drain()
    spans = span_table(prof, rec, lo_ns, hi_ns)
    _progress("spans reduced")
    n_kf = int(rt.state.n_kf) - kf0
    nt = TRACED
    # Device-side events are kernels, copies and fills.
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    avg = prof.key_averages()
    _progress("profiler events averaged")
    ops = [e for e in avg if e.device_type == cpu]
    top_dev = sorted(ops, key=lambda e: e.self_device_time_total,
                     reverse=True)[:12]
    top_cpu = sorted(ops, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:12]
    top_kernels = sorted(
        (e for e in avg if e.device_type == cuda),
        key=lambda e: e.self_device_time_total, reverse=True)[:8]

    summary = {
        "card": card_line, "frames_timed": TIMED,
        "fps": TIMED / timed_s,
        "ms_per_frame": timed_s / TIMED * 1e3,
        "host_syncs_per_frame": sum(sites.values()) / TIMED,
        "recorder_cost_ms_per_frame": cost,
        "sync_sites": sites,
        "frames_traced": nt, "keyframes_traced": n_kf,
        "traced_ms_per_frame": traced_s / nt * 1e3,
        "device_ms_per_frame": dev_ms / nt,
        "device_busy_share": dev_ms / (traced_s * 1e3),
        "kernels_per_frame": len(kernels) / nt,
        "stages": {k: {"calls": spans[p]["calls"],
                       "host_ms_per_frame": spans[p]["host_ms"] / nt,
                       "device_ms_per_frame": spans[p]["device_ms"] / nt}
                   for k, p in STAGES.items() if p in spans},
        "spans_per_frame": {k: {f: v / nt for f, v in s.items()}
                            for k, s in spans.items()},
        "reads_per_frame": {k: v / nt for k, v in read_sites(rec).items()},
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
    print(f"recorder off / on, ms a frame in blocks of {COST_FRAMES}: "
          f"{[round(x, 2) for x in cost['off']]} / "
          f"{[round(x, 2) for x in cost['on']]}")
    print(f"traced {nt} frames ({n_kf} keyframes): "
          f"{summary['traced_ms_per_frame']:.1f} ms/frame wall, device "
          f"{summary['device_ms_per_frame']:.2f} ms/frame (busy share "
          f"{summary['device_busy_share']:.4f}), "
          f"{summary['kernels_per_frame']:.0f} kernels/frame")
    for k, v in summary["stages"].items():
        print(f"  {k:16s} calls {v['calls']:3d}  host "
              f"{v['host_ms_per_frame']:8.2f} ms/frame  device "
              f"{v['device_ms_per_frame']:7.3f} ms/frame")
    print("the port's spans per frame: calls, host ms, device ms, kernels")
    for k, v in sorted(summary["spans_per_frame"].items(),
                       key=lambda x: -x[1]["host_ms"]):
        print(f"  {v['calls']:6.2f} {v['host_ms']:9.3f} {v['device_ms']:8.3f}"
              f" {v['kernels']:8.1f}  {k}")
    print(f"reads to the host per frame: {summary['reads_per_frame']}")
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

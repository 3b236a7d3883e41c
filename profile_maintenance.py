"""Where the time of the port's maintenance dispatches goes, on one NVIDIA
GPU.

Run from the repository root:

    python3 profile_maintenance.py [--json PATH]

1. First calls: in a fresh process, the first and the second call of each
   library operation a loop closure reaches that the tracking path does
   not (3x3 SVDs, the pose graph's forward-mode Jacobians and dense solve,
   the stable sort of the bank insertion, one whole pose graph at the
   orbit's size), each with the card drained before and after.
2. The loop circuit of ``chip_smoke.py`` phase 6 (maintenance every frame),
   its dispatches timed as ``chip_smoke.time_dispatches`` times them (host
   ms and device span, the card not drained); the state before the first
   dispatch that applies a closure is kept.
3. That dispatch replayed warm ``REPLAYS`` times (wall ms), then once under
   ``torch.profiler`` with the port's recorder on (``utils.metrics``): the
   host and device ms of its stages (the spans of the vocabulary descent,
   RANSAC alignment, pose graph and junction BA), the kernel count, the
   device's busy share and the top host ops.

The summary is printed, and written as JSON to ``--json`` when given.
Without CUDA the script exits with code 2.
"""
import argparse
import json
import os
import sys
import time

from chip_smoke import (CIRCUIT_LIMITS, card, circuit_config,
                        dispatch_line, dispatch_summary, loop_scene,
                        time_dispatches)
from profile_torch_realtime import span_table

# The printed stages and the names of the port's spans they sum.
STAGES = {"maint.descend": "descend", "maint.ransac": "ransac_alignment",
          "maint.pose_graph": "pose_graph", "maint.junction_ba": "local_ba"}
REPLAYS = 3


def _ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def first_calls(torch):
    """{name: (first ms, second ms)} of the closure path's library calls."""
    from coebslam_tpu_torch.config import OptimizerConfig
    from coebslam_tpu_torch.geometry import so3
    from coebslam_tpu_torch.optim import pose_graph as pg
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    K = 64
    R = so3.exp(0.1 * torch.randn(K, 3, device=dev, generator=g))
    t = torch.randn(K, 3, device=dev, generator=g)
    e = torch.arange(K - 1, device=dev)
    prob = pg.PoseGraphProblem(
        s=torch.ones(K, device=dev), R=R, t=t,
        fixed=torch.arange(K, device=dev) == 0,
        valid=torch.ones(K, dtype=torch.bool, device=dev),
        edge_i=e + 1, edge_j=e, edge_s=torch.ones(K - 1, device=dev),
        edge_R=R[1:] @ R[:-1].transpose(1, 2), edge_t=t[1:] - t[:-1],
        edge_valid=torch.ones(K - 1, dtype=torch.bool, device=dev),
        edge_weight=torch.ones(K - 1, device=dev))
    A = torch.randn(448, 448, device=dev, generator=g)
    A = A @ A.T + torch.eye(448, device=dev)
    calls = {
        "svd gesvd [256, 3, 3]": lambda: torch.linalg.svd(
            torch.randn(256, 3, 3, device=dev, generator=g), driver="gesvd"),
        "svd gesvd [3, 3]": lambda: torch.linalg.svd(
            torch.randn(3, 3, device=dev, generator=g), driver="gesvd"),
        "solve_ex [448, 448]": lambda: torch.linalg.solve_ex(
            A, torch.ones(448, device=dev)),
        "sort stable [2048]": lambda: torch.sort(
            torch.rand(2048, device=dev, generator=g), descending=True,
            stable=True),
        "pose-graph Jacobians, 64 edges": lambda: pg._edge_jacobians(
            prob.s[1:], R[1:], t[1:], prob.s[:-1], R[:-1], t[:-1],
            prob.edge_s, prob.edge_R, prob.edge_t),
        "pose graph, 64 nodes, 20 iterations": lambda: pg.optimize_pose_graph(
            prob, OptimizerConfig(), fix_scale=True),
    }
    return {k: (_ms(torch, f), _ms(torch, f)) for k, f in calls.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the summary to this file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_maintenance: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from coebslam_tpu_torch import config
    from coebslam_tpu_torch.slam import realtime, vocabulary
    from coebslam_tpu_torch.utils import metrics, synthetic

    card_line = card()
    firsts = first_calls(torch)

    cfg = circuit_config(config)
    lim = realtime.RTLimits(**CIRCUIT_LIMITS)
    voc = vocabulary.load(os.path.join(root, "artifacts", "vocab_1e5.npz"))
    n = synthetic.N_CIRCUIT + synthetic.N_OVERLAP
    frames, _ = loop_scene(torch.device("cuda"), range(n),
                           synthetic.DEPTH_BIAS, synthetic, cfg.camera)
    rt = realtime.RealtimeSlam(cfg, lim, vocabulary=voc, maintain_every=1)
    step = rt.maint.step
    kept = []

    def keep(args, out):
        if not kept and int(out[1].n_loops) > int(args[1].n_loops):
            kept.append((*args, len(rec) - 1))

    rec = time_dispatches(torch, rt, keep)
    for i, (g, d) in enumerate(frames):
        rt.track(g, d, stamp=i / 30.0)
    rt.block()
    res = rt.finish()
    disp = [r[0] for r in rec]

    summary = {"card": card_line, "first_calls_ms": firsts,
               "dispatch_host_ms": [round(x, 3) for x in disp],
               "dispatches": dispatch_summary(rec),
               "loop_events": res["loop_events"]}
    if kept:
        st, ms, seed, kw, at = kept[0]
        replays = [_ms(torch, lambda: step(st, ms, seed, **kw))
                   for _ in range(REPLAYS)]
        act = [torch.profiler.ProfilerActivity.CPU,
               torch.profiler.ProfilerActivity.CUDA]
        metrics.tracing(True)
        with torch.profiler.profile(activities=act) as prof:
            lo_ns = time.time_ns()
            traced_ms = _ms(torch, lambda: step(st, ms, seed, **kw))
            hi_ns = time.time_ns()
        metrics.tracing(False)
        spans = span_table(prof, metrics.drain(), lo_ns, hi_ns)
        stage = {}
        for k, name in STAGES.items():
            for path, v in spans.items():
                if path.rsplit("/", 1)[-1] == name:
                    a = stage.setdefault(k, dict.fromkeys(v, 0))
                    for f in v:
                        a[f] += v[f]
        cpu = torch.autograd.DeviceType.CPU
        cuda = torch.autograd.DeviceType.CUDA
        kernels = [e for e in prof.events() if e.device_type == cuda]
        dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        ops = [e for e in prof.key_averages() if e.device_type == cpu]
        top_cpu = sorted(ops, key=lambda e: e.self_cpu_time_total,
                         reverse=True)[:12]
        summary.update({
            "closure_dispatch_index": at,
            "closure_dispatch_ms_in_session": disp[at],
            "closure_replay_ms": replays,
            "traced_ms": traced_ms, "device_ms": dev_ms,
            "device_busy_share": dev_ms / traced_ms,
            "kernels": len(kernels),
            "stages": {k: {"calls": v["calls"], "host_ms": v["host_ms"],
                           "device_ms": v["device_ms"]}
                       for k, v in stage.items()},
            "spans": spans,
            "top_host_ops": [(e.key, e.count, e.self_cpu_time_total / 1e3)
                             for e in top_cpu]})

    print(card_line)
    for k, (a, b) in firsts.items():
        print(f"first call {k}: {a:.2f} ms, second {b:.2f} ms")
    print(f"{len(rec)} dispatches: {dispatch_line(summary['dispatches'])}; "
          f"events {res['loop_events']}")
    if kept:
        print(f"first applied closure: dispatch {summary['closure_dispatch_index']}"
              f" took {summary['closure_dispatch_ms_in_session']:.1f} ms of host "
              f"time in the session; replayed warm {replays} ms; traced "
              f"{traced_ms:.1f} ms, device {dev_ms:.2f} ms (busy share "
              f"{summary['device_busy_share']:.4f}), {len(kernels)} kernels")
        for k, v in summary["stages"].items():
            print(f"  {k:18s} calls {v['calls']:3d}  host {v['host_ms']:9.2f}"
                  f" ms  device {v['device_ms']:8.3f} ms")
        print("top host ops (self ms):")
        for k, c, m in summary["top_host_ops"]:
            print(f"  {m:9.2f}  x{c:<7d} {k[:90]}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()

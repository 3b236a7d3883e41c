"""Pose Gauss-Newton replayed as one CUDA graph a solve, against the eager
schedule, in one process alone on one NVIDIA GPU.

Run from the repository root:

    python3 profile_pose_gn.py [--n 2048] [--replays 200] [--json PATH]

On a frame-sized solve (``--n`` observations: half stereo, a fifth gross
outliers, a tenth invalid) it prints:

1. the card's name and power limit;
2. the eager schedule (``pose_gn._solve``): host ms a solve (the enqueue,
   with the card drained before), the device ms between CUDA events around
   it, and under ``torch.profiler`` its kernels and their summed time;
3. the first call of ``optimize_pose``, which captures: its host seconds,
   the device memory allocated before and after it and its peak against
   the eager solve's, and the graph pool's reserved and active bytes
   (``torch.cuda.memory_snapshot``'s segments of ``pose_gn``'s pool);
4. the replay: host ms of one call of ``optimize_pose`` (copies in,
   replay, clones out) and of one ``graph.replay()`` with the card drained
   before (medians of 20), host ms a call over ``--replays`` calls in a
   row (there the card sets the pace), the device ms of one
   ``graph.replay()`` between CUDA events (median, card drained before),
   its nodes as the profiler records them (kernels, copies, sets) and
   their summed time, and the device time per node (wall over nodes);
5. whether the replay equals the eager run bit for bit.

``--json`` also writes the readings. Without CUDA the script exits with
code 2.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time


def card_line():
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return q.stdout.strip() or q.stderr.strip()


def problem(torch, se3, camera, cam, n, dev, seed=0):
    """(R0, t0, points_w, obs, inv_sigma2, valid) on ``dev``."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(n, 3, generator=g)
    pts_cam = torch.stack([u[:, 0] * 3.0 - 1.5, u[:, 1] * 2.0 - 1.0,
                           u[:, 2] * 3.5 + 1.5], -1)
    pose_gt = se3.exp(torch.tensor([0.03, -0.05, 0.02, 0.1, -0.05, 0.15]))
    pts_w = se3.transform_points(pose_gt.inverse(), pts_cam)
    obs = camera.project_stereo(cam, pts_cam) + 0.3 * torch.randn(
        n, 3, generator=g)
    obs[:, 2] = torch.where(torch.arange(n) < n // 2, obs[:, 2], -1.0)
    obs[torch.rand(n, generator=g) < 0.2, :2] += 30.0
    inv_sigma2 = 1.2 ** (-2.0 * torch.randint(0, 8, (n,), generator=g).float())
    valid = torch.rand(n, generator=g) > 0.1
    pose0 = se3.retract(pose_gt, 0.05 * torch.randn(6, generator=g))
    return [x.to(dev) for x in (pose0.R, pose0.t, pts_w, obs, inv_sigma2,
                                valid)]


def profiled(torch, fn):
    """(device operations, their summed ms, the ms from the first one's
    start to the last one's end) of one ``fn()``, read from the trace as
    ``benchmark/slambench/trace.py`` reads it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [(e.start_ns(), e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() != DeviceType.CPU
           and not e.is_user_annotation()]
    if not dev:
        return 0, 0.0, 0.0
    span = max(s + d for s, d in dev) - min(s for s, _ in dev)
    return len(dev), sum(d for _, d in dev) / 1e6, span / 1e6


def event_ms(torch, fn, runs):
    """Median device ms between CUDA events around ``fn()``, the card
    drained before each run."""
    out = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def host_one(torch, fn, runs=20):
    """Median host ms of one ``fn()``, the card drained before each."""
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(out)


def bit_equal(torch, a, b):
    pairs = [(a.pose.R, b.pose.R), (a.pose.t, b.pose.t),
             (a.inliers, b.inliers), (a.n_inliers, b.n_inliers),
             (a.chi2, b.chi2)]
    for x, y in pairs:
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            return False
    return True


def pool_bytes(torch, pool):
    """(reserved, active) bytes of the segments of the memory pool
    ``pool``."""
    seg = [s for s in torch.cuda.memory_snapshot()
           if tuple(s.get("segment_pool_id", ())) == tuple(pool)]
    return (sum(s["total_size"] for s in seg),
            sum(s["active_size"] for s in seg))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--replays", type=int, default=200)
    ap.add_argument("--json", help="also write the readings to this file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_pose_gn: CUDA is not available", file=sys.stderr)
        return 2
    from coebslam_tpu_torch.config import CameraConfig, OptimizerConfig
    from coebslam_tpu_torch.geometry import camera, se3
    from coebslam_tpu_torch.geometry.se3 import SE3
    from coebslam_tpu_torch.optim import pose_gn
    cam, opt = CameraConfig(), OptimizerConfig()
    dev = torch.device("cuda")
    inputs = problem(torch, se3, camera, cam, args.n, dev)
    R, t, *rest = inputs
    out = {"card": card_line(), "torch": torch.__version__,
           "cuda": torch.version.cuda, "n": args.n}
    print(f"card {out['card']}; torch {out['torch']}, CUDA {out['cuda']}")

    def eager():
        return pose_gn._solve(*inputs, cam, opt)

    def call():
        return pose_gn.optimize_pose(SE3(R, t), *rest, cam, opt)

    # -- eager
    eager()                                   # handles and first calls
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    n_k, k_ms, span = profiled(torch, eager)
    out["eager"] = {"host_ms": statistics.median(host),
                    "event_ms": event_ms(torch, eager, 5), "kernels": n_k,
                    "kernel_ms": k_ms, "span_ms": span}
    print(f"eager: host {out['eager']['host_ms']:.3f} ms a solve, events "
          f"{out['eager']['event_ms']:.3f} ms, {n_k} kernels summing "
          f"{k_ms:.3f} ms over a span of {span:.3f} ms")

    # -- memory of an eager solve, then of the capture
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eager()
    torch.cuda.synchronize()
    peak_eager = torch.cuda.max_memory_allocated() - base
    reserved0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = call()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    peak_capture = torch.cuda.max_memory_allocated() - base
    del first
    after = torch.cuda.memory_allocated() - base
    reserved, active = pool_bytes(torch, pose_gn._pool)
    out["capture"] = {
        "host_s": capture_s, "warmup_runs": pose_gn.WARMUP_RUNS,
        "allocated_after_bytes": after, "peak_bytes": peak_capture,
        "eager_peak_bytes": peak_eager, "pool_reserved_bytes": reserved,
        "pool_active_bytes": active,
        "reserved_delta_bytes": torch.cuda.memory_reserved() - reserved0}
    print(f"capture: {capture_s:.3f} s (with {pose_gn.WARMUP_RUNS} eager "
          f"warm-up runs); allocated after +{after / 2**20:.3f} MiB; peak "
          f"+{peak_capture / 2**20:.3f} MiB (an eager solve's "
          f"+{peak_eager / 2**20:.3f}); pool reserved "
          f"{reserved / 2**20:.3f} MiB, active {active / 2**20:.3f} MiB")

    # -- replay
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.replays):
        call()
    host_ms = (time.perf_counter() - t0) * 1e3 / args.replays
    torch.cuda.synchronize()
    graph = next(g for k, g in pose_gn._graphs.items()
                 if k[1][2][0] == args.n).graph
    one_call, one_replay = host_one(torch, call), host_one(torch, graph.replay)
    wall = event_ms(torch, graph.replay, 50)
    call_ms = event_ms(torch, call, 50)
    n_nodes, node_ms, span = profiled(torch, graph.replay)
    n_call, call_k_ms, _ = profiled(torch, call)
    same = bit_equal(torch, call(), eager())
    out["replay"] = {"host_ms_one_call": one_call,
                     "host_ms_one_replay": one_replay,
                     "host_ms_in_a_row": host_ms, "graph_event_ms": wall,
                     "call_event_ms": call_ms, "nodes": n_nodes,
                     "node_kernel_ms": node_ms, "span_ms": span,
                     "ms_per_node": wall / max(n_nodes, 1),
                     "call_device_ops": n_call,
                     "call_kernel_ms": call_k_ms, "bit_equal": same}
    print(f"replay: host {one_call:.4f} ms a call, {one_replay:.4f} ms a "
          f"graph.replay(), the card drained before; {host_ms:.4f} ms a "
          f"call over {args.replays} calls in a row;"
          f" graph {wall:.3f} ms between events ({call_ms:.3f} ms for the "
          f"call with its copies); {n_nodes} nodes summing {node_ms:.3f} ms "
          f"over a span of {span:.3f} ms; {1e3 * wall / max(n_nodes, 1):.3f}"
          f" us a node; the call {n_call} device ops; bit-equal to eager: "
          f"{same}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())

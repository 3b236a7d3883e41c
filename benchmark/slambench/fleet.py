"""The fleet: a cell's sessions, each in its own process, fed closed-loop
in one window, and the run's result from what they send back."""
from __future__ import annotations

import math
import multiprocessing as mp
import sys
import time
from multiprocessing.connection import wait

import numpy as np

from . import counts, spec, stats
from .session import entry, forbidden_modules

READY_TIMEOUT_S = 900.0
DONE_SLACK_S = 300.0


class Run:
    """What the metric readers read: the fleet's window, frames and
    times, and, in a traced run, the sessions' spans and device time."""

    def __init__(self, cell, results, t0, setup_s, least_s, fast_bound_s):
        self.cell = cell
        self.config = cell["config"]
        self.sessions = len(results)
        self.setup_s = setup_s
        self.window_s = max(r["h_end"] for r in results) - t0
        self.frame_ms = [1e3 * (d - h) for r in results
                         for h, d in zip(r["hand"], r["done"])]
        self.host_ms = [1e3 * (b - h) for r in results
                        for h, b in zip(r["hand"], r["back"])]
        self.frames = len(self.frame_ms)
        self.attempted = sum(r["attempted"] for r in results)
        self.peak_bytes = max(r["peak_bytes"] for r in results)
        self.chip_used_bytes = max(r["chip_used_bytes"] for r in results)
        self.maint_host_ms = [x for r in results for x in r["maint_host_ms"]]
        self.syncs = sum(r["syncs"] for r in results)
        self.least_s = least_s
        self.fast_bound_s = fast_bound_s
        self.traced = all("trace" in r for r in results)
        self.spans = {}
        self.by_name = {}
        self.kernels = 0
        self.busy_s = 0.0
        self.gaps = []
        if self.traced:
            self._reduce_traces(results, t0)
        # A number of the device is read only where a device operation ran.
        self.on_device = self.busy_s > 0

    def _reduce_traces(self, results, t0):
        lo, hi = t0 * 1e9, (t0 + self.window_s) * 1e9
        busy = stats.union(np.concatenate(
            [r["trace"]["busy"] for r in results]))
        busy = stats.clip(busy, lo, hi)
        self.busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e9
        for r in results:
            tr = r["trace"]
            self.kernels += tr["kernels"]
            for n, (c, s) in tr["by_name"].items():
                c0, s0 = self.by_name.get(n, (0, 0.0))
                self.by_name[n] = (c0 + c, s0 + s)
            for lab, s in tr["spans"].items():
                a = self.spans.setdefault(lab, {"calls": 0, "host_ms": 0.0,
                                                "device_ms": 0.0,
                                                "kernels": 0})
                a["calls"] += s["calls"]
                a["host_ms"] += s["host_ns"] / 1e6
                a["device_ms"] += s["device_ns"] / 1e6
                a["kernels"] += s["kernels"]
        # Idle stretches of the card, named by the span most sessions were
        # in at their middle.
        g = stats.gaps(busy, lo, hi)
        mid = 0.5 * (g[:, 0] + g[:, 1])
        labels = sorted({lab for r in results for lab in r["trace"]["spans"]})
        votes = np.zeros((len(labels) + 1, len(mid)))
        votes[-1] = 0.5                       # "outside spans" below one vote
        for r in results:
            for j, lab in enumerate(labels):
                iv = r["trace"]["spans"].get(lab, {}).get("intervals")
                if iv is None or not len(iv):
                    continue
                k = np.searchsorted(iv[:, 0], mid, side="right") - 1
                votes[j] += (k >= 0) & (mid < iv[np.clip(k, 0, None), 1])
        names = [f"host:{lab}" for lab in labels] + ["host:outside spans"]
        who = votes.argmax(0)
        idle = {}
        for j, n in enumerate(names):
            sec = float((g[who == j, 1] - g[who == j, 0]).sum()) / 1e9
            if sec > 0:
                idle[n] = sec
        self.gaps = sorted(idle.items(), key=lambda x: -x[1])[:10]


def _fast_bound(cfg):
    cam, orb = cfg["camera"], cfg["orb"]
    return counts.fast_seconds(cam["height"], cam["width"], orb["n_levels"],
                               orb["scale_factor"])


def run(cell, seed, seconds, trace, t_start, opts=None, log=None):
    """Run the cell once. Returns (result dict or None, exit code)."""
    opts = dict(opts or {})
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    device = opts.get("device", "cuda")
    n = int(cell["traffic"]["sessions"])
    if device == "cuda":
        # Build the FAST kernel once, before the sessions start.
        from coebslam_tpu_torch.ops import fast_cuda
        fast_cuda.build()
    ctx = mp.get_context("spawn")
    procs, conns = [], []
    for i in range(n):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=entry, args=(i, cell, seed, seconds, trace,
                                            child, opts), daemon=True)
        p.start()
        child.close()
        procs.append(p)
        conns.append(parent)
    try:
        return _drive(cell, seconds, trace, t_start, log, procs, conns,
                      device)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()


def _drive(cell, seconds, trace, t_start, log, procs, conns, device):
    ready = {}
    deadline = time.monotonic() + READY_TIMEOUT_S
    pending = dict(enumerate(conns))
    while pending:
        left = deadline - time.monotonic()
        if left <= 0:
            log(f"FAILED: sessions {sorted(pending)} not ready in "
                f"{READY_TIMEOUT_S:.0f} s")
            return None, 1
        for c in wait(list(pending.values()), timeout=left):
            i = next(k for k, v in pending.items() if v is c)
            try:
                msg, body = c.recv()
            except EOFError:
                msg, body = "error", f"session {i} exited before it was ready"
            if msg != "ready":
                log(f"FAILED: session {i} during set-up:\n{body}")
                for cc in conns:
                    if cc is not c:
                        try:
                            cc.send(("stop", 0.0))
                        except OSError:
                            pass
                return None, 1
            ready[i] = body
            del pending[i]
    t0 = time.monotonic() + 0.25
    for c in conns:
        c.send(("go", t0))
    setup_s = t0 - t_start
    results, failed = {}, {}
    pending = dict(enumerate(conns))
    deadline = t0 + seconds + DONE_SLACK_S
    while pending:
        left = deadline - time.monotonic()
        if left <= 0:
            for i in pending:
                failed[i] = "no result in time"
            break
        for c in wait(list(pending.values()), timeout=left):
            i = next(k for k, v in pending.items() if v is c)
            try:
                msg, body = c.recv()
            except EOFError:
                msg, body = "error", "exited without a result"
            if msg == "done":
                results[i] = body
            else:
                failed[i] = body
            del pending[i]
    for i, why in sorted(failed.items()):
        log(f"FAILED: session {i}: {why}")
    return _result(cell, trace, t0, setup_s, ready, results, failed, device,
                   log)


def _result(cell, trace, t0, setup_s, ready, results, failed, device, log):
    cfg = cell["config"]
    res = [results[i] for i in sorted(results)]
    if not res:
        return None, 1
    least = counts.frame_least_seconds(
        cfg, int(cell["traffic"].get("detect_every", 1)))
    run = Run(cell, res, t0, setup_s, least, _fast_bound(cfg))
    warm = int(cell["traffic"]["warmup_frames"])
    for r in res:
        i = r["index"]
        k = len(r["done"])
        mono_note = ""
        if "init_step" in r:
            mono_note = (f" (similarity, scale {r['ate_scale']:.5f}), map "
                         f"built at step {r['init_step']} of a warm-up of "
                         f"{warm}")
        log(f"session {i}: {k} frames in the window "
            f"({k / max(run.window_s, 1e-9):.3f} fps), drained "
            f"{r['h_end'] - t0:.3f} s after the start, lost {r['lost']}, "
            f"ATE {r['ate_m'] * 100:.3f} cm{mono_note} over "
            f"{r['frames_seen']} distinct frames, keyframes {r['n_kf']}, peak "
            f"{r['peak_bytes'] / 2 ** 20:.1f} MiB, set-up "
            f"{ready[i]['setup_process_s']:.2f} s (render "
            f"{ready[i]['render_s']:.2f} s), trace {r['trace_s']:.2f} s, check "
            f"{r['check_s']:.2f} s, syncs {r['syncs']}, stages solved "
            f"{r['check'].get('stages_solved')}, unsolved "
            f"{r['check'].get('stages_unsolved')}, keyframes checked "
            f"{r['check'].get('keyframes_checked')} with "
            f"{r['check'].get('spawned_checked')} spawned points, spawn gap "
            f"{r['check'].get('spawn_gap_mm')} mm, mismatch "
            f"{r['check'].get('spawn_mismatch_pct')} %, BA pose gap "
            f"{r['check'].get('ba_pose_gap_mm')} mm")
    names = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in names:
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": ready[min(ready)]["device_name"], "count": 1,
           "memory_peak_bytes": run.chip_used_bytes}
    out = {"metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.busy_s
        dev["window_s"] = run.window_s
        ops = sorted(run.by_name.items(), key=lambda x: -x[1][1])[:10]
        out["breakdown"] = {
            "device_ops": [[nm[:120], s / 1e9] for nm, (_, s) in ops],
            "idle_gaps": [[k, v] for k, v in run.gaps]}
    # ---- correct: every session done, nothing of JAX loaded, every
    # number within its limit.
    lim = cell["limits"]
    checks = {}
    for key, limit in lim.items():
        if key == "ate_cm":
            vals = [r["ate_m"] * 100 for r in res]
        elif key == "missing_outputs":
            vals = [sum(r["check"]["missing_outputs"] for r in res)]
        else:
            vals = [r["check"][key] for r in res if key in r["check"]]
        if not vals:
            continue
        v = max(vals) if not any(math.isnan(x) for x in vals) else math.nan
        checks[key] = {"value": v, "limit": limit}
    bad_mod = sorted(set(forbidden_modules()).union(
        *[set(r["forbidden"]) for r in res]))
    unchecked = [r["index"] for r in res if r["check"]["frames_checked"] == 0]
    missing = _not_covered(lim, [r["check"] for r in res])
    correct = (not failed and not bad_mod and not unchecked
               and not missing
               and all(c["value"] <= c["limit"] for c in checks.values()))
    # A session that failed after the start counts its share of the
    # window's frames as attempted and failed.
    per = run.attempted / len(res)
    n_failed = sum(r["lost"] for r in res) + sum(
        r["attempted"] - len(r["done"]) for r in res) + round(
        per * len(failed))
    result = {"correct": bool(correct),
              "attempted": run.attempted + round(per * len(failed)),
              "failed": int(n_failed), **out, "checks": checks}
    if bad_mod:
        log(f"FAILED: modules of JAX or the JAX package loaded: {bad_mod}")
        return None, 5
    if unchecked:
        log(f"sessions with no frame checked: {unchecked}")
    for why in missing:
        log(why)
    return result, (0 if not failed else 1)


def _not_covered(lim, session_checks):
    """What the run left unchecked that a compared number needs, one line
    each; empty when all is there. A keyframe number needs a keyframe
    checked, and ``pose_gap_mm`` a sampled stage that was solved: without
    them those numbers read 0 by default."""
    def total(key):
        return sum(c.get(key, 0) for c in session_checks)
    why = []
    if {"spawn_gap_mm", "spawn_mismatch_pct", "ba_pose_gap_mm"} & set(lim) \
            and not total("keyframes_checked"):
        why.append("no keyframe of the window was checked")
    if "pose_gap_mm" in lim and not total("stages_solved"):
        why.append("no sampled stage of the window was solved")
    return why

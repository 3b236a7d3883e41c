"""bench.py's three dataset rows, run through the port's realtime entry.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 replica_rows.py [--out PATH]

It runs four rows at the lengths of ``FULL``. Every row is a
``RealtimeSlam(...).track`` session then ``finish()``, on the frames of
``utils/replica.generate`` in the wire's dtypes (grey uint8, depth
uint16) with the walker boxes as the text prints them, and the committed
``artifacts/vocab_1e5.npz``:

- ``closure`` (bench.py ``run_realtime_closure``): ``generate(n_frames=300,
  seed=0, closure=True)``, depth x CLOSURE_DEPTH_BIAS,
  ``RealtimeSlam(SystemConfig(), vocabulary=, maintain_every=4)``;
  ``twin`` is its odometry twin without a vocabulary. Gates
  (tests/test_replica_closure.py at this length): >= 295 frames tracked,
  >= 1 loop closed, ATE < 6 cm and below the twin's.
- ``maint`` (bench.py ``run_realtime_replica``): ``generate(n_frames=400,
  seed=0)``, the vocabulary, ``maintain_every=8``, then
  ``handoff.refine`` and ``refined_trajectory``. Gates: >= 395 tracked,
  raw ATE < 8 cm, refined ATE below raw.
- ``walkers`` (tests/test_tum_replica.py::TestReplicaTwoWalkers):
  ``generate(n_frames=200, seed=1, walkers=2)``,
  ``RealtimeSlam(SystemConfig())``. Gates: >= 195 tracked, ATE < 7 cm.

Each row runs in a process of its own (``--session``), all at once, so
the seconds and dispatch times carry their contention. Each line prints
the row's numbers beside the JAX package's on the CPU
(``cpu_reference.py jax {closure-replica,replica-maint,two-walkers}``,
in brackets) and the FAST kernel's launches (one per frame). The last
line is one JSON object of every row; ``--out`` writes it to PATH too. A
failed gate, a session that fails, or a card that is missing makes the
script exit non-zero. ``cpu_reference.py port ...`` runs the same
sessions on the CPU through ``run_row``, at any length.
"""
import atexit
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
VOCAB = os.path.join(ROOT, "artifacts", "vocab_1e5.npz")
FULL = dict(closure=300, twin=300, maint=400, walkers=200)
CLOSURE_DEPTH_BIAS = 1.05        # bench.py CLOSURE_DEPTH_BIAS
CLOSURE_MAINTAIN_EVERY = 4
MAINT_SCHEDULE = dict(n_frames=400, seed=0)
MAINT_EVERY = 8
MIN_OK_SLACK = 5                 # frames a row may lose
CLOSURE_ATE_LIMIT_M = 0.06
MAINT_ATE_LIMIT_M = 0.08
WALKERS_ATE_LIMIT_M = 0.07
#: The JAX package's CPU values at the lengths of FULL (cpu_reference.py
#: jax closure-replica, replica-maint, two-walkers).
JAX_CPU = {
    "closure": dict(ok=300, ate_m=0.038228, n_kf=41, loops_closed=2,
                           loop_events=4, relocalizations=0),
    "twin": dict(ok=300, ate_m=0.046529, n_kf=39),
    "maint": dict(ok=400, ate_m=0.039598, n_kf=39, loops_closed=1,
                         loop_events=4, relocalizations=0,
                         refined_ate_m=0.032998, kf_refined=39),
    "walkers": dict(ok=200, ate_m=0.012898, n_kf=19,
                           boxes_per_frame={"0": 0, "1": 43, "2": 157}),
}


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        sys.exit(f"FAILED: nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_dispatches(torch, rt, keep=None):
    """Time each maintenance dispatch of ``rt`` without draining the card:
    host ms of the call, CUDA events recorded before and after it, the
    host's keyframe count, and the event, relocalization, bank closure and
    bank relocalization counters before and after, kept on the card.
    ``dispatch_summary`` reads them after the run. ``keep(args, out)``,
    when given, sees every dispatch."""
    rec = []
    step = rt.maint.step

    def timed(st, ms, seed, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        out = step(st, ms, seed, **kw)
        b.record()
        rec.append(((time.perf_counter() - t0) * 1e3, a, b, kw.get("n_kf"),
                    torch.stack([ms.n_events, ms.n_reloc, ms.n_bank_loops,
                                 ms.n_bank_reloc]),
                    torch.stack([out[1].n_events, out[1].n_reloc,
                                 out[1].n_bank_loops, out[1].n_bank_reloc])))
        if keep is not None:
            keep((st, ms, seed, kw), out)
        return out

    rt.maint.step = timed
    return rec


def dispatch_summary(rec):
    """Count, the keyframe count at the last dispatch, and for host ms and
    the device span (first to last event) each: the median of the
    dispatches with no loop event or relocalization, the max, and the
    values of those with one."""
    host = np.array([r[0] for r in rec])
    span = np.array([r[1].elapsed_time(r[2]) for r in rec])
    event = np.array([bool((r[4] != r[5]).any()) for r in rec])
    out = {"dispatches": len(rec),
           "n_kf_at_last": rec[-1][3] if rec else None}
    for name, ms in (("host", host), ("span", span)):
        quiet = ms[~event]
        out[name] = {
            "no_event_median_ms": float(np.median(quiet)) if quiet.size
            else float("nan"),
            "max_ms": float(ms.max()) if ms.size else float("nan"),
            "event_ms": [round(float(x), 2) for x in ms[event]]}
    return out


def dispatch_line(d):
    return "; ".join(
        f"{what}: no-event median {d[k]['no_event_median_ms']:.2f} ms, max "
        f"{d[k]['max_ms']:.2f} ms, with an event {d[k]['event_ms']} ms"
        for k, what in (("host", "host"), ("span", "device span")))


def schedule(row, n):
    """``replica.generate``'s keyword arguments of ``row`` at ``n`` frames."""
    if row in ("closure", "twin"):
        return dict(n_frames=n, seed=0, closure=True)
    if row == "maint":
        return dict(MAINT_SCHEDULE, frames=range(n))
    return dict(n_frames=n, seed=1, walkers=2)


def render(replica, row, n, device):
    """The row's frames (``ReplicaFrame``s, rendered on ``device``) and
    their ground-truth stamps and camera centres."""
    frames = list(replica.generate(**schedule(row, n), device=device))
    gt = np.asarray([[float(x) for x in f.gt_line.split()[1:4]]
                     for f in frames])
    return frames, np.asarray([f.stamp for f in frames]), gt


def track(rt, row, frames):
    """Feed ``frames`` to ``rt`` (the closure rows' depth x
    CLOSURE_DEPTH_BIAS), wait for the device, return the seconds."""
    t0 = time.perf_counter()
    for f in frames:
        d = f.depth
        if row in ("closure", "twin"):
            d = (d.astype(np.float32) * CLOSURE_DEPTH_BIAS).astype(d.dtype)
        rt.track(f.gray, d, stamp=f.stamp,
                 boxes=f.boxes if len(f.boxes) else None)
    rt.block()
    return time.perf_counter() - t0


def _ate(ate, res, stamps, gt, R=None, t=None):
    R = res["R"] if R is None else R
    t = res["t"] if t is None else t
    est = np.asarray([-r.T @ x for r, x in zip(R, t)])
    return float(ate.ate_rmse(res["stamps"], est, stamps, gt)["rmse"])


def summary(row, res, frames, stamps, gt, ate, seconds):
    """The row's numbers from its ``finish()`` result."""
    n = len(frames)
    out = {"row": row, "n": n, "ok": int(res["ok"].sum()),
           "ate_m": _ate(ate, res, stamps, gt), "n_kf": int(res["n_kf"]),
           "seconds": seconds, "fps": n / seconds}
    if "n_loops_closed" in res:
        out.update(loops_closed=int(res["n_loops_closed"]),
                   loop_events=int(res["n_loop_events"]),
                   relocalizations=int(res["n_relocalizations"]),
                   bank_entries=int(res["bank_entries"]),
                   events=res["loop_events"])
    if row == "walkers":
        per = np.bincount([len(f.boxes) for f in frames], minlength=3)
        out["boxes_per_frame"] = {str(k): int(c) for k, c in enumerate(per)}
    return out


def refine(res, stamps, gt, ate, handoff, SystemConfig, device):
    """``maint``'s offline refinement: handoff + global BA, the refined
    trajectory's ATE."""
    t0 = time.perf_counter()
    m, kf_ids, n_opt = handoff.refine(res, SystemConfig(), device=device)
    traj = handoff.refined_trajectory(res, m, kf_ids)
    return {"refined_ate_m": _ate(ate, res, stamps, gt,
                                  [P[:, :3] for P in traj],
                                  [P[:, 3] for P in traj]),
            "kf_refined": int(n_opt),
            "refine_s": time.perf_counter() - t0}


def run_row(row, n, device, on_session=None):
    """One row on ``device`` at ``n`` frames; its summary.
    ``on_session(rt)``, when given, sees the session before it tracks and
    returns None or a function whose result, called after the run, the
    summary gets as ``"dispatch"``."""
    from coebslam_tpu_torch.config import SystemConfig
    from coebslam_tpu_torch.eval import ate
    from coebslam_tpu_torch.slam import handoff, vocabulary
    from coebslam_tpu_torch.slam.realtime import RealtimeSlam
    from coebslam_tpu_torch.utils import replica
    t0 = time.perf_counter()
    frames, stamps, gt = render(replica, row, n, device)
    render_s = time.perf_counter() - t0
    rt = RealtimeSlam(SystemConfig(), device=device,
                      vocabulary=vocabulary.load(VOCAB)
                      if row in ("closure", "maint") else None,
                      maintain_every=CLOSURE_MAINTAIN_EVERY
                      if row == "closure" else MAINT_EVERY)
    after = on_session(rt) if on_session is not None else None
    seconds = track(rt, row, frames)
    res = rt.finish()
    out = summary(row, res, frames, stamps, gt, ate, seconds)
    out["render_s"] = render_s
    if after is not None:
        out["dispatch"] = after()
    if row == "maint":
        out.update(refine(res, stamps, gt, ate, handoff, SystemConfig,
                          device))
    return out


def failures(row, s, twin=None):
    """The row's failed gates (``twin``: the twin's summary, for
    ``closure``)."""
    bad = []
    if s["ok"] < s["n"] - MIN_OK_SLACK:
        bad.append(f"{s['ok']}/{s['n']} frames tracked")
    if row == "closure":
        if s["loops_closed"] < 1:
            bad.append(f"no loop closed ({s['loop_events']} events)")
        if not s["ate_m"] < CLOSURE_ATE_LIMIT_M:
            bad.append(f"ATE {s['ate_m']} m")
        if twin is not None and not s["ate_m"] < twin["ate_m"]:
            bad.append(f"ATE {s['ate_m']} m, the twin's {twin['ate_m']} m")
    elif row == "maint":
        if not s["ate_m"] < MAINT_ATE_LIMIT_M:
            bad.append(f"raw ATE {s['ate_m']} m")
        if not s["refined_ate_m"] < s["ate_m"]:
            bad.append(f"refined ATE {s['refined_ate_m']} m, raw "
                       f"{s['ate_m']} m")
    elif row == "walkers":
        if not s["ate_m"] < WALKERS_ATE_LIMIT_M:
            bad.append(f"ATE {s['ate_m']} m")
    return bad


def _jax(row, key, scale=1.0):
    """The JAX package's CPU value of ``key`` for the row, as printed."""
    v = JAX_CPU[row][key]
    return f"{v * scale:.3f}" if isinstance(v, float) else str(v)


def row_lines(rows, card_line, tag):
    """The printed lines of the four rows' summaries (``tag``: {row: the
    line's prefix, e.g. "[22a]"}) and their failed gates."""
    lines = []
    tw = rows["twin"]
    for row, s in rows.items():
        n = s["n"]
        j = lambda k, **kw: _jax(row, k, **kw)
        head = (f"{tag[row]} {row} replica, {n} frames (JAX package on CPU "
                f"in brackets): frames OK {s['ok']}/{n} ({j('ok')}), ATE "
                f"{s['ate_m'] * 100:.3f} cm ({j('ate_m', scale=100)})")
        if row == "closure":
            head += (f", the twin's {tw['ate_m'] * 100:.3f} cm "
                     f"({_jax('twin', 'ate_m', scale=100)})")
        if "loops_closed" in s:
            head += (f", loops closed {s['loops_closed']} of "
                     f"{s['loop_events']} events ({j('loops_closed')} of "
                     f"{j('loop_events')}), relocalizations "
                     f"{s['relocalizations']} ({j('relocalizations')})")
        if row == "maint":
            head += (f", refined ATE {s['refined_ate_m'] * 100:.3f} cm "
                     f"({j('refined_ate_m', scale=100)}), keyframes refined "
                     f"{s['kf_refined']} ({j('kf_refined')}) in "
                     f"{s['refine_s']:.1f} s")
        if row == "walkers":
            head += (f", frames by walker boxes seen {s['boxes_per_frame']} "
                     f"({j('boxes_per_frame')})")
        head += (f", keyframes {s['n_kf']} ({j('n_kf')}); {s['fps']:.2f} fps "
                 f"({s['seconds']:.1f} s), FAST launches "
                 f"{s['launches']} for {n} frames")
        d = s.get("dispatch")
        if d:
            head += (f"; maintenance dispatches {d['dispatches']}, "
                     f"{dispatch_line(d)}")
        lines.append(head + f"; on {card_line}")
    bad = {row: failures(row, s, tw if row == "closure" else None)
           for row, s in rows.items()}
    for row, s in rows.items():
        if s["launches"] != s["n"]:
            bad[row].append(f"{s['launches']} FAST launches for {s['n']} "
                            f"frames")
    return lines, {k: v for k, v in bad.items() if v}


def session_main(row, out_path, nice):
    """``--session ROW OUT NICE``: one row of FULL on the card at CPU priority
    ``nice`` with one intra-op thread (its CPU work is dispatch), its
    summary (with the FAST launches and the seconds from the process's
    start to the summary) written to OUT as JSON."""
    t0 = time.perf_counter()
    os.nice(nice)
    import torch
    from coebslam_tpu_torch.ops import fast_cuda
    torch.set_num_threads(1)

    def timed(rt):
        if rt.maint is None:
            return None
        rec = time_dispatches(torch, rt)
        return lambda: dispatch_summary(rec)

    fast_cuda.LAUNCHES = 0
    out = run_row(row, FULL[row], torch.device("cuda"), timed)
    out["launches"] = fast_cuda.LAUNCHES
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    out["process_s"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump(out, f)


def start(tmp, nice=0):
    """Start one ``--session`` process per row of FULL at CPU priority
    ``nice`` (chip_smoke.py gives its own phases the CPU
    first); return {row: (process, log file, output path)}. Whatever is
    still running when the interpreter exits is killed."""
    procs = {}
    atexit.register(stop, procs)
    for row in FULL:
        log = open(os.path.join(tmp, f"{row}.log"), "w")
        path = os.path.join(tmp, f"{row}.json")
        procs[row] = (subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--session", row,
             path, str(nice)], stdout=log, stderr=subprocess.STDOUT,
            cwd=ROOT),
            log, path)
    return procs


def stop(procs):
    """Kill ``start``'s processes that still run."""
    for proc, log, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def join(procs, timeout):
    """Wait for ``start``'s processes; {row: summary}, and the rows that
    failed with the end of their log. Kills what is left on the way out."""
    rows, failed = {}, {}
    deadline = time.monotonic() + timeout
    try:
        for row, (proc, log, path) in procs.items():
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            log.close()
            if rc != 0:
                with open(log.name) as f:
                    failed[row] = f"exit {rc}: {f.read()[-3000:]}"
                continue
            with open(path) as f:
                rows[row] = json.load(f)
    finally:
        stop(procs)
    return rows, failed


def main():
    import torch
    if not torch.cuda.is_available():
        print("replica_rows: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--session"]:
        row, path, nice = sys.argv[2:5]
        return session_main(row, path, int(nice))
    args = sys.argv[1:]
    if args and (len(args) != 2 or args[0] != "--out"):
        sys.exit(__doc__)
    out_path = args[1] if args else None
    from coebslam_tpu_torch.ops import fast_cuda
    card_line = card()
    print(card_line, flush=True)
    fast_cuda.build()            # once, before the sessions load it
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="replica_rows_") as tmp:
        rows, failed = join(start(tmp), 3000)
    for row, msg in failed.items():
        print(f"FAILED: {row} session {msg}", file=sys.stderr)
    if failed:
        sys.exit(1)
    lines, bad = row_lines(rows, card_line, {r: f"[{r}]" for r in FULL})
    for line in lines:
        print(line, flush=True)
    print(f"all rows at once in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"card": card_line, "rows": rows}), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"card": card_line, "rows": rows}, f)
    for row, why in bad.items():
        print(f"FAILED: {row}: {why}", file=sys.stderr)
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main()

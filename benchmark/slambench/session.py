"""One session of the fleet: one robot's SLAM session in a process of its
own, with one intra-op thread.

``entry`` is the process's target. It makes the session's frames and the
detector's weights from the seed, builds the port's ``RealtimeSlam``,
warms every path of the cell up, reports ready, waits for the start
signal, feeds its frames closed-loop until the window closes, drains, and
then, with the window closed, the peak memory read and the session's
state freed, checks a sample of the frames it processed against the plain
reference. It sends one dict back through its pipe.
"""
from __future__ import annotations

import importlib
import os
import sys
import time
import traceback
import warnings

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "coebslam_tpu")
PORT = "coebslam_tpu_torch"


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def entry(index, cell, seed, seconds, trace, conn, opts):
    """The session process: fd 1 goes to fd 2, so that only the fleet's
    process writes standard output."""
    os.dup2(2, 1)
    try:
        run(index, cell, seed, seconds, trace, conn, opts)
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise
    finally:
        conn.close()


class Sample:
    """The frames of the window whose outputs are kept for the check: a
    uniform sample of ``k`` of the window's steps, drawn from the seed as
    the steps come (reservoir sampling), so nothing is kept for the
    others."""

    def __init__(self, k, rng):
        self.k, self.rng = k, rng
        self.slots = {}
        self.cur = None

    def begin(self, step, frame):
        self.cur = None
        if step < self.k:
            slot = step
        else:
            j = int(self.rng.randint(0, step + 1))
            slot = j if j < self.k else None
        if slot is not None:
            self.cur = {"step": step, "frame": frame, "stages": []}
            self.slots[slot] = self.cur

    def records(self):
        return [self.slots[k] for k in sorted(self.slots)]


class KeyframeCapture:
    """The sampled keyframes of the window as the timed path handed them
    to the windowed BA: the new ring row and its point chunk (and, for a
    monocular sensor, the previous keyframe's row, whose keypoints the
    spawned points were triangulated against), copied on the device with
    no sync; and the BA's problem and result as it built and solved them.

    A ``_windowed_ba`` call is sampled only when the keyframe count has
    advanced since the last one, that is when ``_create_keyframe`` has run
    since: a loop closure's junction BA runs at the same count
    (``maintenance.py``) and is not a keyframe."""

    def __init__(self, sample, lim, mono, cur, last_extract):
        self.sample, self.lim, self.mono = sample, lim, mono
        self.cur, self.last_extract = cur, last_extract
        self.new_kf = False
        self.keyframes = 0

    def install(self, realtime, local_ba):
        make, ba = realtime._create_keyframe, realtime._windowed_ba
        solve = local_ba.optimize_local_ba

        def create_keyframe(*a, **k):
            self.new_kf = True
            return make(*a, **k)

        def windowed_ba(st, *a, **k):
            self.begin(st)
            try:
                return ba(st, *a, **k)
            finally:
                self.sample.cur = None

        def optimize_local_ba(prob, *a, **k):
            res = solve(prob, *a, **k)
            if self.sample.cur is not None:
                self.sample.cur["ba"] = (prob, res)
            return res

        realtime._create_keyframe = create_keyframe
        realtime._windowed_ba = windowed_ba
        local_ba.optimize_local_ba = optimize_local_ba

    def begin(self, st):
        import torch
        new_kf, self.new_kf = self.new_kf, False
        self.sample.cur = None
        if not (new_kf and self.cur["window"]):
            return
        self.sample.begin(self.keyframes, self.cur["frame"])
        self.keyframes += 1
        rec = self.sample.cur
        if rec is None:
            return
        K, S = self.lim.max_kf, self.lim.spawn_per_kf

        def row(arr, k):
            return arr.index_select(0, k.reshape(1))[0]

        kp = (st.n_kf - 1) % K
        rows = kp * S + torch.arange(S, device=st.n_kf.device)
        rec.update(extract=self.last_extract[0], n_kf=st.n_kf.clone(),
                   pid=row(st.kf_pid, kp), R=row(st.kf_R, kp),
                   t=row(st.kf_t, kp), pos=st.pt_pos.index_select(0, rows),
                   valid=st.pt_valid.index_select(0, rows))
        if self.mono:
            # The previous keyframe's row with the new points' ids that
            # _create_keyframe wrote into it.
            pk = (st.n_kf - 2) % K
            rec["prev"] = {"R": row(st.kf_R, pk), "t": row(st.kf_t, pk),
                           "uv": row(st.kf_obs, pk)[:, :2],
                           "w": row(st.kf_w, pk), "pid": row(st.kf_pid, pk)}


def span_target(path, objects):
    """(owner, attribute) of a span's target as the configuration names
    it: ``<object>.<method>`` for one of the session's ``objects``
    (``detector``, ``maint``), else ``<module>.<function>`` of the port.
    None when the object is absent from the session."""
    head, attr = path.rsplit(".", 1)
    if head in objects:
        obj = objects[head]
        return None if obj is None else (obj, attr)
    return importlib.import_module(f"{PORT}.{head}"), attr


def frame_args(names, frames, fi, stamp, empty):
    """The entry's arguments, named as the configuration's ``entry``
    lists them."""
    def one(n):
        if n == "stamp":
            return stamp
        if n == "boxes":
            b = frames.boxes[fi]
            return b if len(b) else empty
        return getattr(frames, n)[fi]
    return [one(n) for n in names]


def run(index, cell, seed, seconds, trace, conn, opts):
    t_proc = time.monotonic()
    import torch
    torch.set_num_threads(1)
    from coebslam_tpu_torch import config as config_mod
    from coebslam_tpu_torch.models import detector as detector_mod
    from coebslam_tpu_torch.ops import extractor
    from coebslam_tpu_torch.optim import local_ba
    from coebslam_tpu_torch.slam import frame, realtime, tracking
    from coebslam_tpu_torch.slam import vocabulary
    from . import checks, reference, stats, traffic
    from . import trace as trace_mod

    cfg_d = cell["config"]
    tr = cell["traffic"]
    dev = torch.device(opts.get("device", "cuda"))
    cuda = dev.type == "cuda"
    cfg = config_mod.config_from_dict(cfg_d)
    cam = traffic.Camera(cfg.camera.fx, cfg.camera.fy, cfg.camera.cx,
                         cfg.camera.cy, cfg.camera.width, cfg.camera.height,
                         cfg.camera.fps)

    # ---- traffic and weights from the seed
    t_render = time.monotonic()
    frames = traffic.make_frames(tr, cam, cfg.sensor, seed, index, dev,
                                 baseline=cfg.camera.bf / cfg.camera.fx)
    render_s = time.monotonic() - t_render
    n = frames.gray.shape[0]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ref_model = det = None
    if cfg_d.get("detector_enabled"):
        calib = reference.detector_input(
            torch.from_numpy(frames.gray[0]).to(dev), cfg.detector.input_size)
        ref_model = reference.make_detector(cfg_d["detector"], seed, calib,
                                            dev)
        det = detector_mod.YoloDetector(
            cfg.detector, cfg.dynamic,
            variables={k: v.detach().clone()
                       for k, v in ref_model.state_dict().items()},
            device=dev)
    voc = vocabulary.load(os.path.join(cell["root"], cfg_d["vocabulary_file"]))
    lim = realtime.RTLimits(**cfg_d["limits"])
    rt = realtime.RealtimeSlam(cfg, lim, device=dev, vocabulary=voc,
                               maintain_every=int(tr["maintain_every"]),
                               detector=det,
                               detect_every=int(tr.get("detect_every", 1)))

    # ---- the control or a planted fault (tests only) replace a stage
    if opts.get("control"):
        checks.install_control(det, ref_model, cfg_d, extractor, frame,
                               tracking, local_ba)
    if opts.get("fault"):
        checks.install_fault(opts["fault"], extractor, realtime, tracking,
                             local_ba)

    # ---- capture of the sampled frames' outputs, spans, host times
    sample = Sample(int(tr["sample_frames"]),
                    np.random.RandomState(traffic.session_seed(seed, index)
                                          ^ 0x5A17))
    kf_sample = Sample(int(tr.get("sample_keyframes", 0)),
                       np.random.RandomState(traffic.session_seed(seed, index)
                                             ^ 0x6B28))
    host = {}
    rf = {} if trace else None          # span intervals, traced runs only
    last_extract = [None]
    cur = {"window": False, "frame": 0}

    def keep_extract(args, kw, out):
        inputs = (kw.get("n_features"), kw.get("dynamic_mask"),
                  kw.get("area_mode"))
        last_extract[0] = inputs
        if sample.cur is not None:
            sample.cur["extract"] = inputs + (out,)

    def keep_stage(args, kw, out):
        if sample.cur is not None:
            sample.cur["stages"].append((args, out))

    def keep_heads(args, kw, out):
        if sample.cur is not None:
            sample.cur["heads"] = out

    mono = cfg.sensor == "monocular"
    KeyframeCapture(kf_sample, lim, mono, cur, last_extract).install(
        realtime, local_ba)

    # Spans around the port's functions, as the configuration names them;
    # the check's captures ride on the extraction's span.
    spans = cfg_d["spans"]
    objects = {"detector": det, "maint": rt.maint}
    for label, path in spans.items():
        tgt = span_target(path, objects)
        if tgt is not None:
            trace_mod.wrap(*tgt, label, host, rf,
                           after=keep_extract if label == "extract" else None)
    trace_mod.wrap(tracking, "track_step", "track_step", host, None,
                   after=keep_stage)
    if det is not None:
        trace_mod.wrap(det, "heads", "heads", host, None, after=keep_heads)

    empty = np.zeros((0, 4), np.float32)
    fps = cfg.camera.fps
    method = getattr(rt, cfg_d["entry"]["method"])
    arg_names = cfg_d["entry"]["args"]

    def feed(step):
        fi = traffic.ping_pong(step, n)
        cur["frame"] = fi
        method(*frame_args(arg_names, frames, fi, step / fps, empty))
        return fi

    # ---- warm-up: the first keyframe and its BA, maintenance, detection
    warm = int(tr["warmup_frames"])
    for step in range(warm):
        feed(step)
    if cuda:
        torch.cuda.synchronize()
    for v in host.values():
        v.clear()
    prof = None
    if trace:
        for v in rf.values():
            v.clear()
        if cuda:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
    conn.send(("ready", {"setup_process_s": time.monotonic() - t_proc,
                         "render_s": render_s,
                         "device_name": torch.cuda.get_device_name(dev)
                         if cuda else "cpu"}))
    msg, t0 = conn.recv()
    if msg != "go":
        return

    # ---- the window
    while time.monotonic() < t0:
        time.sleep(min(0.002, max(0.0, t0 - time.monotonic())))
    cur["window"] = True
    e0 = torch.cuda.Event(enable_timing=True) if cuda else None
    if cuda:
        e0.record()
        e0.synchronize()
    h0 = time.monotonic()
    wall0 = time.time_ns() - time.monotonic_ns()
    t_end = t0 + seconds
    rec = []
    syncs = []
    catcher = warnings.catch_warnings(record=True)
    if trace and cuda:
        caught = catcher.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
    step = 0
    while True:
        now = time.monotonic()
        if now >= t_end:
            break
        sample.begin(step, traffic.ping_pong(warm + step, n))
        feed(warm + step)
        back = time.monotonic()
        ev = None
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        rec.append((now, back, ev))
        step += 1
    sample.cur = None
    if cuda:
        torch.cuda.synchronize()
    h_end = time.monotonic()
    cur["window"] = False
    if trace and cuda:
        torch.cuda.set_sync_debug_mode("default")
        catcher.__exit__(None, None, None)
        syncs = [w for w in caught if "synchroniz" in str(w.message)]
    t_trace = time.monotonic()
    if prof is not None:
        prof.__exit__(None, None, None)

    # ---- readings of the window
    if cuda:
        done = [h0 + e0.elapsed_time(ev) / 1e3 for _, _, ev in rec]
        peak = torch.cuda.max_memory_allocated()
        free, total = torch.cuda.mem_get_info()
        chip_used = total - free
    else:
        done = [b for _, b, _ in rec]
        peak = chip_used = 0
    res = rt.finish()
    ok = np.asarray(res["ok"], bool)
    win_ok = ok[warm:warm + len(rec)]
    order = [traffic.ping_pong(s, n) for s in range(len(ok))]
    est = -np.einsum("nji,nj->ni", res["R"], res["t"])
    gt = frames.centres[order]
    # A monocular map has its own scale: align by a similarity.
    ate_m, ate_scale = stats.ate_rmse(est[ok], gt[ok], with_scale=mono) \
        if ok.sum() >= 3 else (float("nan"), float("nan"))
    out = {
        "index": index, "t0": t0, "h0": h0, "h_end": h_end,
        "hand": [r[0] for r in rec], "back": [r[1] for r in rec],
        "done": done, "lost": int((~win_ok).sum()),
        "attempted": len(rec), "peak_bytes": int(peak),
        "chip_used_bytes": int(chip_used),
        "maint_host_ms": list(host.get("maint", [])),
        "syncs": len(syncs), "ate_m": ate_m, "ate_scale": ate_scale,
        "n_kf": int(res["n_kf"]), "frames_seen": len(set(order)),
    }
    if mono:
        # The step (warm-up steps first) whose two-view attempt built the map.
        out["init_step"] = next((a["frame"] for a in res["init_attempts"]
                                 if a["ok"]), None)
    if trace:
        lo = (h0 * 1e9) + wall0
        hi = (h_end * 1e9) + wall0
        red = trace_mod.reduce(
            prof.profiler.kineto_results.events() if prof is not None
            else [], {k: rf.get(k, []) for k in spans}, lo, hi)
        for iv in [red["busy"]] + [s["intervals"]
                                   for s in red["spans"].values()]:
            iv -= wall0
        out["trace"] = red
        del prof
    out["trace_s"] = time.monotonic() - t_trace
    del rt, det, res
    if cuda:
        torch.cuda.empty_cache()

    # ---- the check, with the window closed and the state freed
    t_check = time.monotonic()
    out["check"] = checks.check_session(sample.records(), frames, cfg_d,
                                        ref_model, dev)
    out["check"].update(checks.check_keyframes(kf_sample.records(), frames,
                                               cfg_d, lim, dev))
    out["check_s"] = time.monotonic() - t_check
    out["forbidden"] = forbidden_modules()
    conn.send(("done", out))

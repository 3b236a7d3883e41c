"""CPU reference runs of the scenes of ``chip_smoke.py``.

Run from the repository root:

    python3 cpu_reference.py jax {orbit,circuit,kidnap,selfdetect}
    python3 cpu_reference.py {jax,port} {stereo,mono} [N]
    python3 cpu_reference.py jax refine {orbit,circuit}
    python3 cpu_reference.py port {circuit,kidnap,selfdetect}
    python3 cpu_reference.py port refine circuit
    python3 cpu_reference.py {jax,port} {host-replica,driver-rt} [N]
    python3 cpu_reference.py port png
    python3 cpu_reference.py {jax,port} {host-loop,host-reloc}
    python3 cpu_reference.py {jax,port} {host-loop-full,host-reloc-full}
    python3 cpu_reference.py {jax,port} {host-stereo,host-mono,host-flow}
    python3 cpu_reference.py {jax,port} {host-stereo,host-mono,host-flow}-full
    python3 cpu_reference.py {jax,port} {rt-bank-loop,rt-bank-reloc}
    python3 cpu_reference.py {jax,port} {host-epnp-reloc,host-mono-loop}
    python3 cpu_reference.py jax train-detector [STEPS]
    python3 cpu_reference.py {jax,port} train-curve [STEPS]
    python3 cpu_reference.py {jax,port} {closure-replica,replica-maint,two-walkers} [N]
    python3 cpu_reference.py jax rt-bank-snapshot

Drives one package on the CPU over one scene at the configuration of the
matching ``chip_smoke.py`` phase, and prints one JSON line with seconds:

- ``orbit``, ``circuit``, ``kidnap`` ([4], [6], [7]), with
  ``artifacts/vocab_1e5.npz``: ATE (all frames; ``tail_ate_m`` over the
  last 8 frames of the circuit or the last 5 of the kidnap), frames
  tracked, loops closed and the event log, relocalizations, bank entries,
  keyframes, the keyframes processed (``bow_next``) and the keyframe count
  at the last dispatch.
- ``selfdetect`` ([8]): the first N_SELFDETECT frames of the dynamic
  orbit with no ground-truth boxes, ``RealtimeSlam(detector=,
  detect_every=3)`` on ``artifacts/detector_walker.npz``: ATE, frames
  tracked, keyframes, detections dispatched and the mean best box IoU on
  every 10th frame.
- ``stereo`` ([11]): the wide-baseline dynamic stereo scene at full width
  (``track_stereo``, the walker's ground-truth boxes): ATE, frames
  tracked, keyframes and live points.
- ``mono`` ([12]): the monocular orbit at full width (``track_mono``):
  the first tracked frame, frames lost after it, the Sim3-aligned ATE over
  the tracked frames, keyframes, and each initialisation attempt (whether
  it succeeded, H or F, the points triangulated).
- ``stereo N``, ``mono N``: the first N frames of either scene (the cut
  ``chip_smoke.py`` makes when the script runs long).
- ``host-replica`` ([13]): the host-orchestrated ``System(SystemConfig())``
  (synchronous, no vocabulary, no detector) over the first N (default
  N_HOST) frames of the 400-frame TUM replica with the walker's boxes (the
  JAX package writes and reads back its PNG files as
  tests/test_tum_replica.py does; the port renders them in memory): frames
  OK and lost, ATE, keyframes, live points, local BAs and the keyframes and
  points culled.
- ``driver-rt`` ([16c]): each package's offline driver,
  ``run_tum_rgbd --realtime --refine --boxes``, on the first N (default
  N_HOST) files of the 400-frame replica: frames OK, ATE, keyframes, the
  keyframes the global BA optimised and the refined ATE. The JAX package
  writes its replica (``generate(root)``) and runs
  ``examples/run_tum_rgbd.py`` in this process; the port writes the first
  N frames (``replica.write``) and runs its driver's ``run()``.
- ``png``: the CPU time of ``io/png.decode`` on the replica's first
  depth frame (640x480, 16-bit), median of 5: as the port's writer files
  it (None/Sub/Up rows, undone row by row) and with every row Paeth
  (the anti-diagonal sweep), the worst case for a file from libpng.
- ``host-loop`` ([14a]): ``System(vocabulary=)`` (synchronous) over
  tests/test_loop_e2e.py's circuit at the test's ORB cut (1024
  keypoints, 4 levels; ``host_bow_scenes.HOST_LOOP_ORB``) with the scene's own
  vocabulary: loops closed, the first closing frame, the loop and fused
  edges, the ATE before the first closure and of the exported
  trajectory, the gates that failed, and each accepted closure's host ms
  and host syncs by stage (compute_sim3, correct, its pose graph and
  global BA; syncs are counted on the card only).
- ``host-reloc`` ([14b]): ``System(vocabulary=)`` over the blackout scene
  of tests/test_vocabulary.py::TestRelocalizationE2E at the test's ORB
  cut (``host_bow_scenes.HOST_RELOC_ORB``): the
  states before and after the blackout and on the return, the camera
  centre's error, and each relocalization call (its branch, the
  candidates tried, the inliers, host ms).
- ``host-loop-full``, ``host-reloc-full``: the same two at OrbConfig()'s
  full width (2048 keypoints, 8 levels). These runs are why [14] keeps the
  tests' cut: at full width the JAX package misses a gate of each.
- ``host-stereo``, ``host-mono``, ``host-flow`` ([15a]-[15c],
  ``host_sensor_scenes.py``): the host ``System``'s ``track_stereo`` on
  the stereo room's 40 frames, ``track_monocular(vocabulary=)`` through
  the monocular kidnap, and ``track_rgbd`` with the flow motion check on
  the walker scene, at the tests' ORB cut (1024 keypoints, 4 levels);
  with ``-full`` at the width ``chip_smoke.py`` runs them
  (``SystemConfig(sensor="stereo")``, the mono test's configuration with
  ``OrbConfig()``, ``SystemConfig()`` with the flow check). Each prints
  its gates' numbers and the failed gates; mono adds the initialisation
  attempts and the relocalize calls, flow the frames on which the
  walker's box was dynamic.
- ``train-detector [STEPS]``: the JAX package's tools/train_detector.py
  at the walker detector's width (``--width 0.25 --cpu``, default 700
  steps, its own 3 x 130 rendered frames), run as a subprocess with its
  output file in a temporary directory (never over the committed
  artifact): the loss at every step it prints and the held-out mean IoU,
  the quality to set beside the port's run of the same tool on the card
  (``python3 -m coebslam_tpu_torch.tools.train_detector --width 0.25``)
  and the committed artifact's recorded ``__miou__``.
- ``rt-bank-loop``, ``rt-bank-reloc`` ([19], ``rt_loop_scenes.py``):
  the realtime place bank on the drifted circuit with an 8-row keyframe
  ring and the scene's own vocabulary (tests/test_place_bank.py): the
  bank closure after the ring wraps beside its odometry twin (keyframes,
  bank entries and closures, the applied closures' keyframe gaps, the
  revisit gap and ATE of both), and the relocalization to an evicted
  place (bank relocalizations, revisit frames tracked, their median
  centre error); the failed gates and the event log.
- ``host-epnp-reloc`` ([21], ``host_sensor_scenes.py``): [15b]'s
  monocular System at full width over frames 0-45 of the room's orbit at
  1.2 m radius, 3 black frames, then frame 15 again, which lies beyond
  the fused step's widened
  gate: [15b]'s gates' numbers, the return frame's relocalize calls
  (branch, candidates tried, inliers) and its EPnP RANSACs, counted.
- ``host-mono-loop`` ([20]): ``host-epnp-reloc``'s session, then its map
  drifted in scale (``host_sensor_scenes.drift_late_keyframes``) and its
  newest keyframe closed against its oldest through the System's loop
  closer: the pair, compute_sim3's gates, S12's scale, the keyframe Sim3
  ATE before the drift, drifted and after the closure, the closure's
  stages (host ms).
- ``train-curve [STEPS]``: every step's loss and its four terms
  (objectness BCE, class BCE, xy, wh) of a training run at the walker
  detector's width 0.25 (default 700 steps) on the CPU, with the largest
  loss and its step and the held-out IoU. ``port`` runs
  ``coebslam_tpu_torch.tools.train_detector.run`` (deterministic, its
  output in a temporary directory); ``jax`` runs the JAX tool's own
  dataset, targets, network and Adam with its ``loss_fn`` transcribed to
  return the terms too (the tool prints the loss every 100 steps only).
  ``profile_train_detector.py --cpu-json`` reads the port's.
- ``closure-replica``, ``replica-maint``, ``two-walkers`` ([22],
  ``replica_rows.py``'s rows ``closure`` with its ``twin``, ``maint`` and
  ``walkers``; N frames, by default the full 300, 400 and 200): bench.py's
  dataset rows on the realtime path. The JAX package writes its replica
  (``generate(root)``) and reads it back as bench.py does; the port
  renders it in memory (``replica_rows.run_row`` on the CPU). Frames
  tracked, ATE, keyframes, seconds; the closure row's loops and events
  and its odometry twin's ATE; ``replica-maint``'s loops,
  relocalizations and the refined ATE after ``handoff.refine``;
  ``two-walkers``' frames by the number of walker boxes they carry.
- ``rt-bank-snapshot``: [19a] through the JAX package on the frames,
  scene vocabulary and draws that tests/test_torch_place_bank_parity.py
  shares with the port, and the state before the dispatch that applies
  the bank closure written to that test's ``tests/data/rt_bank_closing.npz``.
- ``refine orbit|circuit`` ([10]): the session of [4] or [6], then the
  handoff (``to_arena``), global BA and ``refined_trajectory``: the
  arena's keyframes and points, the observations cut (``truncated_obs``),
  the seconds of the handoff and of the global BA, and keyframe and
  full-trajectory ATE before and after.

The ``jax`` runs give the JAX-package references that ``chip_smoke.py``
prints beside its own results (``JAX_CPU_*``). The full-width orbit takes
several minutes per package; ``port`` does not run it.
"""
import json
import os
import sys
import time

import numpy as np

from chip_smoke import (CIRCUIT_LIMITS, DETECT_EVERY, HOST_SCHEDULE,
                        driver_summary,
                        MONO_RADIUS, N_HOST, N_MONO, N_SELFDETECT, N_STEREO,
                        STEREO_BLUR, STEREO_WALKER, circuit_config,
                        host_summary, mean_best_iou, mono_config, mono_scene,
                        mono_summary, refine_report, replica_host_frames,
                        run_host, stereo_blurred, stereo_config, stereo_scene,
                        walker_detector)
from host_sensor_scenes import (
    HOST_EPNP_ORBIT, HOST_EPNP_RETURN, HOST_EPNP_TRACK,
    HOST_EPNP_VOCAB_FRAMES, HOST_FLOW_ORBIT, HOST_FLOW_WALKER, HOST_MONO_ORBIT, HOST_MONO_RETURN,
    HOST_MONO_TRACK, host_epnp_failures, host_mono_frame_of,
    run_mono_loop,
    HOST_MONO_VOCAB, HOST_MONO_VOCAB_FRAMES, HOST_STEREO_ORBIT,
    N_HOST_FLOW, pose_centres, host_flow_config, host_flow_failures,
    host_flow_frames, host_flow_summary, host_mono_config,
    host_mono_failures, host_stereo_config, host_stereo_failures,
    host_stereo_frames, host_stereo_summary, run_host_flow, run_host_mono,
    run_host_stereo)
from rt_loop_scenes import (BANK_LIMITS, BANK_VOCAB, bank_loop_failures,
                            bank_loop_summary, bank_reloc_failures,
                            bank_reloc_summary, bank_vocab_frames,
                            loop_scene, run_bank_reloc, run_realtime)
from host_bow_scenes import (HOST_LOOP_VOCAB, HOST_LOOP_VOCAB_FRAMES,
                             HOST_RELOC_ORBIT, HOST_RELOC_RETURN,
                             HOST_RELOC_VOCAB, HOST_RELOC_VOCAB_FRAMES,
                             RELOC_ATTEMPTS, closure_stages, host_loop_config,
                             host_loop_failures, host_loop_summary,
                             host_reloc_config, host_reloc_failures,
                             reloc_calls, reloc_direct, reloc_truth,
                             depth_free_frames, run_host_loop, run_host_reloc,
                             scene_vocabulary, watch_calls)

ROOT = os.path.dirname(os.path.abspath(__file__))
VOCAB = os.path.join(ROOT, "artifacts", "vocab_1e5.npz")
N_ORBIT = 150
KIDNAP = list(range(0, 50)) + list(range(6, 16))
REPORT = ("n_loops_closed", "n_loop_events", "n_relocalizations",
          "n_bank_loops", "n_bank_reloc", "bank_entries", "loop_events",
          "n_kf")


def _watch_dispatches(rt):
    """The keyframe count of the state at each maintenance dispatch."""
    seen = []
    step = rt.maint.step

    def watched(st, ms, *args, **kw):
        seen.append(int(st.n_kf))
        return step(st, ms, *args, **kw)

    rt.maint.step = watched
    return seen


def _summary(rt, res, seen, gt, ate, tail):
    est = np.asarray([-R.T @ t for R, t in zip(res["R"], res["t"])])
    n = len(est)
    out = {"ate_m": float(ate.ate_rmse(res["stamps"], est,
                                       np.arange(n) / 30.0, gt)["rmse"]),
           "ok": int(res["ok"].sum()), "n": n,
           "last4_ok": bool(res["ok"][-4:].all())}
    if tail:
        s = slice(n - tail, n)
        out["tail_ate_m"] = float(ate.ate_rmse(
            res["stamps"][s], est[s], res["stamps"][s], gt[s])["rmse"])
    if rt.maint is not None:
        out.update({k: res[k] for k in REPORT})
        out.update(bow_next=int(rt.mstate.bow_next),
                   n_kf_at_last_dispatch=seen[-1] if seen else None)
    else:
        out["n_kf"] = res["n_kf"]
    return out


def _refine(res, cfg, gt, ate, handoff, gba, **kw):
    """[10]: handoff and global BA of a finished session, timed apart."""
    t0 = time.time()
    arena, kf_ids = handoff.to_arena(res, cfg)
    t1 = time.time()
    n_opt = gba.run(arena)
    t2 = time.time()
    out = refine_report(res, arena, kf_ids, gt, ate, handoff)
    out.update(n_optimized=n_opt, truncated_obs=gba.truncated_obs,
               handoff_s=t1 - t0, gba_s=t2 - t1)
    return out


def _sensor_summary(res, gt, ate, mono):
    est = np.asarray([-R.T @ t for R, t in zip(res["R"], res["t"])])
    if mono:
        out = mono_summary(res["ok"], est, gt, ate)
    else:
        n = len(est)
        out = {"ate_m": float(ate.ate_rmse(res["stamps"], est,
                                           np.arange(n) / 30.0, gt)["rmse"]),
               "ok": int(res["ok"].sum()), "n": n}
    out.update(n_kf=int(res["n_kf"]), live_points=int(res["pt_valid"].sum()))
    return out


def _count_mapper(sysm):
    """Count the local BAs and the keyframes and points the mapper culls
    (the same wrappers for both packages)."""
    n = {"local_ba": 0, "culled_kf": 0, "culled_pt": 0}
    mp = sysm.mapper
    ba, cull_pts, cull_kfs = mp._ba_dispatch, mp.cull_map_points, \
        mp.cull_keyframes

    def ba_(kf):
        n["local_ba"] += 1
        return ba(kf)

    def cull_pts_(kf):
        before = len(mp.map.valid_points())
        cull_pts(kf)
        n["culled_pt"] += before - len(mp.map.valid_points())

    def cull_kfs_(kf):
        before = len(mp.map.valid_keyframes())
        cull_kfs(kf)
        n["culled_kf"] += before - len(mp.map.valid_keyframes())

    mp._ba_dispatch, mp.cull_map_points = ba_, cull_pts_
    mp.cull_keyframes = cull_kfs_
    return n


def run_host_replica(pkg, n=None):
    """[13] on either package, on the first ``n`` (default N_HOST) frames."""
    n = n or N_HOST
    if pkg == "jax":
        import tempfile
        from coebslam_tpu.config import SystemConfig
        from coebslam_tpu.eval import ate
        from coebslam_tpu.io import tum
        from coebslam_tpu.slam.system import System
        from coebslam_tpu.utils import replica
        root = tempfile.mkdtemp(prefix="replica400_")
        replica.generate(root, **HOST_SCHEDULE)
        seq = tum.load_tum_sequence(root)
        bstamps, bboxes = replica.load_boxes(os.path.join(root, "boxes.txt"))
        frames = []
        for i in range(n):
            stamp, gray, depth = seq.load_frame(i, depth_factor=5000.0)
            j = int(np.argmin(np.abs(bstamps - stamp)))
            b = bboxes[j] if abs(bstamps[j] - stamp) <= 0.03 else None
            frames.append((stamp, gray, depth, b))
        gt_stamps, gt = seq.gt_stamps[:n], seq.gt_poses[:n, :3]
        sysm = System(SystemConfig())
    else:
        from coebslam_tpu_torch.config import SystemConfig
        from coebslam_tpu_torch.eval import ate
        from coebslam_tpu_torch.slam.system import System
        from coebslam_tpu_torch.utils import replica
        frames, gt = replica_host_frames(replica, n, "cpu")
        gt_stamps = [f[0] for f in frames]
        sysm = System(SystemConfig(), device="cpu")
    counts = _count_mapper(sysm)
    t0 = time.time()
    states = run_host(sysm, frames)
    out = host_summary(sysm, states, gt_stamps, gt, ate)
    out.update(counts, track_s=time.time() - t0,
               stage_ms=dict(sysm.mapper.stage_ms))
    return out


def run_driver_rt(pkg, n=None):
    """[16c] on either package: its driver ``run_tum_rgbd --realtime
    --refine --boxes``, run as a user runs it, on the first ``n`` replica
    files."""
    import tempfile
    n = n or N_HOST
    root = tempfile.mkdtemp(prefix="replica_driver_")
    argv = [root, "--cpu", "--boxes", os.path.join(root, "boxes.txt"),
            "--max-frames", str(n), "--out", os.path.join(root, "out"),
            "--realtime", "--refine"]
    t0 = time.time()
    if pkg == "port":
        from coebslam_tpu_torch.examples import run_tum_rgbd
        from coebslam_tpu_torch.utils import replica
        replica.write(root, **HOST_SCHEDULE, frames=range(n), device="cpu")
        write_s = time.time() - t0
        summary = driver_summary(run_tum_rgbd.run(
            run_tum_rgbd.parse_args(argv)))
    else:
        from coebslam_tpu.utils import replica
        replica.generate(root, **HOST_SCHEDULE)
        write_s = time.time() - t0
        summary = _jax_driver_rt(argv, n)
    summary.update(write_s=write_s)
    return summary


def _jax_driver_rt(argv, n):
    """examples/run_tum_rgbd.py run in this process with ``argv``: frames
    OK, keyframes and the keyframes optimised read from its log, its two
    ATEs (raw, refined) recorded at full precision as it computes them."""
    import contextlib
    import io
    import re
    import runpy
    from coebslam_tpu.eval import ate
    scores, ate_rmse = [], ate.ate_rmse

    def record(*a, **kw):
        scores.append(ate_rmse(*a, **kw))
        return scores[-1]
    ate.ate_rmse, sys.argv, log = record, ["run_tum_rgbd.py"] + argv, \
        io.StringIO()
    try:
        with contextlib.redirect_stdout(log):
            runpy.run_path("examples/run_tum_rgbd.py", run_name="__main__")
    finally:
        ate.ate_rmse = ate_rmse
    text = log.getvalue()
    ok, n_kf = re.search(r"ok (\d+)/\d+; keyframes (\d+)", text).groups()
    n_opt = re.search(r"global BA over (\d+) keyframes", text).group(1)
    return {"n": n, "ate_m": float(scores[0]["rmse"]), "ok": int(ok),
            "n_kf": int(n_kf), "n_opt": int(n_opt),
            "refined_ate_m": float(scores[1]["rmse"])}


def run_png():
    """``png``: decode times of a replica depth frame (see the module's
    docstring)."""
    import zlib
    from coebslam_tpu_torch.io import png
    from coebslam_tpu_torch.utils import replica
    f = next(replica.generate(**HOST_SCHEDULE, frames=[0], device="cpu"))
    own = png.encode(f.depth)
    # Every row Paeth-filtered (encoding depends on the raw bytes only).
    raw = f.depth.astype(">u2").view(np.uint8).reshape(
        f.depth.shape[0], -1).astype(np.int16)
    a = np.zeros_like(raw)
    a[:, 2:] = raw[:, :-2]
    b = np.zeros_like(raw)
    b[1:] = raw[:-1]
    c = np.zeros_like(raw)
    c[1:, 2:] = raw[:-1, :-2]
    pred = png._paeth(a, b, c)
    body = np.concatenate([np.full((len(raw), 1), 4, np.uint8),
                           ((raw - pred) & 0xFF).astype(np.uint8)], 1)
    ihdr = own[16:29]
    paeth = (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
             + png._chunk(b"IDAT", zlib.compress(body.tobytes()))
             + png._chunk(b"IEND", b""))
    out = {}
    for name, data in (("rows_none_sub_up", own), ("rows_paeth", paeth)):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            img = png.decode(data)
            times.append(time.perf_counter() - t0)
        if not np.array_equal(img, f.depth):
            sys.exit(f"png {name}: decode differs")
        out[f"decode_ms_{name}"] = float(np.median(times) * 1e3)
        out[f"bytes_{name}"] = len(data)
    t0 = time.perf_counter()
    png.encode(f.depth)
    out["encode_ms"] = (time.perf_counter() - t0) * 1e3
    out["shape"] = list(f.depth.shape)
    return out


def run_host_bow(pkg, scene):
    """[14a] (``host-loop``) or [14b] (``host-reloc``) on either package,
    at the tests' ORB cut or, with a ``-full`` suffix, at full width."""
    loop = scene.startswith("host-loop")
    full = scene.endswith("-full")
    if pkg == "jax":
        import jax
        import jax.numpy as jnp
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from coebslam_tpu import config
        from coebslam_tpu.eval import ate
        from coebslam_tpu.ops import extractor
        from coebslam_tpu.slam import frame as frame_mod
        from coebslam_tpu.slam import vocabulary as voc_mod
        from coebslam_tpu.slam.global_ba import GlobalBA
        from coebslam_tpu.slam.system import System
        from coebslam_tpu.utils import synthetic
        from test_loop_e2e import (DEPTH_BIAS, N_CIRCUIT, N_OVERLAP,
                                   circuit_poses, six_wall_room)
        cfg = (host_loop_config if loop else host_reloc_config)(config, full)
        if loop:
            planes, poses = six_wall_room(), circuit_poses(N_CIRCUIT
                                                           + N_OVERLAP)
        else:
            planes = synthetic.make_room(seed=0)
            poses = synthetic.camera_trajectory(**HOST_RELOC_ORBIT)
        render = jax.jit(lambda p: synthetic.render(cfg.camera, p,
                                                    planes)[:2])
        ex = jax.jit(lambda g: extractor.extract(g, cfg.orb))

        def descs_of(g):
            f = ex(g)
            return np.asarray(f.desc)[np.asarray(f.valid)]

        frames = [render(p) for p in poses]
        if loop:
            frames = [(g, np.asarray(d) * DEPTH_BIAS) for g, d in frames]
        black = (jnp.zeros_like(frames[0][0]), jnp.ones_like(frames[0][1]))
        gba = GlobalBA(cfg)
        make = lambda voc: System(cfg, vocabulary=voc)
        np_pose = lambda p: (np.asarray(p.R), np.asarray(p.t))

        def direct_frames(sysm, g, d):
            fd = frame_mod.process_rgbd(jnp.asarray(g), jnp.asarray(d),
                                        cfg.camera, cfg.orb)
            words = np.asarray(voc_mod.transform_words(
                sysm.voc, fd.feats.desc, fd.feats.valid)[0])
            flat = fd._replace(depth=jnp.zeros_like(fd.depth),
                               ur=jnp.full_like(fd.ur, -1.0),
                               obs=fd.obs.at[:, 2].set(-1.0))
            return fd, flat, words
    else:
        import torch
        from coebslam_tpu_torch import config
        from coebslam_tpu_torch.eval import ate
        from coebslam_tpu_torch.ops import extractor
        from coebslam_tpu_torch.slam import frame as frame_mod
        from coebslam_tpu_torch.slam import vocabulary as voc_mod
        from coebslam_tpu_torch.slam.global_ba import GlobalBA
        from coebslam_tpu_torch.slam.system import System
        from coebslam_tpu_torch.utils import synthetic
        cfg = (host_loop_config if loop else host_reloc_config)(config, full)
        if loop:
            planes = synthetic.six_wall_room(device="cpu")
            poses = synthetic.circuit_poses(synthetic.N_CIRCUIT
                                            + synthetic.N_OVERLAP)
        else:
            planes = synthetic.make_room(seed=0, device="cpu")
            poses = synthetic.camera_trajectory(**HOST_RELOC_ORBIT)
        frames = [synthetic.render(cfg.camera, p, planes)[:2] for p in poses]
        if loop:
            frames = [(g, d * synthetic.DEPTH_BIAS) for g, d in frames]

        def descs_of(g):
            f = extractor.extract(g, cfg.orb)
            return f.desc[f.valid].numpy()

        black = (torch.zeros_like(frames[0][0]),
                 torch.ones_like(frames[0][1]))
        gba = GlobalBA(cfg, device="cpu")
        make = lambda voc: System(cfg, device="cpu", vocabulary=voc)
        np_pose = lambda p: (p.R.numpy(), p.t.numpy())

        def direct_frames(sysm, g, d):
            return depth_free_frames(torch, frame_mod, sysm, cfg, g, d)
    t0 = time.time()
    vframes, vkw = ((HOST_LOOP_VOCAB_FRAMES, HOST_LOOP_VOCAB) if loop
                    else (HOST_RELOC_VOCAB_FRAMES, HOST_RELOC_VOCAB))
    voc = scene_vocabulary(voc_mod, [descs_of(frames[i][0])
                                     for i in vframes], **vkw)
    out = {"voc_words": int(voc.n_words), "voc_s": time.time() - t0}
    sysm = make(voc)
    rec = []
    t0 = time.time()
    if loop:
        sysm.loop_closer._global_ba = gba
        watch_calls(rec, sysm.loop_closer,
                    ("compute_sim3", "correct", "run_pose_graph"))
        watch_calls(rec, gba, ("run",))
        states, pre, closed_at = run_host_loop(sysm, frames)
        gt = np.asarray([-R.T @ t for R, t in map(np_pose, poses)])
        out.update(host_loop_summary(sysm, states, pre, closed_at, gt, ate))
        out.update(closures=closure_stages(rec),
                   failed=host_loop_failures(out))
    else:
        watch_calls(rec, sysm.relocalizer, RELOC_ATTEMPTS[pkg]
                    + ("relocalize",))
        Rg, tg = reloc_truth(*np_pose(poses[0]),
                             *np_pose(poses[HOST_RELOC_RETURN]))
        out.update(run_host_reloc(sysm, frames, black, Rg, tg))
        out["reloc"] = reloc_calls(rec)
        fd, flat, words = direct_frames(sysm, *frames[HOST_RELOC_RETURN])
        for branch, f in (("horn", fd), ("epnp", flat)):
            del rec[:]
            out[f"direct_{branch}"] = reloc_direct(sysm, f, words, Rg, tg)
            out[f"direct_{branch}"].update(reloc_calls(rec)[0])
        out.update(failed=host_reloc_failures(
            out, cfg.tracking.reset_if_lost_with_kfs_below))
    out["track_s"] = time.time() - t0
    return out


def run_host_sensor(pkg, scene):
    """[15a]-[15c] (``host-stereo``, ``host-mono``, ``host-flow``) on
    either package, at the tests' ORB cut or, with ``-full``, at the width
    chip_smoke.py runs; [21] (``host-epnp-reloc``) at that width."""
    mono_loop = scene == "host-mono-loop"
    kind = "epnp" if mono_loop else scene.split("-")[1]
    full = scene.endswith("-full") or kind == "epnp"
    if pkg == "jax":
        import jax
        import jax.numpy as jnp
        from coebslam_tpu import config
        from coebslam_tpu.eval import ate
        from coebslam_tpu.ops import extractor, initializer_ops
        from coebslam_tpu.slam import frame as frame_mod
        from coebslam_tpu.slam import vocabulary as voc_mod
        from coebslam_tpu.slam.global_ba import GlobalBA
        from coebslam_tpu.slam.system import System
        from coebslam_tpu.utils import synthetic
        planes = synthetic.make_room(seed=0)
        asarray = jnp.asarray
        make = System

        def depth_free(sysm, g):
            fd = frame_mod.process_rgbd(g, jnp.zeros_like(g), cfg.camera,
                                        cfg.orb)
            return fd, np.asarray(voc_mod.transform_words(
                sysm.voc, fd.feats.desc, fd.feats.valid)[0])
    else:
        import torch
        from coebslam_tpu_torch import config
        from coebslam_tpu_torch.eval import ate
        from coebslam_tpu_torch.ops import extractor, initializer_ops
        from coebslam_tpu_torch.slam import frame as frame_mod
        from coebslam_tpu_torch.slam import vocabulary as voc_mod
        from coebslam_tpu_torch.slam.global_ba import GlobalBA
        from coebslam_tpu_torch.slam.system import System
        from coebslam_tpu_torch.utils import synthetic
        planes = synthetic.make_room(seed=0, device="cpu")
        asarray = torch.from_numpy
        make = lambda cfg, **kw: System(cfg, device="cpu", **kw)

        def depth_free(sysm, g):
            fd = frame_mod.process_rgbd(g, torch.zeros_like(g), cfg.camera,
                                        cfg.orb)
            return fd, sysm._words(fd.feats.desc, fd.feats.valid)
    cfg = {"stereo": host_stereo_config, "mono": host_mono_config,
           "epnp": host_mono_config,
           "flow": host_flow_config}[kind](config, full)
    grey = lambda p: synthetic.render(cfg.camera, p, planes)[0]
    t0 = time.time()
    out = {}
    if kind == "stereo":
        poses = synthetic.camera_trajectory(**HOST_STEREO_ORBIT)
        frames = host_stereo_frames(grey, poses, cfg.camera, asarray)
        sysm = make(cfg)
        out.update(host_stereo_summary(sysm, run_host_stereo(sysm, frames),
                                       pose_centres(poses), ate))
        out["failed"] = host_stereo_failures(out)
    elif kind in ("mono", "epnp"):
        epnp = kind == "epnp"
        track, vocab_frames, ret = (
            (HOST_EPNP_TRACK, HOST_EPNP_VOCAB_FRAMES, HOST_EPNP_RETURN)
            if epnp else (HOST_MONO_TRACK, HOST_MONO_VOCAB_FRAMES,
                          HOST_MONO_RETURN))
        poses = synthetic.camera_trajectory(
            **(HOST_EPNP_ORBIT if epnp else HOST_MONO_ORBIT))[:track]
        frames = [grey(p) for p in poses]
        extract = lambda g: extractor.extract(g, cfg.orb)
        if pkg == "jax":
            extract = jax.jit(extract)
        descs = []
        for i in vocab_frames:
            f = extract(frames[i])
            descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
        voc = scene_vocabulary(voc_mod, descs, **HOST_MONO_VOCAB)
        sysm = make(cfg, vocabulary=voc)
        # The port's host initialisation runs the JAX ``reconstruct``'s
        # counterpart, ``reconstruct_graph``.
        fit_name = "reconstruct" if pkg == "jax" else "reconstruct_graph"
        attempts, orig = [], getattr(initializer_ops, fit_name)

        def logged(*a, **kw):
            r = orig(*a, **kw)
            attempts.append({"ok": bool(r.ok),
                             "homography": bool(r.used_homography),
                             "good": int(r.good.sum())})
            return r

        setattr(initializer_ops, fit_name, logged)
        rec = watch_calls([], sysm.relocalizer,
                          RELOC_ATTEMPTS[pkg] + ("relocalize",))
        mark = []
        try:
            out.update(run_host_mono(
                sysm, frames, frames[0] * 0, pose_centres(poses), ate, ret,
                before_return=lambda: mark.append(len(rec))))
        finally:
            setattr(initializer_ops, fit_name, orig)
        keys = ("ok", "n_inliers", "ms", "candidates_tried", "branch")
        out.update(voc_words=int(voc.n_words), init_attempts=attempts,
                   reloc=[{k: c[k] for k in keys} for c in reloc_calls(rec)])
        if epnp:
            back = rec[mark[0]:]
            out.update(return_reloc=[{k: c[k] for k in keys}
                                     for c in reloc_calls(back)],
                       return_pnp=sum("pnp" in r[0] for r in back))
            out.update(track_s=time.time() - t0, full=full,
                       failed=host_epnp_failures(out))
            if mono_loop:
                out = {"epnp_failed": out["failed"],
                       **_mono_loop(sysm, ate, GlobalBA, pose_centres(poses),
                                    pkg)}
            return out
        # The Relocalizer on the return frame, against frame 12's own
        # earlier pose: its EPnP branch (no depth).
        del rec[:]
        _, R12, t12 = sysm.tracker.trajectory[HOST_MONO_RETURN]
        direct = reloc_direct(sysm, *depth_free(sysm, frames[
            HOST_MONO_RETURN]), np.asarray(R12), np.asarray(t12))
        direct.update({k: reloc_calls(rec)[0][k] for k in keys[2:]})
        out.update(direct_epnp=direct, failed=host_mono_failures(out))
    else:
        quad = synthetic.make_walker(**HOST_FLOW_WALKER, **(
            {} if pkg == "jax" else {"device": "cpu"}))
        poses = synthetic.camera_trajectory(**HOST_FLOW_ORBIT)[:N_HOST_FLOW]
        if pkg == "jax":
            render = jax.jit(lambda p, i: synthetic.render(
                cfg.camera, p, planes, quad, i)[:3])
            frames = host_flow_frames(
                lambda p, i: render(p, jnp.asarray(i, jnp.float32)), poses)
        else:
            frames = host_flow_frames(lambda p, i: synthetic.render(
                cfg.camera, p, planes, quad, i)[:3], poses)
        sysm = make(cfg)
        flags = []
        if pkg == "jax":
            orig = sysm._jit_dynamic

            def kept(*a):
                r = orig(*a)
                flags.append(bool(r.box_dynamic[0]))
                return r

            sysm._jit_dynamic = kept
        else:
            orig = sysm._flow_check

            def kept(*a):
                r = orig(*a)
                flags.append(bool(r.box_dynamic[0]))
                return r

            sysm._flow_check = kept
        states = run_host_flow(sysm, frames)
        # The first frame has no previous image: the k-th check is on
        # frame k.
        out.update(host_flow_summary(
            sysm, states, pose_centres(poses), ate,
            [k + 1 for k, f in enumerate(flags) if f]))
        out["failed"] = host_flow_failures(out)
    out.update(track_s=time.time() - t0, full=full)
    return out


def _mono_loop(sysm, ate, GlobalBA, gt, pkg):
    """[20] on a System that ran [21]'s scene (host_sensor_scenes.
    run_mono_loop), with the closure's stages (host ms)."""
    lc = sysm.loop_closer
    lc._global_ba = GlobalBA(sysm.cfg) if pkg == "jax" \
        else GlobalBA(sysm.cfg, device="cpu")
    rec = watch_calls([], lc, ("compute_sim3", "correct", "run_pose_graph"))
    watch_calls(rec, lc._global_ba, ("run",))
    out = run_mono_loop(sysm, ate, lambda k: gt[host_mono_frame_of(
        round(sysm.map.kf_stamp[k] * 30), HOST_EPNP_TRACK,
        HOST_EPNP_RETURN)])
    out.pop("S", None)
    out["stages"] = [{k: v for k, v in c.items() if k != "sites"}
                     for c in closure_stages(rec)]
    return out


def run_jax_sensor(scene, n=None):
    """[11] or [12] on the JAX package: the scene of tests/test_stereo_wide.py
    or tests/test_realtime_mono.py at full width (its first ``n``
    frames)."""
    import jax
    import jax.numpy as jnp
    from coebslam_tpu import config
    from coebslam_tpu.eval import ate
    from coebslam_tpu.geometry.se3 import SE3
    from coebslam_tpu.ops import initializer_ops
    from coebslam_tpu.slam.realtime import RealtimeSlam
    from coebslam_tpu.utils import replica, synthetic
    planes = synthetic.make_room(seed=0)
    if scene == "mono":
        cfg = mono_config(config)
        poses = synthetic.camera_trajectory(N_MONO, radius=MONO_RADIUS)[:n]
        render = jax.jit(lambda p: synthetic.render(cfg.camera, p, planes)[0])
        attempts = []
        orig = initializer_ops.reconstruct_graph

        def logged(*a, **kw):
            r = orig(*a, **kw)
            jax.debug.callback(
                lambda ok, h, n: attempts.append(
                    {"ok": bool(ok), "homography": bool(h),
                     "good": int(n)}), r.ok, r.used_homography, r.good.sum())
            return r

        initializer_ops.reconstruct_graph = logged
        rt = RealtimeSlam(cfg)
        for i, p in enumerate(poses):
            rt.track_mono(np.asarray(render(p)), stamp=i / 30.0)
    else:
        cfg = stereo_config(config)
        walker = synthetic.make_walker(**STEREO_WALKER)
        poses = replica.walking_trajectory(N_STEREO, seed=3)[:n]
        b = cfg.camera.baseline
        render = jax.jit(lambda p, i: synthetic.render(
            cfg.camera, p, planes, walker, i)[:3])
        rt = RealtimeSlam(cfg)
        for i, p in enumerate(poses):
            gl, _, box = render(p, jnp.asarray(i, jnp.float32))
            t_r = np.asarray(p.t) - np.asarray([b, 0.0, 0.0], np.float32)
            gr = render(SE3(p.R, jnp.asarray(t_r)),
                        jnp.asarray(i, jnp.float32))[0]
            gl, gr = np.asarray(gl), np.asarray(gr)
            if stereo_blurred(i):
                gl = replica._box_blur(gl, STEREO_BLUR[2])
                gr = replica._box_blur(gr, STEREO_BLUR[2])
            boxes = np.asarray(box)[None]
            rt.track_stereo(gl.astype(np.float32), gr.astype(np.float32),
                            stamp=i / 30.0,
                            boxes=boxes if boxes[0, 0] >= 0 else None)
    rt.block()
    gt = np.asarray([-np.asarray(p.R).T @ np.asarray(p.t) for p in poses])
    out = _sensor_summary(rt.finish(), gt, ate, scene == "mono")
    if scene == "mono":
        out["init_attempts"] = attempts
    return out


def run_jax(scene, refine, n=None):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    if scene == "host-replica":
        return run_host_replica("jax", n)
    if scene == "driver-rt":
        return run_driver_rt("jax", n)
    if scene.startswith(("host-loop", "host-reloc")):
        return run_host_bow("jax", scene)
    if scene.startswith(("host-stereo", "host-mono", "host-flow",
                         "host-epnp")):
        return run_host_sensor("jax", scene)
    if scene.startswith("rt-bank"):
        return run_rt_bank("jax", scene)
    if scene in ("stereo", "mono"):
        return run_jax_sensor(scene, n)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from coebslam_tpu import config
    from coebslam_tpu.config import SystemConfig
    from coebslam_tpu.eval import ate
    from coebslam_tpu.models import detector
    from coebslam_tpu.slam import handoff, vocabulary
    from coebslam_tpu.slam.global_ba import GlobalBA
    from coebslam_tpu.slam.realtime import RealtimeSlam, RTLimits
    from coebslam_tpu.utils import synthetic
    if scene in ("orbit", "selfdetect"):
        cfg = SystemConfig()
        planes = synthetic.make_room(seed=0)
        walker = synthetic.make_walker(start=(-0.9, -0.2, 1.8),
                                       velocity=(0.012, 0.004, 0.0),
                                       half_w=0.3, half_h=0.65)
        poses = synthetic.camera_trajectory(N_ORBIT, radius=0.35)
        render = jax.jit(lambda p, i: synthetic.render(
            cfg.camera, p, planes, walker, i)[:3])
        frames = []
        for i, p in enumerate(poses):
            g, d, b = render(p, jnp.asarray(i, jnp.float32))
            frames.append((np.clip(np.asarray(g), 0, 255).astype(np.uint8),
                           (np.asarray(d) * cfg.camera.depth_map_factor)
                           .astype(np.uint16), np.asarray(b)[None]))
        c = np.asarray([-np.asarray(p.R).T @ np.asarray(p.t) for p in poses])
        if scene == "selfdetect":
            det = walker_detector(config, detector, cfg.dynamic)
            rt = RealtimeSlam(cfg, detector=det, detect_every=DETECT_EVERY)
            frames = frames[:N_SELFDETECT]
            for i, (g, d, _) in enumerate(frames):
                rt.track(g, d, stamp=i / 30.0)
            rt.block()
            out = _summary(rt, rt.finish(), [], c[:N_SELFDETECT], ate, 0)
            gray = [f[0] for f in frames]
            out.update(detections=-(-N_SELFDETECT // DETECT_EVERY),
                       box_iou=mean_best_iou(det.detect, gray,
                                             [f[2] for f in frames]))
            return out
        rt = RealtimeSlam(cfg, vocabulary=vocabulary.load(VOCAB),
                          maintain_every=8)
        seen = _watch_dispatches(rt)
        for i in range(2 * N_ORBIT):
            g, d, b = frames[i % N_ORBIT]
            rt.track(g, d, stamp=i / 30.0, boxes=b)
        rt.block()
        gt = np.tile(c, (2, 1))
    else:
        from test_loop_e2e import (DEPTH_BIAS, N_CIRCUIT, N_OVERLAP,
                                   circuit_poses, six_wall_room)
        cfg = circuit_config(config)
        lim = RTLimits(**CIRCUIT_LIMITS)
        if scene == "circuit":
            sched, bias, every = range(N_CIRCUIT + N_OVERLAP), DEPTH_BIAS, 1
        else:
            sched, bias, every = KIDNAP, 1.0, 2
        poses = circuit_poses(max(sched) + 1)
        planes = six_wall_room()
        render = jax.jit(lambda p: synthetic.render(cfg.camera, p,
                                                    planes)[:2])
        rt = RealtimeSlam(cfg, lim, vocabulary=vocabulary.load(VOCAB),
                          maintain_every=every)
        seen = _watch_dispatches(rt)
        for k, i in enumerate(sched):
            g, d = render(poses[i])
            rt.track(np.asarray(g), np.asarray(d) * bias, stamp=k / 30.0)
        rt.block()
        gt = np.asarray([-np.asarray(poses[i].R).T @ np.asarray(poses[i].t)
                         for i in sched])
    res = rt.finish()
    if refine:
        return _refine(res, cfg, gt, ate, handoff, GlobalBA(cfg))
    return _summary(rt, res, seen, gt, ate,
                    {"orbit": 0, "circuit": 8, "kidnap": 5}[scene])


def run_port(scene, refine, n=None):
    sys.path.insert(0, ROOT)
    import torch
    from coebslam_tpu_torch import config
    from coebslam_tpu_torch.eval import ate
    from coebslam_tpu_torch.models import detector
    from coebslam_tpu_torch.slam import handoff, vocabulary
    from coebslam_tpu_torch.slam.global_ba import GlobalBA
    from coebslam_tpu_torch.slam.realtime import RealtimeSlam, RTLimits
    from coebslam_tpu_torch.utils import replica, synthetic
    if scene == "host-replica":
        return run_host_replica("port", n)
    if scene == "driver-rt":
        return run_driver_rt("port", n)
    if scene == "png":
        return run_png()
    if scene.startswith(("host-loop", "host-reloc")):
        return run_host_bow("port", scene)
    if scene.startswith(("host-stereo", "host-mono", "host-flow",
                         "host-epnp")):
        return run_host_sensor("port", scene)
    if scene.startswith("rt-bank"):
        return run_rt_bank("port", scene)
    if scene == "stereo":
        cfg = stereo_config(config)
        frames, gt = stereo_scene(torch, synthetic, replica, cfg.camera,
                                  "cpu", n or N_STEREO)
        rt = RealtimeSlam(cfg, device="cpu")
        for i, (gl, gr, b) in enumerate(frames):
            rt.track_stereo(gl, gr, stamp=i / 30.0, boxes=b)
        return _sensor_summary(rt.finish(), gt, ate, False)
    if scene == "mono":
        cfg = mono_config(config)
        frames, gt = mono_scene(synthetic, cfg.camera, "cpu", n or N_MONO)
        rt = RealtimeSlam(cfg, device="cpu")
        for i, g in enumerate(frames):
            rt.track_mono(g, stamp=i / 30.0)
        res = rt.finish()
        out = _sensor_summary(res, gt, ate, True)
        out["init_attempts"] = res["init_attempts"]
        return out
    if scene == "selfdetect":
        cfg = config.SystemConfig()
        G, D, B, C = synthetic.dynamic_orbit(cfg.camera, N_ORBIT,
                                             device="cpu")
        det = walker_detector(config, detector, cfg.dynamic, device="cpu")
        rt = RealtimeSlam(cfg, device="cpu", detector=det,
                          detect_every=DETECT_EVERY)
        for i in range(N_SELFDETECT):
            rt.track(G[i], D[i], stamp=i / 30.0)
        out = _summary(rt, rt.finish(), [], C[:N_SELFDETECT], ate, 0)
        out.update(detections=det.dispatches,
                   box_iou=mean_best_iou(det.detect, G[:N_SELFDETECT],
                                         B[:N_SELFDETECT]))
        return out
    cfg = circuit_config(config)
    lim = RTLimits(**CIRCUIT_LIMITS)
    if scene == "circuit":
        sched = range(synthetic.N_CIRCUIT + synthetic.N_OVERLAP)
        bias, every = synthetic.DEPTH_BIAS, 1
    else:
        sched, bias, every = KIDNAP, 1.0, 2
    planes = synthetic.six_wall_room(device="cpu")
    poses = synthetic.circuit_poses(max(sched) + 1)
    rt = RealtimeSlam(cfg, lim, device="cpu",
                      vocabulary=vocabulary.load(VOCAB),
                      maintain_every=every)
    seen = _watch_dispatches(rt)
    for k, i in enumerate(sched):
        g, d = synthetic.render(cfg.camera, poses[i], planes)[:2]
        rt.track(g, d * bias, stamp=k / 30.0)
    gt = np.asarray([-poses[i].R.numpy().T @ poses[i].t.numpy()
                     for i in sched])
    res = rt.finish()
    if refine:
        return _refine(res, cfg, gt, ate, handoff, GlobalBA(cfg, device="cpu"))
    return _summary(rt, res, seen, gt, ate, 8 if scene == "circuit" else 5)


def run_rt_bank(pkg, scene):
    """[19] (``rt-bank-loop``, ``rt-bank-reloc``) on either package: the
    drifted circuit with the 8-row ring of rt_loop_scenes.BANK_LIMITS and
    the scene's own vocabulary (tests/test_place_bank.py). The JAX package
    renders and extracts with its own code, the port with its own on the
    CPU, as the card does."""
    loop = scene == "rt-bank-loop"
    if pkg == "jax":
        import jax
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from coebslam_tpu import config
        from coebslam_tpu.eval import ate
        from coebslam_tpu.ops import extractor
        from coebslam_tpu.slam import vocabulary as voc_mod
        from coebslam_tpu.slam.realtime import RealtimeSlam, RTLimits
        from coebslam_tpu.utils import synthetic
        from test_loop_e2e import (DEPTH_BIAS, N_CIRCUIT, N_OVERLAP,
                                   circuit_poses, six_wall_room)
        cfg = circuit_config(config)
        planes = six_wall_room()
        poses = circuit_poses(N_CIRCUIT + N_OVERLAP)
        render = jax.jit(lambda p: synthetic.render(cfg.camera, p,
                                                    planes)[:2])
        frames = [(np.asarray(g), np.asarray(d) * DEPTH_BIAS)
                  for g, d in map(render, poses)]
        gt = np.asarray([-np.asarray(p.R).T @ np.asarray(p.t)
                         for p in poses])
        ex = jax.jit(lambda g: extractor.extract(g, cfg.orb))
        make = RealtimeSlam
        black = (np.zeros_like(frames[0][0]), np.zeros_like(frames[0][1]))
    else:
        import torch
        from coebslam_tpu_torch import config
        from coebslam_tpu_torch.eval import ate
        from coebslam_tpu_torch.ops import extractor
        from coebslam_tpu_torch.slam import vocabulary as voc_mod
        from coebslam_tpu_torch.slam.realtime import RealtimeSlam, RTLimits
        from coebslam_tpu_torch.utils import synthetic
        N_CIRCUIT, N_OVERLAP = synthetic.N_CIRCUIT, synthetic.N_OVERLAP
        cfg = circuit_config(config)
        frames, gt = loop_scene("cpu", range(N_CIRCUIT + N_OVERLAP),
                                synthetic.DEPTH_BIAS, synthetic, cfg.camera)
        ex = lambda g: extractor.extract(g, cfg.orb)
        make = lambda *a, **kw: RealtimeSlam(*a, device="cpu", **kw)
        black = (torch.zeros_like(frames[0][0]),
                 torch.zeros_like(frames[0][1]))
    descs = []
    for i in bank_vocab_frames(N_CIRCUIT):
        f = ex(frames[i][0])
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    voc = scene_vocabulary(voc_mod, descs, **BANK_VOCAB)
    lim = RTLimits(**BANK_LIMITS)
    t0 = time.time()
    if loop:
        res = run_realtime(make(cfg, lim, vocabulary=voc, maintain_every=1),
                           frames)
        res_odo = run_realtime(make(cfg, lim, maintain_every=1), frames)
        out = bank_loop_summary(res, res_odo, gt, N_CIRCUIT, N_OVERLAP, ate)
        out["failed"] = bank_loop_failures(out, lim.max_kf)
    else:
        res = run_bank_reloc(make(cfg, lim, vocabulary=voc,
                                  maintain_every=1), frames, black,
                             N_CIRCUIT // 2)
        out = bank_reloc_summary(res)
        out["failed"] = bank_reloc_failures(out)
    out.update(voc_words=int(voc.n_words), track_s=time.time() - t0,
               loop_events=res["loop_events"])
    return out


REPLICA_SCENES = {"closure-replica": "closure", "replica-maint": "maint",
                  "two-walkers": "walkers"}


def run_replica_row(pkg, scene, n=None):
    """[22] (``replica_rows.py``) on either package at ``n`` frames: the
    row's summary, and for ``closure-replica`` its odometry twin's."""
    import replica_rows as rr
    row = REPLICA_SCENES[scene]
    n = n or rr.FULL[row]
    rows = [row] + (["twin"] if row == "closure" else [])
    if pkg == "port":
        import torch
        torch.set_num_threads(4)
        return {r: rr.run_row(r, n, "cpu") for r in rows}
    return {r: _jax_replica_row(rr, r, n) for r in rows}


def _jax_replica_row(rr, row, n):
    """One ``replica_rows`` row through the JAX package: its replica
    written and read back as bench.py's ``_load_replica`` does."""
    import tempfile
    import types
    from coebslam_tpu.config import SystemConfig
    from coebslam_tpu.eval import ate
    from coebslam_tpu.io import tum
    from coebslam_tpu.slam import handoff, vocabulary
    from coebslam_tpu.slam.realtime import RealtimeSlam
    from coebslam_tpu.utils import replica
    cfg = SystemConfig()
    kw = rr.schedule(row, n)
    kw.pop("frames", None)
    root = tempfile.mkdtemp(prefix=f"replica_{row}_")
    replica.generate(root, **kw)
    seq = tum.load_tum_sequence(root)
    bstamps, bboxes = replica.load_boxes(os.path.join(root, "boxes.txt"),
                                         max_boxes=cfg.dynamic.max_boxes)
    frames = []
    for i in range(n):
        stamp, gray, depth = seq.load_frame_raw(i)
        b = np.zeros((0, 4), np.float32)
        if len(bstamps):
            j = int(np.argmin(np.abs(bstamps - stamp)))
            if abs(bstamps[j] - stamp) < 0.03:
                b = bboxes[j][bboxes[j][:, 0] >= 0]
        frames.append(types.SimpleNamespace(stamp=stamp, gray=gray,
                                            depth=depth, boxes=b))
    stamps, gt = seq.gt_stamps[:n], seq.gt_poses[:n, :3]
    voc = vocabulary.load(rr.VOCAB) if row in ("closure", "maint") else None
    every = rr.CLOSURE_MAINTAIN_EVERY if row == "closure" else rr.MAINT_EVERY
    rt = RealtimeSlam(cfg, vocabulary=voc, maintain_every=every)
    seconds = rr.track(rt, row, frames)
    res = rt.finish()
    out = rr.summary(row, res, frames, stamps, gt, ate, seconds)
    if row == "maint":
        t0 = time.perf_counter()
        m, kf_ids, n_opt = handoff.refine(res, SystemConfig())
        traj = handoff.refined_trajectory(res, m, kf_ids)
        out.update(refined_ate_m=rr._ate(ate, res, stamps, gt,
                                         [P[:, :3] for P in traj],
                                         [P[:, 3] for P in traj]),
                   kf_refined=int(n_opt),
                   refine_s=time.perf_counter() - t0)
    return out


def run_jax_train_detector(steps: int) -> dict:
    """The JAX tool's training run (see ``train-detector`` above)."""
    import re
    import subprocess
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "train_detector.py"),
             "--width", "0.25", "--cpu", "--steps", str(steps), "--out",
             os.path.join(tmp, "detector.npz")],
            capture_output=True, text=True, cwd=ROOT)
    if proc.returncode != 0:
        sys.exit(proc.stdout + proc.stderr)
    miou = re.search(r"held-out mean IoU vs GT: ([0-9.]+) over (\d+)",
                     proc.stdout)
    return {"width": 0.25, "steps": steps,
            "losses": {int(k): float(v) for k, v in re.findall(
                r"step (\d+): loss ([0-9.]+)", proc.stdout)},
            "miou": float(miou.group(1)), "n_boxes": int(miou.group(2))}


def run_train_curve(pkg: str, steps: int) -> dict:
    """``train-curve``: every step's loss and terms (see above)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        if pkg == "port":
            from coebslam_tpu_torch.tools import train_detector
            r = train_detector.run(train_detector.parse_args(
                ["--width", "0.25", "--steps", str(steps), "--cpu", "--out",
                 os.path.join(tmp, "detector.npz")]))
            losses, terms, miou = r["losses"], r["terms"].tolist(), r["miou"]
        else:
            losses, terms, miou = _jax_train_curve(steps, tmp)
    worst = int(np.argmax(losses))
    return {"width": 0.25, "steps": steps, "losses": losses, "terms": terms,
            "terms_order": ["obj", "cls", "xy", "wh"],
            "max_loss": losses[worst], "max_step": worst,
            "max_terms": terms[worst], "miou": miou,
            "logged": {s: losses[s] for s in
                       sorted(set(range(0, steps, 100)) | {steps - 1})}}


def _jax_train_curve(steps, tmp):
    """The JAX tool's training (tools/train_detector.py ``main`` at
    ``--width 0.25 --cpu``) with every step's loss and terms; its
    ``loss_fn`` transcribed with the terms as an auxiliary output."""
    import importlib.util
    import jax
    import jax.numpy as jnp
    import optax
    from coebslam_tpu.config import DetectorConfig, SystemConfig
    from coebslam_tpu.models import yolov5
    from coebslam_tpu.models.detector import YoloDetector
    spec = importlib.util.spec_from_file_location(
        "jax_train_detector", os.path.join(ROOT, "tools",
                                           "train_detector.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    cache = os.path.join(tmp, "dataset.npz")
    tool.render_dataset(cache)
    z = np.load(cache)
    G, B = z["g"], z["b"]
    n, n_val, width = len(G), 30, 0.25
    cam_h, cam_w = G.shape[1:3]
    model = yolov5.YoloV5s(num_classes=1, width_mult=width, depth_mult=0.33)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros(
        (1, tool.INPUT, tool.INPUT, 3)))
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}
    imgs = np.zeros((n, tool.INPUT, tool.INPUT, 3), np.float32)
    for i in range(n):
        im = jax.image.resize(jnp.asarray(G[i], jnp.float32),
                              (tool.INPUT, tool.INPUT), "linear") / 255.0
        imgs[i] = np.asarray(jnp.stack([im, im, im], -1))
    tgts = [tool.build_targets_np(B[i], cam_w, cam_h) for i in range(n)]
    levels = len(tgts[0])
    T = [tuple(np.stack([tgts[i][lvl][j] for i in range(n)])
               for j in range(4)) for lvl in range(levels)]

    def loss_fn(params, img, tgt):
        raw = model.apply({"params": params, **rest}, img)
        total, parts = 0.0, jnp.zeros(4)
        for lvl in range(levels):
            obj_t, xy_t, wh_t, mask = tgt[lvl]
            sig = jax.nn.sigmoid(raw[lvl])
            bce = optax.sigmoid_binary_cross_entropy(raw[lvl][..., 4], obj_t)
            wpos = 1.0 + 200.0 * obj_t
            m = mask[..., None]
            obj = (bce * wpos).mean()
            xy = 8.0 * (jnp.where(m, (sig[..., 0:2] - xy_t) ** 2,
                                  0.0).sum() / (m.sum() + 1.0))
            wh = 8.0 * (jnp.where(m, (sig[..., 2:4] - wh_t) ** 2,
                                  0.0).sum() / (m.sum() + 1.0))
            cls = (optax.sigmoid_binary_cross_entropy(
                raw[lvl][..., 5], obj_t) * wpos).mean()
            total += obj
            total += xy
            total += wh
            total += cls
            parts = parts + jnp.stack([obj, cls, xy, wh])
        return total, parts

    tx = optax.adam(2e-3)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, img, tgt):
        (loss, parts), g = jax.value_and_grad(loss_fn, has_aux=True)(
            params, img, tgt)
        updates, opt_state = tx.update(g, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss, parts

    rng = np.random.RandomState(0)
    losses, terms = [], []
    for it in range(steps):
        idx = rng.randint(0, n - n_val, size=8)
        tgt = [tuple(jnp.asarray(a[idx]) for a in T[lvl])
               for lvl in range(levels)]
        params, opt_state, loss, parts = step(params, opt_state,
                                              jnp.asarray(imgs[idx]), tgt)
        losses.append(float(loss))
        terms.append(np.asarray(parts).astype(float).tolist())
    dcfg = DetectorConfig(width_multiple=width, num_classes=1,
                          input_size=tool.INPUT, conf_threshold=0.4)
    det = YoloDetector(dcfg, SystemConfig().dynamic,
                       variables={"params": params, **rest})
    from coebslam_tpu_torch.tools.train_detector import mean_iou
    miou = mean_iou(lambda g: np.asarray(det.detect(g)), G[n - n_val:],
                    B[n - n_val:])[0]
    return losses, terms, miou


def main():
    args = sys.argv[1:]
    if len(args) in (2, 3) and args[0] in ("jax", "port") \
            and args[1] == "train-curve":
        t0 = time.time()
        out = run_train_curve(args[0], int(args[2]) if len(args) == 3
                              else 700)
        out.update(package=args[0], scene="train-curve",
                   seconds=time.time() - t0)
        print(json.dumps(out))
        return
    if args[:2] == ["jax", "train-detector"] and len(args) <= 3:
        t0 = time.time()
        out = run_jax_train_detector(int(args[2]) if len(args) == 3
                                     else 700)
        out.update(package="jax", scene="train-detector",
                   seconds=time.time() - t0)
        print(json.dumps(out))
        return
    if args == ["jax", "rt-bank-snapshot"]:
        t0 = time.time()
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from test_torch_place_bank_parity import SNAPSHOT, \
            save_closing_snapshot
        k = save_closing_snapshot()
        print(json.dumps({"package": "jax", "scene": "rt-bank-snapshot",
                          "dispatch": k, "path": os.path.relpath(SNAPSHOT),
                          "bytes": os.path.getsize(SNAPSHOT),
                          "seconds": time.time() - t0}))
        return
    if len(args) in (2, 3) and args[0] in ("jax", "port") \
            and args[1] in REPLICA_SCENES \
            and (len(args) == 2 or args[2].isdigit()):
        t0 = time.time()
        out = run_replica_row(args[0], args[1],
                              int(args[2]) if len(args) == 3 else None)
        out.update(package=args[0], scene=args[1], seconds=time.time() - t0)
        print(json.dumps(out))
        return
    refine = len(args) == 3 and args[1] == "refine"
    if refine:
        args = [args[0], args[2]]
    n = None
    if len(args) == 3 and args[1] in ("stereo", "mono", "host-replica",
                                      "driver-rt") \
            and args[2].isdigit():
        n = int(args.pop())
    if len(args) != 2:
        sys.exit(__doc__)
    pkg, scene = args
    scenes = ("orbit", "circuit") if refine else (
        "orbit", "circuit", "kidnap", "selfdetect", "stereo", "mono",
        "host-replica", "driver-rt", "png", "host-loop",
        "host-reloc", "host-loop-full",
        "host-reloc-full", "rt-bank-loop", "rt-bank-reloc",
        "host-epnp-reloc", "host-mono-loop") + tuple(
            f"host-{k}{f}" for k in ("stereo", "mono", "flow")
            for f in ("", "-full"))
    if pkg not in ("jax", "port") or scene not in scenes \
            or (pkg, scene) in (("port", "orbit"), ("jax", "png")):
        sys.exit(__doc__)
    t0 = time.time()
    out = (run_jax if pkg == "jax" else run_port)(scene, refine, n)
    out.update(package=pkg, scene=scene, refine=refine, n_frames=n,
               seconds=time.time() - t0)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

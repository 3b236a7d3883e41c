"""CPU reference runs of the scenes of ``chip_smoke.py``.

Run from the repository root:

    python3 cpu_reference.py jax {orbit,circuit,kidnap,selfdetect}
    python3 cpu_reference.py jax refine {orbit,circuit}
    python3 cpu_reference.py port {circuit,kidnap,selfdetect}
    python3 cpu_reference.py port refine circuit

Drives one package on the CPU over one scene at the configuration of the
matching ``chip_smoke.py`` phase, and prints one JSON line with seconds:

- ``orbit``, ``circuit``, ``kidnap`` ([4], [6], [7]), with
  ``artifacts/vocab_1e5.npz``: ATE (all frames; ``tail_ate_m`` over the
  last 8 frames of the circuit or the last 5 of the kidnap), frames
  tracked, loops closed and the event log, relocalizations, bank entries,
  keyframes, the keyframes processed (``bow_next``) and the keyframe count
  at the last dispatch.
- ``selfdetect`` ([8]): one pass of the dynamic orbit with no
  ground-truth boxes, ``RealtimeSlam(detector=, detect_every=3)`` on
  ``artifacts/detector_walker.npz``: ATE, frames tracked, keyframes,
  detections dispatched and the mean best box IoU on every 10th frame.
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

from chip_smoke import (CIRCUIT_LIMITS, DETECT_EVERY, circuit_config,
                        mean_best_iou, refine_report, walker_detector)

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


def run_jax(scene, refine):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
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
            for i, (g, d, _) in enumerate(frames):
                rt.track(g, d, stamp=i / 30.0)
            rt.block()
            out = _summary(rt, rt.finish(), [], c, ate, 0)
            gray = [f[0] for f in frames]
            out.update(detections=-(-N_ORBIT // DETECT_EVERY),
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


def run_port(scene, refine):
    sys.path.insert(0, ROOT)
    from coebslam_tpu_torch import config
    from coebslam_tpu_torch.eval import ate
    from coebslam_tpu_torch.models import detector
    from coebslam_tpu_torch.slam import handoff, vocabulary
    from coebslam_tpu_torch.slam.global_ba import GlobalBA
    from coebslam_tpu_torch.slam.realtime import RealtimeSlam, RTLimits
    from coebslam_tpu_torch.utils import synthetic
    if scene == "selfdetect":
        cfg = config.SystemConfig()
        G, D, B, C = synthetic.dynamic_orbit(cfg.camera, N_ORBIT,
                                             device="cpu")
        det = walker_detector(config, detector, cfg.dynamic, device="cpu")
        rt = RealtimeSlam(cfg, device="cpu", detector=det,
                          detect_every=DETECT_EVERY)
        for i in range(N_ORBIT):
            rt.track(G[i], D[i], stamp=i / 30.0)
        out = _summary(rt, rt.finish(), [], C, ate, 0)
        out.update(detections=det.dispatches,
                   box_iou=mean_best_iou(det.detect, G, B))
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


def main():
    args = sys.argv[1:]
    refine = len(args) == 3 and args[1] == "refine"
    if refine:
        args = [args[0], args[2]]
    if len(args) != 2:
        sys.exit(__doc__)
    pkg, scene = args
    scenes = ("orbit", "circuit") if refine else (
        "orbit", "circuit", "kidnap", "selfdetect")
    if pkg not in ("jax", "port") or scene not in scenes \
            or (pkg, scene) == ("port", "orbit"):
        sys.exit(__doc__)
    t0 = time.time()
    out = (run_jax if pkg == "jax" else run_port)(scene, refine)
    out.update(package=pkg, scene=scene, refine=refine,
               seconds=time.time() - t0)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

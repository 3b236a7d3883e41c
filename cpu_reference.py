"""CPU reference runs of the maintained scenes of ``chip_smoke.py``.

Run from the repository root:

    python3 cpu_reference.py jax {orbit,circuit,kidnap}
    python3 cpu_reference.py port {circuit,kidnap}

Drives one package on the CPU over one scene, with ``artifacts/
vocab_1e5.npz``, at the configuration of the matching ``chip_smoke.py``
phase ([4] orbit, [6] circuit, [7] kidnap), and prints one JSON line: ATE
(all frames; ``tail_ate_m`` over the last 8 frames of the circuit or the
last 5 of the kidnap), frames tracked, loops closed and the event log,
relocalizations, bank entries, keyframes, the keyframes processed
(``bow_next``) and the keyframe count at the last dispatch, and seconds.
The configurations are ``chip_smoke.py``'s. The ``jax`` runs give
the JAX-package references that ``chip_smoke.py`` prints beside its own
results (``JAX_CPU_*``). The full-width orbit takes several minutes per
package; ``port`` does not run it.
"""
import json
import os
import sys
import time

import numpy as np

from chip_smoke import CIRCUIT_LIMITS, circuit_config

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


def _summary(rt, seen, gt, ate, tail):
    res = rt.finish()
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
    out.update({k: res[k] for k in REPORT})
    out.update(bow_next=int(rt.mstate.bow_next),
               n_kf_at_last_dispatch=seen[-1] if seen else None)
    return out


def run_jax(scene):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from coebslam_tpu import config
    from coebslam_tpu.config import SystemConfig
    from coebslam_tpu.eval import ate
    from coebslam_tpu.slam import vocabulary
    from coebslam_tpu.slam.realtime import RealtimeSlam, RTLimits
    from coebslam_tpu.utils import synthetic
    voc = vocabulary.load(VOCAB)
    if scene == "orbit":
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
        rt = RealtimeSlam(cfg, vocabulary=voc, maintain_every=8)
        seen = _watch_dispatches(rt)
        for i in range(2 * N_ORBIT):
            g, d, b = frames[i % N_ORBIT]
            rt.track(g, d, stamp=i / 30.0, boxes=b)
        rt.block()
        c = np.asarray([-np.asarray(p.R).T @ np.asarray(p.t) for p in poses])
        return _summary(rt, seen, np.tile(c, (2, 1)), ate, 0)
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
    render = jax.jit(lambda p: synthetic.render(cfg.camera, p, planes)[:2])
    rt = RealtimeSlam(cfg, lim, vocabulary=voc, maintain_every=every)
    seen = _watch_dispatches(rt)
    for k, i in enumerate(sched):
        g, d = render(poses[i])
        rt.track(np.asarray(g), np.asarray(d) * bias, stamp=k / 30.0)
    rt.block()
    gt = np.asarray([-np.asarray(poses[i].R).T @ np.asarray(poses[i].t)
                     for i in sched])
    return _summary(rt, seen, gt, ate, 8 if scene == "circuit" else 5)


def run_port(scene):
    sys.path.insert(0, ROOT)
    from coebslam_tpu_torch import config
    from coebslam_tpu_torch.eval import ate
    from coebslam_tpu_torch.slam import vocabulary
    from coebslam_tpu_torch.slam.realtime import RealtimeSlam, RTLimits
    from coebslam_tpu_torch.utils import synthetic
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
    return _summary(rt, seen, gt, ate, 8 if scene == "circuit" else 5)


def main():
    pkg, scene = sys.argv[1:3]
    if pkg not in ("jax", "port") or scene not in ("orbit", "circuit",
                                                   "kidnap") \
            or (pkg, scene) == ("port", "orbit"):
        sys.exit(__doc__)
    t0 = time.time()
    out = (run_jax if pkg == "jax" else run_port)(scene)
    out.update(package=pkg, scene=scene, seconds=time.time() - t0)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

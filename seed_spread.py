"""ATE spread of the realtime path over RANSAC seeds, per package, on the CPU.

Run from the repository root:

    python3 seed_spread.py {jax,port} {room,mono} [--seeds 8]

Each run drives one package's ``RealtimeSlam`` over one short scene with
its own frame renderer, once per seed, and prints one JSON line per seed
and a last line with the mean, standard deviation, minimum and maximum of
the ATE. The seed is the session's first per-frame RANSAC seed
(``RealtimeSlam._seed``, 1000 apart): the JAX package turns it into
``jax.random.PRNGKey``s, the port into a ``torch.Generator``'s seed, so
the two distributions hold the same scene under each package's own draws.

- ``room``: the 40-frame room of ``tests/test_realtime.py`` at full width
  (``SystemConfig()``, ``RTLimits(max_kf=16)``) with the dynamic orbit's
  walker in it and its ground-truth box given on every frame, so the
  F-RANSAC draws reach the box classification.
- ``mono``: the monocular orbit of ``tests/test_realtime_mono.py`` (4
  levels, 1024 keypoints, radius 0.8, 60 frames); the draws are the
  two-view initialiser's. ATE is Sim3-aligned over the tracked frames.
"""
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_ROOM = 40
N_MONO = 60
WALKER = dict(start=(-0.9, -0.2, 1.8), velocity=(0.012, 0.004, 0.0),
              half_w=0.3, half_h=0.65)
MONO_LIMITS = dict(max_kf=16, spawn_per_kf=256, ba_window=6, local_window=6,
                   max_frames=128)


def mono_config(config):
    return config.SystemConfig(
        camera=config.CameraConfig(),
        orb=config.OrbConfig(max_keypoints=1024, n_levels=4, n_features=1000),
        tracking=config.TrackingConfig(max_frames_between_kf=10),
        sensor="monocular", use_dynamic_filtering=False)


def _frames_jax(scene, cfg):
    import jax
    import jax.numpy as jnp
    from coebslam_tpu.utils import synthetic
    planes = synthetic.make_room(seed=0)
    if scene == "room":
        poses = synthetic.camera_trajectory(N_ROOM, radius=0.35)
        walker = synthetic.make_walker(**WALKER)
        render = jax.jit(lambda p, i: synthetic.render(
            cfg.camera, p, planes, walker, i)[:3])
        out = []
        for i, p in enumerate(poses):
            g, d, b = render(p, jnp.asarray(i, jnp.float32))
            out.append((np.asarray(g), np.asarray(d), np.asarray(b)[None]))
    else:
        poses = synthetic.camera_trajectory(N_MONO, radius=0.8)
        render = jax.jit(lambda p: synthetic.render(cfg.camera, p, planes)[0])
        out = [(np.asarray(render(p)), None, None) for p in poses]
    gt = np.asarray([-np.asarray(p.R).T @ np.asarray(p.t) for p in poses])
    return out, gt


def _frames_port(scene, cfg):
    from coebslam_tpu_torch.utils import synthetic
    planes = synthetic.make_room(seed=0, device="cpu")
    if scene == "room":
        poses = synthetic.camera_trajectory(N_ROOM, radius=0.35)
        walker = synthetic.make_walker(**WALKER, device="cpu")
        out = []
        for i, p in enumerate(poses):
            g, d, b, _ = synthetic.render(cfg.camera, p, planes, walker, i)
            out.append((g.numpy(), d.numpy(), b.numpy()[None]))
    else:
        poses = synthetic.camera_trajectory(N_MONO, radius=0.8)
        out = [(synthetic.render(cfg.camera, p, planes)[0].numpy(), None,
                None) for p in poses]
    gt = np.asarray([-p.R.numpy().T @ p.t.numpy() for p in poses])
    return out, gt


def run(pkg, scene, seeds):
    if pkg == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from coebslam_tpu import config
        from coebslam_tpu.eval import ate
        from coebslam_tpu.slam.realtime import RealtimeSlam, RTLimits
        make = lambda cfg, lim: RealtimeSlam(cfg, lim)
    else:
        sys.path.insert(0, ROOT)
        import torch
        torch.set_num_threads(4)
        from coebslam_tpu_torch import config
        from coebslam_tpu_torch.eval import ate
        from coebslam_tpu_torch.slam.realtime import RealtimeSlam, RTLimits
        make = lambda cfg, lim: RealtimeSlam(cfg, lim, device="cpu")
    if scene == "room":
        cfg, lim = config.SystemConfig(), RTLimits(max_kf=16)
    else:
        cfg, lim = mono_config(config), RTLimits(**MONO_LIMITS)
    frames, gt = (_frames_jax if pkg == "jax" else _frames_port)(scene, cfg)
    ates = []
    for s in range(seeds):
        t0 = time.time()
        rt = make(cfg, lim)
        rt._seed = 1000 * s
        for i, (g, d, b) in enumerate(frames):
            if scene == "room":
                rt.track(g, d, stamp=i / 30.0, boxes=b)
            else:
                rt.track_mono(g, stamp=i / 30.0)
        res = rt.finish()
        ok = np.asarray(res["ok"], bool)
        est = np.asarray([-R.T @ t for R, t in zip(res["R"], res["t"])])
        n = len(est)
        sel = np.nonzero(ok)[0] if scene == "mono" else np.arange(n)
        rmse = float(ate.ate_rmse(sel / 30.0, est[sel], np.arange(n) / 30.0,
                                  gt, with_scale=scene == "mono")["rmse"]) \
            if len(sel) >= 3 else float("nan")
        ates.append(rmse)
        print(json.dumps({"package": pkg, "scene": scene, "seed": 1000 * s,
                          "ate_m": rmse, "ok": int(ok.sum()), "n": n,
                          "n_kf": int(res["n_kf"]),
                          "seconds": time.time() - t0}), flush=True)
    a = np.asarray(ates)
    print(json.dumps({"package": pkg, "scene": scene, "seeds": seeds,
                      "ate_mean_m": float(np.nanmean(a)),
                      "ate_std_m": float(np.nanstd(a)),
                      "ate_min_m": float(np.nanmin(a)),
                      "ate_max_m": float(np.nanmax(a))}), flush=True)


def main():
    args = sys.argv[1:]
    seeds = 8
    if "--seeds" in args:
        i = args.index("--seeds")
        seeds = int(args[i + 1])
        del args[i:i + 2]
    if len(args) != 2 or args[0] not in ("jax", "port") \
            or args[1] not in ("room", "mono"):
        sys.exit(__doc__)
    run(args[0], args[1], seeds)


if __name__ == "__main__":
    main()

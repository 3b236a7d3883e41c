"""Offline TUM RGB-D driver (the reference's ``rgbd_tum``).

Counterpart of ``examples/run_tum_rgbd.py`` of the JAX package. Reads a
TUM sequence directory (rgb.txt, depth.txt, groundtruth.txt; images
through ``io/png.py``), tracks it and writes ``CameraTrajectory.txt`` and
``KeyFrameTrajectory.txt``; with ground truth it prints the ATE.

Usage:
  python3 -m coebslam_tpu_torch.examples.run_tum_rgbd SEQUENCE_DIR [options]

Options:
  --assoc FILE       precomputed association file (stamp rgb stamp depth)
  --settings FILE    settings file (the reference's cv::FileStorage style
                     or the nested schema); default SystemConfig()
  --yolo WEIGHTS.pt  ultralytics YOLOv5s checkpoint -> the detector
  --boxes FILE       precomputed detector boxes (stamp xmin ymin xmax ymax
                     per line), looked up within 0.03 s of each frame
  --vocab FILE       ORB vocabulary (.npz or ORBvoc text): relocalization
                     and loop closing
  --max-frames N     limit the frame count
  --out DIR          output directory (default: SEQUENCE_DIR)
  --viz              also write map.ply and map_topdown.png
  --realtime         the zero-sync realtime path (RealtimeSlam): raw
                     frames, one read at the end (finish())
  --refine           with --realtime: handoff and global BA of the
                     finished session, then KeyFrameTrajectory.txt and
                     the refined trajectory's ATE
  --hybrid-gba       with --realtime: the refine step (implied), then the
                     segment-sharded global BA of the refined arena over
                     a hybrid (dcn, ici) mesh of one rank per visible
                     device (parallel/multihost.py, parallel/sharded_ba.py)
  --cpu              run on the CPU (default: CUDA, which must exist)

The printed fps is the host clock around the tracking calls, PNG decoding
excluded: a host-path call returns when its reads are done; the realtime
path sums its dispatch calls after the first frame and the drain of the
card after the last (the card may work on while a frame is decoded).
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

import numpy as np

def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python3 -m coebslam_tpu_torch.examples.run_tum_rgbd",
        description="Track a TUM RGB-D sequence.")
    ap.add_argument("sequence")
    ap.add_argument("--assoc")
    ap.add_argument("--settings")
    ap.add_argument("--yolo")
    ap.add_argument("--boxes")
    ap.add_argument("--vocab")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--out")
    ap.add_argument("--viz", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--realtime", action="store_true")
    ap.add_argument("--refine", action="store_true")
    ap.add_argument("--hybrid-gba", action="store_true")
    return ap.parse_args(argv)


def load_settings(path: Optional[str]):
    from ..config import SystemConfig, load_config
    return load_config(path) if path else SystemConfig()


def load_vocabulary(path: Optional[str]):
    """A vocabulary from .npz or ORBvoc text, or None."""
    if not path:
        return None
    from ..slam import vocabulary as voc_mod
    return (voc_mod.load(path) if path.endswith(".npz")
            else voc_mod.load_orbvoc_text(path))


def load_yolo(path: Optional[str], cfg, device):
    """The detector from an ultralytics checkpoint, or None."""
    if not path:
        return None
    import torch
    from ..models import yolov5
    from ..models.detector import YoloDetector
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["model"].float().state_dict() if "model" in ckpt else ckpt
    return YoloDetector(cfg.detector, cfg.dynamic,
                        yolov5.port_torch_weights(sd), device=device)


def box_lookup(path: Optional[str], max_boxes: int):
    """stamp -> the [max_boxes, 4] boxes (-1 padded) of the nearest stamp
    of a boxes file within 0.03 s, else None; None without a file."""
    if not path:
        return None
    from ..utils import replica
    bstamps, bboxes = replica.load_boxes(path, max_boxes=max_boxes)

    def lookup(stamp):
        if len(bstamps) == 0:
            return None
        j = int(np.argmin(np.abs(bstamps - stamp)))
        if abs(bstamps[j] - stamp) > 0.03:
            return None
        return bboxes[j]
    return lookup


def centres(poses) -> np.ndarray:
    """Camera centres -R^T t of (R_cw, t_cw) pairs."""
    return np.asarray([-np.asarray(R).T @ np.asarray(t) for R, t in poses])


def run(args: argparse.Namespace) -> dict:
    """Track the sequence; returns the mode, the frame count, the output
    directory, the ATE (None without ground truth), the tracking seconds
    and fps, and: host mode the ``System`` and the per-frame states;
    realtime mode the ``finish()`` result and, with --refine, the refined
    arena, keyframe ids, keyframes optimised and refined ATE; with
    --hybrid-gba also ``hybrid``: the sharded solve's keyframes, poses,
    mesh, segment point counts, ranks, backend and seconds."""
    from ..eval import ate
    from ..io import tum
    from ..utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None, "run_tum_rgbd")
    cfg = load_settings(args.settings)
    detector = load_yolo(args.yolo, cfg, device)
    vocab = load_vocabulary(args.vocab)
    lookup = box_lookup(args.boxes, cfg.dynamic.max_boxes)
    seq = (tum.load_association_file(args.sequence, args.assoc)
           if args.assoc else tum.load_tum_sequence(args.sequence))
    n = len(seq) if args.max_frames <= 0 else min(len(seq), args.max_frames)
    print(f"sequence: {args.sequence}  frames: {n}  "
          f"detector: {'yolo' if detector else 'none'}  "
          f"vocab: {'yes' if vocab else 'no'}  "
          f"mode: {'realtime' if args.realtime else 'host'}  "
          f"device: {device}", flush=True)
    out_dir = args.out or args.sequence
    os.makedirs(out_dir, exist_ok=True)

    def score(stamps, est):
        if seq.gt_stamps is None:
            return None
        return ate.ate_rmse(np.asarray(stamps), est, seq.gt_stamps,
                            seq.gt_poses[:, :3])

    if args.realtime:
        out = _run_realtime(args, cfg, seq, n, lookup, detector, vocab,
                            device, out_dir, score)
    else:
        out = _run_host(args, cfg, seq, n, lookup, detector, vocab, device,
                        out_dir, score)
    out.update(n=n, out_dir=out_dir, device=str(device))
    return out


def _run_host(args, cfg, seq, n, lookup, detector, vocab, device, out_dir,
              score) -> dict:
    from ..slam.system import System
    system = System(cfg, detector=detector, vocabulary=vocab, device=device)
    states, times = [], []
    for i in range(n):
        stamp, gray, depth = seq.load_frame(
            i, depth_factor=cfg.camera.depth_map_factor)
        t0 = time.perf_counter()
        boxes = lookup(stamp) if lookup else None
        state, inl = system.track_rgbd(gray, depth, stamp, boxes=boxes)
        dt = time.perf_counter() - t0
        times.append(dt)
        states.append(state)
        if i % 25 == 0 or state != "OK":
            print(f"frame {i:4d}  {state:16s} inliers={inl:4d} "
                  f"kfs={len(system.map.valid_keyframes()):3d} "
                  f"pts={len(system.map.valid_points()):5d} "
                  f"{dt * 1e3:6.1f} ms", flush=True)
    system.shutdown()
    traj_path = os.path.join(out_dir, "CameraTrajectory.txt")
    system.save_trajectory_tum(traj_path)
    system.save_keyframe_trajectory_tum(
        os.path.join(out_dir, "KeyFrameTrajectory.txt"))
    med = sorted(times)[len(times) // 2] if times else float("nan")
    print(f"\nframes OK {states.count('OK')}/{n}; keyframes "
          f"{len(system.map.valid_keyframes())}; median track time "
          f"{med * 1e3:.1f} ms ({1.0 / med:.1f} fps steady-state, host "
          "clock, PNG decoding excluded)")
    print(f"trajectory saved to {traj_path}")
    traj = system.tracker.trajectory
    res = score([s for s, _, _ in traj],
                centres([(R, t) for _, R, t in traj]))
    if res is not None:
        print(f"ATE RMSE: {res['rmse'] * 100:.2f} cm  "
              f"(median {res['median'] * 100:.2f} cm, {res['pairs']} pairs)")
    if args.viz:
        _write_viz(system, out_dir)
    return {"mode": "host", "system": system, "states": states, "ate": res,
            "track_s": float(sum(times)),
            "fps": n / sum(times) if times else float("nan")}


def _write_viz(system, out_dir: str) -> None:
    from ..utils import viz
    m = system.map
    kfs = m.valid_keyframes()
    viz.save_ply(os.path.join(out_dir, "map.ply"),
                 m.pt_pos[m.valid_points()],
                 keyframe_positions=centres(zip(m.kf_R[kfs], m.kf_t[kfs])))
    traj = centres([(R, t) for _, R, t in system.tracker.trajectory])
    img = viz.render_map_topdown(m.pt_pos, m.pt_valid, kf_t=m.kf_t[kfs],
                                 kf_R=m.kf_R[kfs], trajectory=traj)
    viz.save_png(os.path.join(out_dir, "map_topdown.png"), img)
    print(f"viz artifacts in {out_dir}")


def _run_realtime(args, cfg, seq, n, lookup, detector, vocab, device,
                  out_dir, score) -> dict:
    """Zero-sync replay: upload and dispatch only, one read at the end
    (finish())."""
    from ..io import trajectory
    from ..slam import handoff
    from ..slam.realtime import RealtimeSlam

    rt = RealtimeSlam(cfg, detector=detector, vocabulary=vocab,
                      device=device)
    t0 = time.perf_counter()
    first_s = track_s = 0.0
    for i in range(n):
        stamp, gray, depth = seq.load_frame_raw(i)
        boxes = lookup(stamp) if lookup else None
        t_in = time.perf_counter()
        rt.track(gray, depth, stamp=stamp, boxes=boxes)
        if i == 0:
            rt.block()
            first_s = time.perf_counter() - t0
            print(f"first frame in {first_s:.1f}s", flush=True)
        else:
            track_s += time.perf_counter() - t_in
    t_in = time.perf_counter()
    rt.block()
    track_s += time.perf_counter() - t_in
    fps = (n - 1) / track_s if n > 1 else float("nan")
    res = rt.finish()

    traj_path = os.path.join(out_dir, "CameraTrajectory.txt")
    trajectory.save_tum(traj_path, res["stamps"],
                        list(zip(res["R"], res["t"])))
    print(f"\n{fps:.1f} fps steady-state (host clock, frames 2-{n}: "
          f"dispatch and the final drain, PNG decoding excluded); ok "
          f"{int(res['ok'].sum())}/{n}; keyframes {res['n_kf']} (evicted "
          f"{res['kf_evicted']}); loops {res.get('n_loops_closed', 'n/a')}; "
          f"reloc {res.get('n_relocalizations', 'n/a')}")
    print(f"trajectory saved to {traj_path}")
    r = score(res["stamps"], centres(zip(res["R"], res["t"])))
    if r is not None:
        print(f"ATE RMSE: {r['rmse'] * 100:.2f} cm  "
              f"(median {r['median'] * 100:.2f} cm, {r['pairs']} pairs)")
    out = {"mode": "realtime", "result": res, "ate": r, "fps": fps,
           "first_s": first_s, "track_s": track_s}
    if args.refine or args.hybrid_gba:
        m, kf_ids, n_opt = handoff.refine(res, cfg, device=device)
        trajectory.save_tum(
            os.path.join(out_dir, "KeyFrameTrajectory.txt"),
            m.kf_stamp[kf_ids], [(m.kf_R[k], m.kf_t[k]) for k in kf_ids])
        print(f"offline refinement: global BA over {n_opt} keyframes; "
              "KeyFrameTrajectory.txt written")
        traj2 = handoff.refined_trajectory(res, m, kf_ids)
        r2 = score(res["stamps"],
                   centres([(P[:, :3], P[:, 3]) for P in traj2]))
        if r2 is not None:
            print(f"refined ATE RMSE: {r2['rmse'] * 100:.2f} cm")
        out.update(arena=m, kf_ids=kf_ids, n_opt=n_opt, refined_ate=r2)
    if args.hybrid_gba:
        out["hybrid"] = hybrid_gba(m, cfg, device)
    return out


def hybrid_gba(m, cfg, device) -> dict:
    """The segment-sharded global BA of arena ``m`` over a hybrid (dcn, ici)
    mesh of one rank per visible device (``torch.cuda.device_count()`` on
    CUDA, one on the CPU), with dcn = max(2, n // 4) for n > 1; the points
    padded to the mesh size x 2 blocks per rank. One rank solves in this
    process, more through ``parallel.launch``. The arena is not written."""
    import torch
    from ..parallel import multihost, sharded_ba
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    shape = multihost.hybrid_shape(n, max(2, n // 4) if n > 1 else 1)
    prob, kfs, pts, seg = multihost.arena_to_ba_problem(
        m, cfg, n_segments=shape[0], pad_points_to=n * 2, device="cpu")
    out = sharded_ba.run_sharded(
        "global", prob, cfg.optimizer, n, cam=cfg.camera, device=device,
        hybrid=True, dcn_size=shape[0],
        axis=(multihost.DCN_AXIS, multihost.ICI_AXIS))
    if not bool(np.isfinite(out["result"].kf_t.numpy()).all()):
        raise RuntimeError("hybrid-mesh GBA: keyframe poses not finite")
    counts = [int((seg == s).sum()) for s in range(shape[0])]
    print(f"hybrid-mesh GBA: {len(kfs)} KFs / {len(pts)} points over mesh "
          f"{out['mesh']} (dcn,ici); segment point counts {counts}",
          flush=True)
    res = out["result"]
    return {"kfs": kfs, "kf_R": res.kf_R.numpy(), "kf_t": res.kf_t.numpy(),
            "mesh": out["mesh"],
            "segment_counts": counts, "n_ranks": n,
            "backend": out["backend"], "seconds": out["seconds"],
            "all_reduces": out["all_reduces"],
            "all_reduce_bytes": out["all_reduce_bytes"]}


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

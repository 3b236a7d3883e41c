"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the repository root:  python3 chip_smoke.py

Phases (each one failing the run with a non-zero exit when it fails):
  1. The card's name and power limit; build the CUDA FAST kernel
     (coebslam_tpu_torch/csrc/fast.cu -> build/) and print the build time
     and the registers, shared memory and spills ptxas reports.
  2. The kernel against its plain PyTorch version on the card, at thr 7
     and 10: the canvases the paths give it (a rendered 640x480 orbit
     frame's 8-level pyramid under SystemConfig's ORB; the circuit's first
     frame's 4-level pyramid under the circuit's ORB, which the kidnap
     shares), each at its config's two thresholds, and the canvases of
     FAST_EDGE_CASES (extents one pixel below,
     at and above the kernel's 64x32 tile, an extent + 3 on a tile seam,
     W % 4 == 0 and != 0, integer-valued images for NMS ties, negative
     samples for the kernel's float path). Score and
     strength bit-equal over the whole canvas; strength also equal to the
     edge-padded reference formula inside each level.
  3. The extractor on the card through the kernel against the extractor
     with the plain FAST, on the orbit frame (with a dynamic mask, area
     mode off and on) and on the circuit frame under its ORB: valid equal,
     uv within 1e-4, descriptors bit-equal.
  4. The main path: RealtimeSlam at full width (SystemConfig() and
     RTLimits() defaults) with the vocabulary (artifacts/vocab_1e5.npz)
     and the maintenance program every 8 frames, over the two-pass dynamic
     orbit of bench.py (150 rendered frames with the walker and its
     ground-truth boxes, run twice). Every frame must track, ATE < 2.5 cm,
     the kernel must be launched once per frame and maintenance dispatched
     300 // 8 times. Prints fps of the second pass, keyframes, live points,
     loops closed, relocalizations, bank entries, host synchronisations per
     frame and the maintenance dispatch times. Dispatches are timed without
     draining the card (host ms of the call, and the device span between
     CUDA events recorded around it, read after the run), so fps and the
     sync count are those of the program as it runs.
  5. The kernel's time on the card beside the plain version's and the
     bound (fast_cuda.work: live input bytes read once, both outputs
     written once), at the main path's shape: CUDA events around one call
     queued behind a device-side sleep (so host dispatch is not timed),
     median of 200 calls (50 for the plain version). Cold: a 128 MiB
     buffer (over twice the L2) is written between the sleep and the call,
     so the call finds nothing in L2; warm: without it, as the main path
     finds the canvas that level_canvas has just written. An empty kernel
     timed the same way shows what the method cannot go below. Fails only
     on a time that is not finite.
  6. The loop circuit of bench.py (run_loop_event): 110 frames of the
     six-wall room around a 1 m circle and past its start, depth x 1.06,
     1024 keypoints on 4 levels, maintenance every frame. At least one
     closure applied, every applied closure to a keyframe <= 8, ATE < 12
     cm, one kernel launch per frame.
  7. Kidnap relocalization (tests/test_realtime_loop.py): frames 0-49 of
     the circuit, then 6-15 again, maintenance every 2 frames. At least one
     relocalization, the last 4 frames tracked, ATE of the last 5 < 5 cm.
  8. The orbit, self-detect (bench.py run_realtime_selfdetect, cut to
     the first 30 of its 150 frames for the script's time): no
     ground-truth boxes; RealtimeSlam(detector=, detect_every=3) with the
     walker detector (artifacts/detector_walker.npz, width 0.25, 320x320
     input, one class, conf 0.4, boxes dilated 25 %). Every frame tracked,
     ATE < 5 cm, one FAST launch per frame and 10 detections; prints host
     syncs per frame, fps and the mean best IoU of the detector's boxes
     with the walker's on every 10th frame.
  9. The detector alone, at full width (DetectorConfig(): yolov5s, 80
     classes, 640x640, seeded random weights) and at the walker's width:
     the card's raw heads against the port's CPU forward with the same
     weights on one orbit frame (rtol 1e-3, atol 1e-3; cuDNN sums in
     another order), the largest box and score difference, the device ms
     of one detect_device (median of 50, queued behind a device-side
     sleep), the device kernels per detection (torch.profiler) and the
     convolutions' operations.
 10. Handoff and offline global BA of the sessions of [4] and [6]:
     to_arena, GlobalBA.run (the body of handoff.refine), keyframe ATE
     before and after, refined_trajectory's ATE against the realtime one.
     The orbit's refined keyframe ATE < 2 cm; the circuit's refined
     trajectory below its realtime ATE and under 12 cm.
 11. Stereo at full width (tests/test_stereo_wide.py's scene without its
     4-level / 1024-keypoint cut): RealtimeSlam.track_stereo over the first
     60 of its 120 rendered left/right pairs of the walking trajectory (the
     script's time; cpu_reference.py jax stereo 60), baseline 0.30 m
     (bf 160), the walker and its ground-truth boxes, frames 40-51
     box-blurred; SystemConfig(sensor="stereo") with ORB and RTLimits at
     their defaults. >= 55/60 frames tracked, ATE < 5 cm, and the kernel
     launched twice per frame (left and right). Prints keyframes, live
     points, fps, host syncs per frame and peak device memory.
 12. Monocular at full width (tests/test_realtime_mono.py's scene without
     its cut): RealtimeSlam.track_mono over the first 20 of the 60 frames
     of a 0.8 m orbit of the room (the script's time; cpu_reference.py jax
     mono 20). Initialised by frame 10, at most 3 frames lost after it, at
     least 3 keyframes, Sim3-aligned ATE < 5 cm, one kernel launch per
     frame. Prints the initialising frame, H or F, the points triangulated,
     the time of one initialisation attempt (CUDA events around one
     reconstruct_graph on the initialising frame's correspondences, with
     its host syncs counted), fps, syncs per frame and peak device memory.
 13. The host-orchestrated System (slam/system.py: Tracker + LocalMapper,
     synchronous mapping, no vocabulary, no detector; SystemConfig() at full
     width) on the first 30 frames of the 400-frame TUM replica (seed 0;
     cut from bench.py's 60 for the script's time; cpu_reference.py jax
     host-replica 30), which [16a] wrote as TUM files, fed by the offline driver
     (examples/run_tum_rgbd.run, host mode, --boxes: io/tum.load_frame,
     depth d16 / 5000, the walker's boxes looked up within 0.03 s). At
     most 5 frames lost, ATE < 8 cm (tests/test_tum_replica.py::
     test_host_path_ate's gates) and one FAST launch per frame. Prints
     keyframes, live points, local BAs, culled keyframes and points, host
     syncs per frame, fps (the whole run with PNG decoding, the card
     drained at the end; and the driver's track_rgbd time), the mapper's
     stage ms and peak device memory (profile_host.py runs this phase alone
     on in-memory frames, and in realtime mode).
 14. The host path's BoW half, System(vocabulary=) with the scene's own
     vocabulary (slam/vocabulary.train on descriptors extracted on the
     card), synchronous:
     a. tests/test_loop_e2e.py on [6]'s 110 circuit frames (its
        configuration, 1024 keypoints on 4 levels: at full width the JAX
        package itself misses the test's ATE gate, cpu_reference.py jax
        host-loop-full). A loop closed, first on frame >= 76; the ATE
        before the first closure > 2 cm and the exported trajectory's
        below 0.8 x it; at least one fused edge; one FAST launch per
        frame. Prints the loop's keyframe pair, the closing frame's stall
        by stage (host ms of compute_sim3, correct, its pose graph and
        global BA) with the host syncs of each, fps, syncs per frame and
        peak device memory.
     b. tests/test_vocabulary.py::TestRelocalizationE2E (the room, a
        30-frame orbit, 12 frames, 3 black ones, then frame 8 again; its
        1024 / 4 cut, as the JAX package at full width makes too few
        keyframes and resets, cpu_reference.py jax host-reloc-full): OK,
        LOST, OK, the camera centre within 10 cm, one FAST launch per
        frame. Then the System's Relocalizer on the return frame, as it
        is (Horn branch) and without its depth (EPnP branch): both must
        relocalize within 10 cm; prints the candidates tried, inliers, ms
        and syncs. Then one ransac_epnp at the relocalizer's shapes (300 hypotheses of 6, 2048
        correspondences, 30 % outliers, the same indices) on the card
        against the port's CPU result: inlier sets equal, pose within
        EPNP_CARD_TOL (1e-3); its device ms and syncs.
 15. The host System's other entries at full width (host_sensor_scenes.py;
     the JAX package passes each test's gates there on the CPU):
     a. System(SystemConfig(sensor="stereo")).track_stereo over the room's
        40-frame 0.35 m orbit (tests/test_stereo_checkpoint.py's scene,
        every frame), the right view from the pose moved by the baseline:
        frame 0 OK, at most 1 frame not OK, ATE < 5 cm, two FAST launches
        per frame.
     b. tests/test_monocular.py::TestMonocularRelocalization at full
        width: System(vocabulary=).track_monocular over [12]'s frames
        0-21 (the scene's own vocabulary), 3 black frames, frame 12
        again. Its gates: first OK <= 10, <= 3 lost after it, > 100 live
        points, Sim3 ATE < 25 cm; LOST after the blackout, OK on the
        return within 15 cm of frame 12's own centre; then the System's
        Relocalizer alone on that frame (no depth: its EPnP branch) within
        15 cm. Prints the initialisation (frame, H or F) and one attempt's
        device ms, the relocalize calls, one FAST launch per frame.
     c. tests/test_dynamic_e2e.py's walker scene (25 frames) through
        SystemConfig(dynamic=DynamicConfig(motion_check="flow")) (1000
        Harris corners, 4-level LK): ATE < 2 cm, <= 2 lost, the walker's
        box dynamic on some frame, one FAST launch per frame; one frame
        pair's dynamic_frontend on the card against the CPU with the same
        F-RANSAC samples (mask and box flags equal, points within 1e-2
        px); one lk_flow and one good_features timed (device ms, kernels
        per call); BlurGate over 4 frames on the card and the CPU (the
        same emits).
     d. [13]'s map checkpointed (io/checkpoint.py), loaded into a new
        System in localization mode, and [13]'s last frame tracked: OK
        with > 100 inliers, no keyframe added.
 16. The file-based entry points (PNG through io/png.py, no PIL):
     a. replica.write: the replica's first 60 frames rendered on the card
        and written as a TUM sequence (seconds, MiB); frames 0 and 59
        decode to replica.generate's arrays exactly.
     b. [13]'s CameraTrajectory.txt and KeyFrameTrajectory.txt read back
        (io/trajectory.load_tum: a row per frame and per keyframe) and
        their RPE against the ground truth (eval/rpe).
     c. run_tum_rgbd --realtime --refine --hybrid-gba --boxes on the same
        files: frames OK >= 55, ATE < 8 cm, refined ATE < 1.5 cm and below
        the raw ATE (tests/test_tum_replica.py's gates, which the JAX
        package passes on these 60 frames on the CPU), one FAST launch per
        frame; fps, the keyframes optimised, peak device memory. Then the
        hybrid-mesh GBA of the refined arena, one rank per card (one NCCL
        rank here): its line, mesh, backend and seconds; its keyframe
        poses within 2e-3 of the refine step's.
     d. run_stereo kitti and run_mono euroc on tests/test_example_drivers.py's
        6 frames, rendered on the card and written as PNGs: the
        trajectories written (6 KITTI rows), a frame tracked by the stereo
        driver, FAST launches 12 and 6.
     e. artifacts/vocab_1e5.npz through save_orbvoc_text and
        load_orbvoc_text: every array equal, and [4]'s first frame's words
        equal before and after; seconds each way and MiB.
     f. tools/train_vocab --frames 24 --depth 3: 24 FAST launches, the
        words, seconds, and vocabulary.load of its output.
 17. Multi-device BA on the card (parallel/: one process per rank,
     launched with parallel.launch; 4 ranks share the one card over gloo,
     which stages its collectives through host copies):
     a. entry.entry(): the fused front-end + track step at 640x480 on the
        __graft_entry__ arguments, one FAST launch, its device ms, and its
        result against the same function on the CPU (pose within 1e-4,
        inliers within 1).
     b. entry.dryrun_multichip(4): parts (a)-(e) of __graft_entry__ with
        their checks ((e): the segment-sharded GBA of a 100-keyframe /
        16k-point arena equals the 1-D mesh's within 2e-3), 4 FAST
        launches (one frame per rank).
     c. [10]'s handed-off orbit arena (the real map at full width) through
        multihost.arena_to_ba_problem, its segment-sharded global BA over
        a (2, 2) mesh against optimize_global_ba in this process: kf_t and
        kf_R within 2e-3, median point gap under 5e-3, the ranks' poses
        bit-equal.
     d. The pose graph of that arena's keyframes (chain + loop edge,
        translations perturbed by 1 cm) over 4 ranks against the
        single-rank solve, within 2e-3.
     Each part prints its seconds, all-reduces per GN iteration (2: S and
     b), the bytes of each and the backend. NCCL across cards is not
     verified here (one card).
 18. Detector training on the card (tools/train_detector.run at the
     walker detector's width 0.25, batch 8, 320 input; cut for the
     script's time to 2 sequences x 40 frames and 100 steps, the JAX tool
     runs 3 x 130 and 700): the loss at the first and last step, steps/s,
     the held-out IoU, peak device memory, and the written .npz read back
     by models.detector.load_variables_npz equal to the trained state,
     and the SHA-1 of the losses and trained weights (the tool trains
     deterministically, so it is the same in every run of one tree on one
     card). Gates: every loss finite, the mean of the last 10 below that of
     the first 10, training on the card.
 19. The realtime place bank (rt_loop_scenes.py: tests/test_place_bank.py's
     scenes, an 8-row keyframe ring, bank_cap 64, the scene's own
     vocabulary trained on the card, maintenance every frame):
     a. [6]'s drifted circuit, and its odometry twin without a vocabulary:
        the ring wraps 3 times (keyframes >= 24), bank entries > 8, a bank
        closure applied to a keyframe more than 8 older, the revisit gap
        below 0.6 x the twin's and the ATE within 1.1 x + 0.5 cm of it.
     b. The circuit's first half, 8 black frames, frames 6-15 again: a
        bank relocalization, >= 8 of the 10 revisit frames tracked, their
        median centre error below 30 cm.
     The odometry twin and (b) run in two more processes beside (a)
     (``--rt-bank-session``), for the script's time, so [19]'s seconds
     and host ms carry their contention. Prints the JAX package's CPU
     values beside each gate, the bank closure's and the bank
     relocalization's dispatch (host ms and device span) and one FAST
     launch per frame.
 20. The monocular Sim3 loop closure (host_sensor_scenes.py), run after
     [21] on its System: no rendered circuit makes the JAX package's
     monocular System close a loop (ROADMAP queue 4), so the map's newest
     keyframe and the points it observes are moved by a similarity of
     scale 1.2 (shared points copied), as scale drift leaves a place the
     camera returns to, and the loop closer closes it against the oldest
     keyframe: compute_sim3 with scale (S12's scale within 0.05 of 1.2),
     correct with the free-scale pose graph and the global BA; the
     keyframes' Sim3 ATE after the closure below 0.8 x the drifted one.
     Prints the closure's stall by stage (host ms and host syncs of
     compute_sim3, correct, its pose graph and global BA).
 21. The host System's recovery through the Relocalizer's EPnP branch
     (host_sensor_scenes.py): [15b]'s monocular System at full width over
     frames 0-45 of the room's orbit at 1.2 m radius, 3 black frames,
     then frame 15, which lies beyond the fused step's widened gate: OK,
     LOST, OK within 15 cm of the centre the System gave frame 15 before, the return taken by the
     Relocalizer through EPnP (its RANSACs counted); the relocalize call's
     ms and host syncs; one FAST launch per frame.
 22. bench.py's dataset rows (replica_rows.py) at full length, through
     RealtimeSlam(...).track then finish() on utils/replica.generate's
     frames (grey uint8, depth uint16, the walker boxes) with
     artifacts/vocab_1e5.npz:
     a. the 300-frame out-and-back closure replica, depth x 1.05,
        maintenance every 4 frames, and its odometry twin: >= 295 tracked,
        a loop closed, ATE < 6 cm and below the twin's;
     b. the 400-frame replica, maintenance every 8 frames, then
        handoff.refine: >= 395 tracked, raw ATE < 8 cm, refined below raw;
     c. the two-walker replica (200 frames, seed 1): >= 195 tracked, ATE
        < 7 cm; the frames by walker boxes seen.
     The four sessions run in processes of their own at CPU priority nice
     10 (so the phases beside them keep the CPU), started right after [5]
     (so [4]'s fps and [5]'s kernel times are measured alone) and joined
     before the last line; every phase from [6] to [20] says in its line
     that it ran beside them.
     Prints fps, keyframes, loops, the maintenance dispatches' host ms and
     device span (median, max) and one FAST launch per frame.
Each of [4], [6]-[15], [16c] and [22] prints the JAX package's result on the CPU
for the same scene and configuration beside its own, and the peak device
memory.
Each phase prints its seconds.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. There is no CPU fallback: without CUDA the
script exits with code 2 and prints no result.
"""
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

from host_sensor_scenes import (
    HOST_EPNP_RETURN, HOST_EPNP_TRACK, HOST_EPNP_VOCAB_FRAMES,
    HOST_FLOW_MAX_LOST, HOST_FLOW_ORBIT, HOST_FLOW_WALKER,
    HOST_FLOW_ATE_LIMIT_M, HOST_MONO_ATE_LIMIT_M, HOST_MONO_BLACK,
    HOST_MONO_FIRST_OK_MAX, HOST_MONO_LOOP_DRIFT, HOST_MONO_LOOP_GAIN,
    HOST_MONO_MAX_LOST_AFTER, HOST_MONO_MIN_POINTS,
    HOST_MONO_RETURN, HOST_MONO_RETURN_LIMIT_M, HOST_MONO_TRACK,
    HOST_MONO_VOCAB, HOST_MONO_VOCAB_FRAMES, HOST_STEREO_ATE_LIMIT_M,
    HOST_STEREO_MAX_NOT_OK, HOST_STEREO_ORBIT, N_HOST_FLOW,
    host_epnp_failures, host_epnp_frames, host_flow_config,
    host_flow_failures, host_flow_frames, host_flow_summary,
    host_mono_config, host_mono_failures, host_mono_frame_of,
    host_stereo_config, host_stereo_failures, host_stereo_frames,
    host_stereo_summary, pose_centres, run_host_flow, run_host_mono,
    run_host_stereo, run_mono_loop)
from host_bow_scenes import (HOST_LOOP_VOCAB_FRAMES, HOST_LOOP_VOCAB,
                             HOST_LOOP_FIRST_MIN, HOST_LOOP_GAIN,
                             HOST_RELOC_ORBIT, HOST_RELOC_TRACK,
                             HOST_RELOC_BLACK, HOST_RELOC_RETURN,
                             HOST_RELOC_VOCAB_FRAMES, HOST_RELOC_VOCAB,
                             HOST_RELOC_LIMIT_M, EPNP_SHAPE, EPNP_CARD_TOL,
                             sync_sites, host_loop_config, host_reloc_config,
                             scene_vocabulary, run_host_loop,
                             host_loop_summary, host_loop_failures,
                             run_host_reloc, depth_free_frames, reloc_direct,
                             host_reloc_failures, watch_calls, closure_stages,
                             pnp_scene, RELOC_ATTEMPTS, reloc_calls,
                             reloc_truth)
from rt_loop_scenes import (
    BANK_LIMITS, BANK_RELOC_BLACK, BANK_VOCAB, CIRCUIT_LIMITS,
    bank_loop_failures, bank_loop_summary, bank_reloc_failures,
    bank_reloc_summary, bank_vocab_frames, centres, circuit_config,
    loop_scene, run_bank_reloc, run_realtime)
import replica_rows
from replica_rows import card, dispatch_line, dispatch_summary, time_dispatches

# [22] (replica_rows.py): bench.py's dataset rows at full length.
ROW_TAGS = {"closure": "[22a]", "twin": "[22a]", "maint": "[22b]",
            "walkers": "[22c]"}
ROWS_JOIN_S = 900            # seconds to wait for them after [20]
ROWS_NICE = 10               # [22]'s sessions yield the CPU to [6]-[20]

N_FRAMES = 150
ATE_LIMIT_M = 0.025
MAINTAIN_EVERY = 8           # bench.py's maintenance cadence on the orbit
CIRCUIT_ATE_LIMIT_M = 0.12   # tests/test_realtime_loop.py's full-ATE bound
KIDNAP_TAIL_LIMIT_M = 0.05
# The JAX package on the CPU, same scenes and configurations, vocab_1e5
# (cpu_reference.py jax orbit|circuit|kidnap):
JAX_CPU_ATE_M = 0.016667     # orbit ATE
JAX_CPU_ORBIT = "3 loops closed of 4 events, 0 relocalizations, 43 bank entries"
JAX_CPU_CIRCUIT_ATE_M = 0.073159
JAX_CPU_CIRCUIT = "1 loop closed (to keyframe 0) of 9 events"
JAX_CPU_KIDNAP_TAIL_M = 0.001680
JAX_CPU_KIDNAP = "1 relocalization, the last 4 frames tracked"
# [8]: the first N_SELFDETECT frames of the orbit, self-detect
# (cpu_reference.py jax selfdetect).
N_SELFDETECT = 30
JAX_CPU_SELFDETECT = dict(ok=30, ate_m=0.007293, n_kf=8, detections=10,
                          box_iou=0.572848)
SELFDETECT_ATE_LIMIT_M = 0.05
# [10]: handoff and global BA of [4]'s and [6]'s sessions
# (cpu_reference.py jax refine orbit|circuit).
JAX_CPU_REFINE = {
    "orbit": dict(arena_keyframes=44, arena_points=4348, truncated_obs=11,
                  gba_s=16.14, kf_ate_realtime_m=0.015995,
                  kf_ate_refined_m=0.004895, ate_realtime_m=0.016667,
                  ate_refined_m=0.008272),
    "circuit": dict(arena_keyframes=46, arena_points=8127, truncated_obs=0,
                    gba_s=12.27, kf_ate_realtime_m=0.069154,
                    kf_ate_refined_m=0.061591, ate_realtime_m=0.073159,
                    ate_refined_m=0.062603),
}
REFINED_KF_ATE_LIMIT_M = 0.02    # tests/test_handoff.py
# [11] and [12] (cpu_reference.py jax stereo 60, jax mono 20).
JAX_CPU_STEREO = dict(ok=60, ate_m=0.010027, n_kf=6, live_points=1403)
JAX_CPU_MONO = dict(first_ok=1, lost_after=0, ok=19, ate_sim3_m=0.009329,
                    n_kf=6, init="frame 1, homography, 602 triangulated")
MEM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
FP32_OPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
L2_FLUSH_BYTES = 128 << 20   # written before a cold call: over twice the L2
# The self-detect orbit (bench.py _own_detector, run_realtime_selfdetect).
DETECTOR_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "artifacts", "detector_walker.npz")
WALKER_DETECTOR = dict(num_classes=1, input_size=320, conf_threshold=0.4)
WALKER_DILATE = 0.25
DETECT_EVERY = 3
# [11]: wide-baseline dynamic stereo (tests/test_stereo_wide.py at full
# width): bf 160 (baseline 0.30 m), the walking trajectory, the walker and
# its boxes, frames [40, 52) box-blurred with a 9-px kernel.
N_STEREO = 120
# The script's cut, for its time: its first 60 frames,
# which hold the blur window.
N_STEREO_RUN = 60
STEREO_BF = 160.0
STEREO_WALKER = dict(seed=1, start=(-1.0, -0.25, 1.8),
                     velocity=(0.011, 0.004, 0.0), half_w=0.28, half_h=0.62)
STEREO_BLUR = (40, 52, 9)
STEREO_MIN_OK = N_STEREO_RUN - 5
STEREO_ATE_LIMIT_M = 0.05
# [12]: monocular (tests/test_realtime_mono.py at full width): the room
# without the walker, a 0.8 m orbit for initialisation parallax.
N_MONO = 60
# The script's cut, for its time: the first 20 frames, the
# initialisation on frame 1 and the tracking after it.
N_MONO_RUN = 20
MONO_RADIUS = 0.8
MONO_FIRST_OK_MAX = 10
MONO_MAX_LOST_AFTER = 3
MONO_ATE_LIMIT_M = 0.05          # Sim3-aligned, tracked frames only
# [13]: the host-orchestrated System on the TUM replica (bench.py
# bench_replica_host; tests/test_tum_replica.py::test_host_path_ate's
# configuration and gates): the first N_HOST frames of the 400-frame
# replica schedule, seed 0.
N_HOST = 60                      # bench.py REPLICA_HOST_FRAMES
# [13] tracks the first N_HOST_RUN of the files [16a] writes, for the
# script's time ([16c] runs all N_HOST).
N_HOST_RUN = 30
HOST_SCHEDULE = dict(n_frames=400, seed=0)
HOST_MAX_LOST = 5
HOST_ATE_LIMIT_M = 0.08
JAX_CPU_HOST = dict(ok=30, lost=0, ate_m=0.002090, n_kf=5, live_points=479,
                    local_ba=4, culled_kf=1, culled_pt=809)
# The JAX package on the CPU, same scenes and configurations
# (cpu_reference.py jax host-loop|host-reloc).
# [16]: the file-based entry points.
N_EXAMPLE = 6                    # tests/test_example_drivers.py's frames
EXAMPLE_LAUNCHES = dict(stereo=2 * N_EXAMPLE, mono=N_EXAMPLE)
VOCAB_TRAIN = dict(frames=24, depth=3)
# [17]: multi-device BA on the one card; tests/test_sharded_ba.py's
# tolerances.
MULTICHIP_RANKS = 4
SHARD_POSE_TOL = 2e-3
SHARD_POINT_GAP = 5e-3
ENTRY_POSE_TOL = 1e-4
# [18]: detector training at the walker detector's width, cut for time.
TRAIN_DETECTOR = dict(width=0.25, batch=8, seqs=2, frames=40, steps=100)
# [16c]: run_tum_rgbd --realtime --refine on the first N_HOST files
# (cpu_reference.py jax driver-rt), and tests/test_tum_replica.py's gates,
# which the JAX package passes there.
JAX_CPU_DRIVER_RT = dict(ok=60, ate_m=0.004730, n_kf=6, n_opt=6,
                         refined_ate_m=0.003918)
DRIVER_RT_MIN_OK = N_HOST - 5
DRIVER_RT_ATE_LIMIT_M = 0.08
DRIVER_RT_REFINED_LIMIT_M = 0.015
JAX_CPU_HOST_LOOP = dict(ok=110, loops=1, closed_at=94, loop_edge=(36, 5),
                         fused_edges=30, ate_pre_m=0.064488,
                         ate_post_m=0.044864, n_kf=41)
JAX_CPU_HOST_RELOC = dict(
    n_kf_before=6, states="OK, LOST, OK", centre_err_m=0.002892,
    return_inliers=387, reloc_calls="3 (the black frames; no candidate)",
    direct_horn=dict(inliers=336, centre_err_m=0.002374),
    direct_epnp=dict(inliers=336, centre_err_m=0.002208))
# [19] (rt_loop_scenes.py; cpu_reference.py jax rt-bank-loop,
# jax rt-bank-reloc).
JAX_CPU_RT_BANK_LOOP = dict(ok=110, n_kf=47, bank_entries=47,
                            n_bank_loops=1, applied_gaps=[40],
                            gap_m=0.009882, gap_odo_m=0.069024,
                            ate_m=0.074942, ate_odo_m=0.077598)
JAX_CPU_RT_BANK_RELOC = dict(n_bank_reloc=1, revisit_ok=9,
                             median_err_m=0.026713)
# [15] (host_sensor_scenes.py): the host System's stereo, monocular and
# flow entries at full width; the JAX package on the CPU, same scenes and
# configurations (cpu_reference.py jax host-stereo-full|host-mono-full|
# host-flow-full).
JAX_CPU_HOST_STEREO = dict(not_ok=0, ate_m=0.006336, n_kf=9,
                           live_points=1131)
JAX_CPU_HOST_MONO = dict(
    init="frame 1, H, 519 triangulated", first_ok=1, lost_after=0,
    live_points=852, n_kf=7, ate_sim3_m=0.011527,
    blackout="LOST, OK with 597 inliers, 0.132 cm",
    reloc="3 (the black frames; no candidate)",
    direct_epnp=dict(ok=True, candidates_tried=1, n_inliers=435,
                     centre_err_m=0.001252))
# [20] (cpu_reference.py jax host-mono-loop).
JAX_CPU_HOST_MONO_LOOP = dict(
    pair=[7, 0], debug={"stage": "accepted", "n1": 269, "n2": 500,
                        "n_match": 172, "ransac_inl": 172, "sim3_inl": 172,
                        "total": 285},
    scale=1.199822, drifted_m=0.050312, after_m=0.004993)
# [21] (cpu_reference.py jax host-epnp-reloc).
JAX_CPU_HOST_EPNP = dict(first_ok=1, lost_after=0, n_kf=8,
                         ate_sim3_m=0.008307, return_inliers=372,
                         return_err_m=0.005601,
                         return_reloc=[(True, 1, "epnp", 252)], return_pnp=1)
JAX_CPU_HOST_FLOW = dict(ok=25, lost=0, ate_m=0.004600, n_kf=13,
                         walker=[8, 10, 11, 12, 13, 14, 15, 16, 17, 18])
HOST_FLOW_PAIR = 12              # [15c]'s frame pair held against the CPU
FLOW_CARD_TOL_PX = 1e-2
BLUR_GATE_FRAMES = 4
# Canvases for the FAST kernel's edges (its tiles are 64 x 32 px): name,
# H, W, the true extent of each level, and the values in it: "uniform" in
# [0, 255), "integer" (multiples of 16 in [0, 48], for NMS ties) or
# "signed" (uniform in [-100, 155), which takes the kernel's float path).
FAST_EDGE_CASES = (
    ("extents at the tile size -1/0/+1", 70, 132,
     ((31, 63), (32, 64), (33, 65)), "uniform"),
    ("extent + 3 on a tile seam", 96, 192, ((61, 125), (29, 61)), "uniform"),
    ("W % 4 != 0", 123, 161, ((123, 161), (64, 97)), "uniform"),
    ("integer, W % 4 == 0", 100, 200, ((100, 200), (70, 129)), "integer"),
    ("integer, W % 4 != 0", 99, 133, ((99, 133), (61, 125)), "integer"),
    ("negative samples", 96, 200, ((96, 200), (70, 129)), "signed"),
)


def fast_edge_cases(torch, device, seed=3):
    """[(name, canvas [L, H, W] f32, hw [L, 2] i32)] of FAST_EDGE_CASES on
    ``device``: each level random in its extent and zero beyond it (the
    kernel's contract), from a numpy seed."""
    rng = np.random.RandomState(seed)
    cases = []
    for name, H, W, exts, values in FAST_EDGE_CASES:
        canvas = np.zeros((len(exts), H, W), np.float32)
        for l, (h, w) in enumerate(exts):
            if values == "integer":
                canvas[l, :h, :w] = rng.randint(0, 4, (h, w)) * 16.0
            else:
                canvas[l, :h, :w] = rng.rand(h, w) * 255 - (
                    100.0 if values == "signed" else 0.0)
        cases.append((name, torch.from_numpy(canvas).to(device),
                      torch.tensor(exts, dtype=torch.int32, device=device)))
    return cases


def ptxas_report(lib):
    """The lines of a built library's ``-Xptxas -v`` report that give each
    kernel's registers, shared memory and spills."""
    text = lib.with_name(f"{lib.stem}.ptxas.txt").read_text()
    return [line.strip() for line in text.splitlines()
            if "Used" in line or "spill" in line or "Compiling" in line]


def _fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def track_frames(rt, frames, lo, hi):
    """Track frames lo..hi-1 of a looped sequence ``frames = (gray, depth,
    boxes)`` at 30 fps stamps, then wait for the card."""
    gray, depth, boxes = frames
    for i in range(lo, hi):
        k = i % len(gray)
        rt.track(gray[k], depth[k], stamp=i / 30.0, boxes=boxes[k][None])
    rt.block()


@contextlib.contextmanager
def count_host_syncs(torch):
    """Count the host synchronisations made inside the block. Yields a dict
    that is filled, on exit, with the count at each source line."""
    sites = {}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield sites
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites.update(sync_sites(caught))


@contextlib.contextmanager
def _plain_fast(fast, fast_cuda):
    """Route the extractor's FAST call to the plain version (comparison
    runs only)."""
    orig = fast_cuda.strength_and_score
    fast_cuda.strength_and_score = fast.strength_and_score_plain
    try:
        yield
    finally:
        fast_cuda.strength_and_score = orig


def _events(torch):
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def l2_flush(torch):
    """A callable that writes L2_FLUSH_BYTES on the card, evicting L2 (the
    last of those lines stay in L2, dirty, and the timed call pays for
    writing them back)."""
    buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    return lambda: buf.fill_(1.0)


def _device_ms(torch, fn, n, flush=None):
    """Median over n calls of one call's time on the card (CUDA events).

    Each call is queued behind a device-side sleep that outlasts the call's
    host work, so the card meets the call's whole work already queued: the
    events time the device's work alone, not the host's dispatch. With
    ``flush`` (from ``l2_flush``), it runs after the sleep and before the
    first event, so the call starts with a cold L2.
    """
    pre = flush or (lambda: None)
    for _ in range(5):
        pre()
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    a, b = _events(torch)
    a.record()
    torch.cuda._sleep(10 ** 7)
    b.record()
    b.synchronize()
    cycles = int(10 ** 7 / a.elapsed_time(b) * (2.0 * host_ms + 1.0))
    times = []
    for _ in range(n):
        a, b = _events(torch)
        torch.cuda._sleep(cycles)
        pre()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def stereo_config(config):
    """[11]'s SystemConfig from either package's config module: ORB and
    limits at their defaults, a keyframe at least every 10 frames."""
    return config.SystemConfig(
        camera=config.CameraConfig(bf=STEREO_BF),
        tracking=config.TrackingConfig(max_frames_between_kf=10),
        sensor="stereo")


def mono_config(config):
    """[12]'s SystemConfig from either package's config module."""
    return config.SystemConfig(
        tracking=config.TrackingConfig(max_frames_between_kf=10),
        sensor="monocular", use_dynamic_filtering=False)


def stereo_blurred(i):
    """Whether frame i of [11] lies in the blur window."""
    return STEREO_BLUR[0] <= i < STEREO_BLUR[1]


def stereo_scene(torch, synthetic, replica, cam, device, n=N_STEREO):
    """The first ``n`` of [11]'s frames on ``device`` with the port's
    renderer: (left, right, boxes) with the walker's box as a [1, 4] numpy
    array (None when out of view), the right image rendered from the pose
    shifted by the baseline, and the ground-truth camera centres."""
    planes = synthetic.make_room(seed=0, device=device)
    walker = synthetic.make_walker(**STEREO_WALKER, device=device)
    poses = replica.walking_trajectory(N_STEREO, seed=3)[:n]
    shift = torch.tensor([cam.baseline, 0.0, 0.0], dtype=torch.float32)
    frames = []
    for i, p in enumerate(poses):
        gl, _, box, _ = synthetic.render(cam, p, planes, walker, i)
        gr = synthetic.render(cam, type(p)(p.R, p.t - shift), planes, walker,
                              i)[0]
        if stereo_blurred(i):
            gl, gr = (torch.from_numpy(replica.box_blur(
                x.cpu().numpy(), STEREO_BLUR[2])).to(device) for x in (gl, gr))
        b = box.cpu().numpy()[None]
        frames.append((gl, gr, b if b[0, 0] >= 0 else None))
    gt = np.asarray([-p.R.numpy().T @ p.t.numpy() for p in poses])
    return frames, gt


def mono_scene(synthetic, cam, device, n=N_MONO):
    """The first ``n`` of [12]'s grey frames on ``device`` and the
    ground-truth centres."""
    planes = synthetic.make_room(seed=0, device=device)
    poses = synthetic.camera_trajectory(N_MONO, radius=MONO_RADIUS)[:n]
    frames = [synthetic.render(cam, p, planes)[0] for p in poses]
    gt = np.asarray([-p.R.numpy().T @ p.t.numpy() for p in poses])
    return frames, gt


def mono_summary(ok, est, gt, ate):
    """[12]'s gates' numbers: the first tracked frame, the frames lost after
    it, and the Sim3-aligned ATE over the tracked frames."""
    n = len(ok)
    first = int(np.argmax(ok)) if ok.any() else n
    sel = np.nonzero(ok)[0]
    rmse = float(ate.ate_rmse(sel / 30.0, est[sel], np.arange(n) / 30.0, gt,
                              with_scale=True)["rmse"]) if len(sel) >= 3 \
        else float("nan")
    return {"first_ok": first,
            "lost_after": int((n - first) - ok[first:].sum()),
            "ok": int(ok.sum()), "n": n, "ate_sim3_m": rmse}


def bank_dispatches(rec, which):
    """Host ms and device span of the dispatches of a ``time_dispatches``
    record that applied a bank closure (``which`` 2) or a bank
    relocalization (3)."""
    return [(round(r[0], 2), round(r[1].elapsed_time(r[2]), 2))
            for r in rec if bool(r[5][which] != r[4][which])]


def replica_host_frames(replica, n, device):
    """[13]'s scene: the first ``n`` frames of the replica schedule rendered
    on ``device``, as (stamp, grey uint8, depth float metres = d16 / 5000
    as io/tum.load_frame reads it, the walker boxes through the text's
    %.1f or None), and the ground-truth camera centres from the
    ground-truth lines."""
    frames, gt = [], []
    for f in replica.generate(**HOST_SCHEDULE, frames=range(n),
                              device=device):
        depth = f.depth.astype(np.float32) / replica.DEPTH_FACTOR
        frames.append((f.stamp, f.gray, depth,
                       f.boxes if len(f.boxes) else None))
        gt.append([float(x) for x in f.gt_line.split()[1:4]])
    return frames, np.asarray(gt)


def run_host(sysm, frames):
    """Drive a host System over ``frames``; returns the per-frame states
    (in realtime mode, where a call returns an earlier frame's state, they
    come from the trajectory records' lost flags)."""
    states = []
    for stamp, g, d, b in frames:
        states.append(sysm.track_rgbd(g, d, stamp=stamp, boxes=b)[0])
    sysm.shutdown()
    if sysm.tracker.pipelined:
        states = ["LOST" if r[-1] else "OK"
                  for r in sysm.tracker.traj_relative]
    return states


def host_summary(sysm, states, gt_stamps, gt, ate):
    """[13]'s gates' numbers: frames OK and lost, the ATE of the tracked
    trajectory (tests/test_tum_replica.py::test_host_path_ate), keyframes
    and live points, and the mapper's culls and local BAs."""
    traj = sysm.tracker.trajectory
    stamps = np.asarray([s for s, _, _ in traj])
    est = np.asarray([-R.T @ t for _, R, t in traj])
    rmse = float(ate.ate_rmse(stamps, est, np.asarray(gt_stamps),
                              gt)["rmse"])
    m = sysm.map
    out = {"ok": states.count("OK"), "lost": len(states) - states.count("OK"),
           "n": len(states), "ate_m": rmse,
           "n_kf": int(len(m.valid_keyframes())),
           "live_points": int(len(m.valid_points()))}
    mp = getattr(sysm, "mapper", None)
    if mp is not None and hasattr(mp, "n_local_ba"):
        out.update(culled_kf=mp.n_culled_kf, culled_pt=mp.n_culled_pt,
                   local_ba=mp.n_local_ba)
    return out


def driver_summary(out):
    """The gates' numbers of an offline-driver run (``run_tum_rgbd.run``'s
    dict, or cpu_reference.py's like one from the JAX package): frames,
    ATE and keyframes; host mode frames OK and lost and live points;
    realtime mode frames OK and, refined, the keyframes optimised and
    the refined ATE."""
    nan = float("nan")
    s = {"n": out["n"],
         "ate_m": float(out["ate"]["rmse"]) if out["ate"] else nan}
    if out["mode"] == "host":
        states, m = out["states"], out["system"].map
        ok = states.count("OK")
        s.update(ok=ok, lost=len(states) - ok,
                 n_kf=int(len(m.valid_keyframes())),
                 live_points=int(len(m.valid_points())))
    else:
        res = out["result"]
        s.update(ok=int(np.asarray(res["ok"]).sum()), n_kf=int(res["n_kf"]))
        if "n_opt" in out:
            r2 = out["refined_ate"]
            s.update(n_opt=int(out["n_opt"]),
                     refined_ate_m=float(r2["rmse"]) if r2 else nan)
    return s


def driver_phase(torch, fast_cuda, run, args):
    """One ``run(args)`` on the card (an offline driver's, or
    profile_host.py's host loop): FAST launches and host syncs counted over
    it, the card drained at the end. Returns (what run returns, launches,
    syncs, sync sites, seconds, peak MiB)."""
    fast_cuda.LAUNCHES = 0
    peak_mib(torch)
    torch.cuda.synchronize()
    with count_host_syncs(torch) as sites:
        t0 = time.perf_counter()
        out = run(args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return (out, fast_cuda.LAUNCHES, sum(sites.values()), sites, secs,
            peak_mib(torch))


def example_frames(torch, synthetic, SE3, cam, device, n=N_EXAMPLE):
    """tests/test_example_drivers.py's frames: the room's 0.35 m orbit (30
    poses, the first ``n``), each as a left image and a right one from the
    pose moved by the baseline, as uint8 (the PNGs' contents)."""
    planes = synthetic.make_room(seed=0, device=device)
    poses = synthetic.camera_trajectory(30, radius=0.35)[:n]
    b = np.asarray([cam.baseline, 0.0, 0.0], np.float32)

    def u8(g):
        return np.clip(g.cpu().numpy(), 0, 255).astype(np.uint8)

    out = []
    for p in poses:
        gl = synthetic.render(cam, p, planes)[0]
        right = SE3(p.R, torch.from_numpy(p.t.numpy() - b))
        gr = synthetic.render(cam, right, planes)[0]
        out.append((u8(gl), u8(gr)))
    return out


def write_example_sequences(png, frames, root):
    """``frames`` written as a KITTI stereo sequence (root/kitti: times.txt,
    image_0/, image_1/) and an EuRoC one (root/euroc: mav0/cam0/data.csv
    and data/<ns>.png), as tests/test_example_drivers.py writes them.
    Returns (kitti root, euroc root)."""
    kroot = os.path.join(root, "kitti")
    os.makedirs(os.path.join(kroot, "image_0"))
    os.makedirs(os.path.join(kroot, "image_1"))
    with open(os.path.join(kroot, "times.txt"), "w") as f:
        for i, (gl, gr) in enumerate(frames):
            f.write(f"{i / 10.0:.6f}\n")
            png.write(os.path.join(kroot, "image_0", f"{i:06d}.png"), gl)
            png.write(os.path.join(kroot, "image_1", f"{i:06d}.png"), gr)
    eroot = os.path.join(root, "euroc")
    cam0 = os.path.join(eroot, "mav0", "cam0", "data")
    os.makedirs(cam0)
    ns = [int(1.4e18) + i * 100_000_000 for i in range(len(frames))]
    with open(os.path.join(eroot, "mav0", "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for stamp, (gl, _) in zip(ns, frames):
            f.write(f"{stamp},{stamp}.png\n")
            png.write(os.path.join(cam0, f"{stamp}.png"), gl)
    return kroot, eroot


def walker_detector(config, detector_mod, dyn_cfg, **kw):
    """bench.py's own detector (_own_detector) from either package's
    ``config`` and ``models.detector``: the reduced-width YOLOv5 trained
    on the synthetic walker, ``artifacts/detector_walker.npz``."""
    variables, meta = detector_mod.load_variables_npz(DETECTOR_PATH)
    dcfg = config.DetectorConfig(width_multiple=float(meta["width"]),
                                 **WALKER_DETECTOR)
    return detector_mod.YoloDetector(dcfg, dyn_cfg, variables=variables,
                                     dilate=WALKER_DILATE, **kw)


def mean_best_iou(detect, gray, gt_boxes):
    """bench.py score_selfdetect's box IoU: on every 10th frame, the best
    IoU of ``detect(gray)``'s boxes with the ground-truth walker box,
    averaged over those frames."""
    ious = []
    for i in range(0, len(gray), 10):
        g = np.asarray(gt_boxes[i]).reshape(4)
        best = 0.0
        for b in np.asarray(detect(gray[i])).reshape(-1, 4):
            inter = np.prod(np.maximum(np.minimum(b[2:], g[2:])
                                       - np.maximum(b[:2], g[:2]), 0))
            union = np.prod(b[2:] - b[:2]) + np.prod(g[2:] - g[:2]) - inter
            best = max(best, float(inter / max(union, 1e-9)))
        ious.append(best)
    return float(np.mean(ious))


def refine_report(res, arena, kf_ids, gt, ate, handoff):
    """Accuracy of a refined session (either package's ``eval.ate`` and
    ``slam.handoff``): keyframe ATE before and after global BA, and the
    full trajectory's realtime ATE beside ``refined_trajectory``'s. ``gt``
    holds the ground-truth camera centre of every frame of the session."""
    frames = np.asarray(res["kf_frame"]) - res.get("frames_dropped", 0)
    kf_ids = np.asarray(kf_ids)
    kf_st = frames / 30.0

    def kf_ate(R, t):
        c = -np.einsum("kji,kj->ki", R, t)
        return float(ate.ate_rmse(kf_st, c, kf_st, gt[frames])["rmse"])

    n = len(res["R"])
    st = np.arange(n) / 30.0
    traj = handoff.refined_trajectory(res, arena, kf_ids)
    c_ref = -np.einsum("nji,nj->ni", traj[:, :, :3], traj[:, :, 3])
    return {
        "arena_keyframes": int(len(arena.valid_keyframes())),
        "arena_points": int(len(arena.valid_points())),
        "kf_ate_realtime_m": kf_ate(np.asarray(res["kf_R"]),
                                    np.asarray(res["kf_t"])),
        "kf_ate_refined_m": kf_ate(arena.kf_R[kf_ids], arena.kf_t[kf_ids]),
        "ate_realtime_m": float(ate.ate_rmse(st, centres(res), st,
                                             gt[:n])["rmse"]),
        "ate_refined_m": float(ate.ate_rmse(st, c_ref, st, gt[:n])["rmse"]),
    }


def maint_line(res):
    return (f"loops closed {res['n_loops_closed']} of "
            f"{res['n_loop_events']} events (bank {res['n_bank_loops']}), "
            f"relocalizations {res['n_relocalizations']} (bank "
            f"{res['n_bank_reloc']}), bank entries {res['bank_entries']}")


def conv_flops(torch, model, x):
    """Multiply-add operations (x2) of the model's convolutions on ``x``."""
    total = [0]

    def hook(mod, inp, out):
        total[0] += 2 * out.numel() * mod.weight[0].numel()

    hs = [m.register_forward_hook(hook) for m in model.modules()
          if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        model(x)
    for h in hs:
        h.remove()
    return total[0]


def device_kernels(torch, fn):
    """Device events (kernels, copies, fills) of one call of ``fn``, from
    torch.profiler, and the sum of their times in ms."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(ev), sum(e.time_range.elapsed_us() for e in ev) / 1e3


def peak_mib(torch):
    """Peak device memory since the last reset, in MiB; resets it."""
    mib = torch.cuda.max_memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    return mib


def _vocabulary_of(extractor, vocabulary, cfg, frames, which, kw):
    """A scene's own vocabulary from its frames on the card."""
    descs = []
    for i in which:
        f = extractor.extract(frames[i][0], cfg.orb)
        descs.append(f.desc[f.valid].cpu().numpy())
    return scene_vocabulary(vocabulary, descs, **kw)


def host_loop_phase(torch, fast_cuda, extractor, vocabulary, System,
                    GlobalBA, ate, config, synthetic, frames, gt, card_line):
    """[14a]: System(vocabulary=) over the loop circuit's frames on the
    card. Returns (FAST launches, frames)."""
    cfg = host_loop_config(config)
    t0 = time.perf_counter()
    voc = _vocabulary_of(extractor, vocabulary, cfg, frames,
                         HOST_LOOP_VOCAB_FRAMES, HOST_LOOP_VOCAB)
    print(f"[14a] scene vocabulary ({voc.n_words} words) trained in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    sysm = System(cfg, vocabulary=voc)
    lc = sysm.loop_closer
    lc._global_ba = GlobalBA(cfg)
    rec = watch_calls([], lc, ("compute_sim3", "correct", "run_pose_graph"))
    watch_calls(rec, lc._global_ba, ("run",))
    fast_cuda.LAUNCHES = 0
    peak_mib(torch)
    torch.cuda.synchronize()
    with count_host_syncs(torch) as sites:
        t0 = time.perf_counter()
        states, pre, closed_at = run_host_loop(sysm, frames)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches, mem = fast_cuda.LAUNCHES, peak_mib(torch)
    s = host_loop_summary(sysm, states, pre, closed_at, gt, ate)
    closures = closure_stages(rec)
    n, syncs = s["n"], sum(sites.values())
    j = JAX_CPU_HOST_LOOP
    print(f"[14a] host loop closing (JAX package on CPU in brackets): frames "
          f"OK {s['ok']}/{n} ({j['ok']}), keyframes {s['n_kf']} "
          f"({j['n_kf']}), loops {s['loops']} ({j['loops']}) first closed "
          f"on frame {s['closed_at']} ({j['closed_at']}; gate >= "
          f"{HOST_LOOP_FIRST_MIN}), loop edges {s['loop_edges']} "
          f"({list(j['loop_edge'])}), fused edges {s['fused_edges']} "
          f"({j['fused_edges']}), ATE before the closure "
          f"{s['ate_pre_m'] * 100 if s['ate_pre_m'] else float('nan'):.3f} "
          f"cm ({j['ate_pre_m'] * 100:.3f}), exported "
          f"{s['ate_post_m'] * 100:.3f} cm ({j['ate_post_m'] * 100:.3f}; "
          f"gate < {HOST_LOOP_GAIN} x before)", flush=True)
    for c in closures:
        print(f"[14a] closure stall (host ms): compute_sim3 "
              f"{c['compute_sim3_ms']:.1f}, correct "
              f"{c.get('correct_own_ms', 0):.1f} + pose graph "
              f"{c.get('pose_graph_ms', 0):.1f} + global BA "
              f"{c.get('global_ba_ms', 0):.1f}; host syncs compute_sim3 "
              f"{c['compute_sim3_syncs']}, correct {c.get('correct_syncs', 0)}"
              f" (pose graph {c.get('pose_graph_syncs', 0)}, global BA "
              f"{c.get('global_ba_syncs', 0)}); correct's sync sites "
              f"{c.get('sites', {})}", flush=True)
    print(f"[14a] FAST launches {launches} for {n} frames; host syncs {syncs}"
          f" = {syncs / n:.2f} per frame {sites}; {n} frames in {secs:.1f} s "
          f"({n / secs:.2f} fps, the card drained at the end); peak device "
          f"memory {mem:.1f} MiB; on {card_line}", flush=True)
    bad = host_loop_failures(s)
    if launches != n:
        bad.append(f"{launches} FAST launches for {n} frames")
    if bad:
        _fail(f"host loop closing: {bad}")
    return launches, n


def host_reloc_phase(torch, fast_cuda, extractor, vocabulary, frame_mod,
                     fundamental, pnp, System, config, synthetic, dev,
                     card_line):
    """[14b]: System(vocabulary=) over the blackout scene on the card, the
    System's Relocalizer on the return frame (both branches), and one
    RANSAC EPnP at the relocalizer's shapes against the CPU. Returns
    (FAST launches, frames)."""
    cfg = host_reloc_config(config)
    planes = synthetic.make_room(seed=0, device=dev)
    poses = synthetic.camera_trajectory(**HOST_RELOC_ORBIT)
    frames = [synthetic.render(cfg.camera, p, planes)[:2] for p in poses]
    voc = _vocabulary_of(extractor, vocabulary, cfg, frames,
                         HOST_RELOC_VOCAB_FRAMES, HOST_RELOC_VOCAB)
    sysm = System(cfg, vocabulary=voc)
    rec = watch_calls([], sysm.relocalizer,
                      RELOC_ATTEMPTS["port"] + ("relocalize",))
    black = (torch.zeros_like(frames[0][0]), torch.ones_like(frames[0][1]))
    np_pose = lambda p: (p.R.numpy(), p.t.numpy())
    Rg, tg = reloc_truth(*np_pose(poses[0]),
                         *np_pose(poses[HOST_RELOC_RETURN]))
    fast_cuda.LAUNCHES = 0
    torch.cuda.synchronize()
    with count_host_syncs(torch) as sites:
        s = run_host_reloc(sysm, frames, black, Rg, tg)
        torch.cuda.synchronize()
    launches = fast_cuda.LAUNCHES
    n = HOST_RELOC_TRACK + HOST_RELOC_BLACK + 1
    s["reloc"] = reloc_calls(rec)
    fd, flat, words = depth_free_frames(torch, frame_mod, sysm, cfg,
                                        *frames[HOST_RELOC_RETURN])
    for branch, f in (("horn", fd), ("epnp", flat)):
        del rec[:]
        torch.cuda.synchronize()
        with count_host_syncs(torch):
            s[f"direct_{branch}"] = reloc_direct(sysm, f, words, Rg, tg)
        s[f"direct_{branch}"].update(reloc_calls(rec)[0])
    j = JAX_CPU_HOST_RELOC
    calls = [(c["candidates_tried"], c["branch"], c["ok"])
             for c in s["reloc"]]
    print(f"[14b] host relocalization (JAX package on CPU in brackets): "
          f"before the blackout {s['before']} with {s['n_kf_before']} "
          f"keyframes ({j['n_kf_before']}), after it {s['after_black']}, "
          f"on the return {s['return']} with {s['n_inliers']} inliers "
          f"({j['states']}, {j['return_inliers']}), camera centre off by "
          f"{s['centre_err_m'] * 100:.3f} cm ({j['centre_err_m'] * 100:.3f};"
          f" limit {HOST_RELOC_LIMIT_M * 100:.0f} cm), the return frame "
          f"{s['return_ms']:.1f} ms; relocalize calls (candidates tried, "
          f"branch, ok) {calls} ({j['reloc_calls']}); FAST launches "
          f"{launches} for {n} frames; host syncs {sum(sites.values())} "
          f"{sites}", flush=True)
    for branch in ("horn", "epnp"):
        d, jd = s[f"direct_{branch}"], j[f"direct_{branch}"]
        print(f"[14b] the Relocalizer on the return frame, {branch} branch "
              f"({d['branch']}): ok {d['ok']}, {d['candidates_tried']} "
              f"candidates tried, {d['n_inliers']} inliers "
              f"({jd['inliers']}), centre off by "
              f"{(d['centre_err_m'] or float('nan')) * 100:.3f} cm "
              f"({jd['centre_err_m'] * 100:.3f}), {d['ms']:.1f} ms, host "
              f"syncs {d['syncs']} {d['sites']}", flush=True)
    bad = host_reloc_failures(s, cfg.tracking.reset_if_lost_with_kfs_below)
    if launches != n:
        bad.append(f"{launches} FAST launches for {n} frames")
    if bad:
        _fail(f"host relocalization: {bad}")

    # One RANSAC EPnP at the relocalizer's shapes, card against CPU.
    H, k, N = (EPNP_SHAPE[x] for x in ("n_hypotheses", "sample", "n"))
    X, uv, _, _ = pnp_scene(cfg.camera, 11, N, noise_px=0.3,
                            outlier_frac=0.3)
    valid = torch.ones(N, dtype=torch.bool)
    idx = fundamental.sample_indices(valid, H, torch.Generator()
                                     .manual_seed(0), k=k)
    args = [torch.from_numpy(a) for a in (X, uv)] + [valid]
    cpu = pnp.ransac_epnp(*args, cfg.camera, idx)
    dargs = [a.to(dev) for a in args]
    didx = idx.to(dev)
    run = lambda: pnp.ransac_epnp(*dargs, cfg.camera, didx)
    card_res = run()
    torch.cuda.synchronize()
    with count_host_syncs(torch) as ep_sites:
        run()
    ep_ms = _device_ms(torch, run, 10)
    dR = float((card_res.R.cpu() - cpu.R).abs().max())
    dt = float((card_res.t.cpu() - cpu.t).abs().max())
    same = bool(torch.equal(card_res.inliers.cpu(), cpu.inliers))
    print(f"[14b] ransac_epnp ({H} hypotheses of {k}, {N} correspondences, "
          f"30 % outliers, the same indices): card vs CPU R {dR:.3g}, t "
          f"{dt:.3g} (tolerance {EPNP_CARD_TOL:g}), inliers "
          f"{int(card_res.n_inliers)} / {int(cpu.n_inliers)}, sets equal "
          f"{same}; {ep_ms:.3f} ms between CUDA events (median of 10, queued "
          f"behind a device-side sleep; its host syncs let the host's "
          f"dispatch show after each), host syncs per call "
          f"{sum(ep_sites.values())} {ep_sites}; on {card_line}", flush=True)
    if not same or max(dR, dt) > EPNP_CARD_TOL or not np.isfinite(ep_ms):
        _fail(f"ransac_epnp card vs CPU: R {dR}, t {dt}, inliers {same}")
    return launches, n


def host_stereo_phase(torch, fast_cuda, config, synthetic, System, ate,
                      dev, card_line):
    """[15a]: System(SystemConfig(sensor="stereo")).track_stereo over the
    stereo room's 40 frames on the card. Returns (FAST launches, frames)."""
    cfg = host_stereo_config(config)
    planes = synthetic.make_room(seed=0, device=dev)
    poses = synthetic.camera_trajectory(**HOST_STEREO_ORBIT)
    frames = host_stereo_frames(
        lambda p: synthetic.render(cfg.camera, p, planes)[0], poses,
        cfg.camera, torch.from_numpy)
    sysm = System(cfg)
    fast_cuda.LAUNCHES = 0
    peak_mib(torch)
    torch.cuda.synchronize()
    with count_host_syncs(torch) as sites:
        t0 = time.perf_counter()
        states = run_host_stereo(sysm, frames)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches, mem = fast_cuda.LAUNCHES, peak_mib(torch)
    s = host_stereo_summary(sysm, states, pose_centres(poses), ate)
    n, syncs = s["n"], sum(sites.values())
    j = JAX_CPU_HOST_STEREO
    print(f"[15a] host stereo (JAX package on CPU in brackets): frame 0 "
          f"{s['first']}, frames not OK {s['not_ok']} ({j['not_ok']}; gate "
          f"<= {HOST_STEREO_MAX_NOT_OK}), ATE {s['ate_m'] * 100:.3f} cm "
          f"({j['ate_m'] * 100:.3f}; limit {HOST_STEREO_ATE_LIMIT_M * 100:.0f}"
          f" cm), keyframes {s['n_kf']} ({j['n_kf']}), live points "
          f"{s['live_points']} ({j['live_points']}); FAST launches "
          f"{launches} for {n} frames; host syncs {syncs} = {syncs / n:.2f} "
          f"per frame {sites}; {n} frames in {secs:.1f} s ({n / secs:.2f} "
          f"fps, the card drained at the end); peak device memory "
          f"{mem:.1f} MiB; on {card_line}", flush=True)
    bad = host_stereo_failures(s)
    if launches != 2 * n:
        bad.append(f"{launches} FAST launches for {n} frames")
    if bad:
        _fail(f"host stereo: {bad}")
    return launches, n


def host_mono_phase(torch, fast_cuda, config, extractor, vocabulary,
                    initializer_ops, frame_mod, System, ate, mono_frames,
                    mono_gt, card_line):
    """[15b]: System(vocabulary=).track_monocular over [12]'s first
    HOST_MONO_TRACK frames, a blackout and a return, on the card; one
    initialisation attempt timed; the System's Relocalizer on the return
    frame (EPnP: no depth). Returns (FAST launches, frames)."""
    cfg = host_mono_config(config)
    frames = mono_frames[:HOST_MONO_TRACK]
    t0 = time.perf_counter()
    voc = _vocabulary_of(extractor, vocabulary, cfg, [(g,) for g in frames],
                         HOST_MONO_VOCAB_FRAMES, HOST_MONO_VOCAB)
    print(f"[15b] scene vocabulary ({voc.n_words} words) trained in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    sysm = System(cfg, vocabulary=voc)
    rec = watch_calls([], sysm.relocalizer,
                      RELOC_ATTEMPTS["port"] + ("relocalize",))
    calls, fit = [], initializer_ops.reconstruct_graph

    def kept(*a, **kw):
        calls.append((a, kw))
        return fit(*a, **kw)

    initializer_ops.reconstruct_graph = kept
    fast_cuda.LAUNCHES = 0
    peak_mib(torch)
    torch.cuda.synchronize()
    try:
        with count_host_syncs(torch) as sites:
            t0 = time.perf_counter()
            s = run_host_mono(sysm, frames, torch.zeros_like(frames[0]),
                              mono_gt[:HOST_MONO_TRACK], ate)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    finally:
        initializer_ops.reconstruct_graph = fit
    launches, mem = fast_cuda.LAUNCHES, peak_mib(torch)
    n = HOST_MONO_TRACK + HOST_MONO_BLACK + 1
    attempts = sysm.tracker.init_attempts
    done = [k for k, a in enumerate(attempts) if a["ok"]]
    init_ms = init_syncs = float("nan")
    if done:
        a, kw = calls[done[0]]
        one = lambda: fit(*a, **kw)
        init_ms = _device_ms(torch, one, 20)
        torch.cuda.synchronize()
        with count_host_syncs(torch) as one_sites:
            one()
            torch.cuda.synchronize()
        init_syncs = sum(one_sites.values())
    reloc = reloc_calls(rec)
    # The Relocalizer on the return frame, against frame 12's own earlier
    # pose.
    del rec[:]
    g = frames[HOST_MONO_RETURN]
    fd = frame_mod.process_rgbd(g, torch.zeros_like(g), cfg.camera, cfg.orb)
    words = sysm._words(fd.feats.desc, fd.feats.valid)
    _, R12, t12 = sysm.tracker.trajectory[HOST_MONO_RETURN]
    torch.cuda.synchronize()
    with count_host_syncs(torch):
        s["direct_epnp"] = d = reloc_direct(sysm, fd, words, R12, t12)
    d.update(reloc_calls(rec)[0])
    j = JAX_CPU_HOST_MONO
    init = attempts[done[0]] if done else {}
    print(f"[15b] host mono (JAX package on CPU in brackets): initialised on "
          f"frame {round(init.get('stamp', -1) * 30)} with "
          f"{'H' if init.get('homography') else 'F'} ({j['init']}), "
          f"{len(attempts)} attempts {attempts}; first OK {s['first_ok']} "
          f"({j['first_ok']}; gate <= {HOST_MONO_FIRST_OK_MAX}), lost after "
          f"it {s['lost_after']} ({j['lost_after']}; gate <= "
          f"{HOST_MONO_MAX_LOST_AFTER}), live points {s['live_points']} "
          f"({j['live_points']}; gate > {HOST_MONO_MIN_POINTS}), keyframes "
          f"{s['n_kf']} ({j['n_kf']}), Sim3 ATE {s['ate_sim3_m'] * 100:.3f} "
          f"cm ({j['ate_sim3_m'] * 100:.3f}; limit "
          f"{HOST_MONO_ATE_LIMIT_M * 100:.0f} cm); after the blackout "
          f"{s['after_black']}, on the return {s['return_state']} with "
          f"{s['return_inliers']} inliers, centre "
          f"{s['return_err_m'] * 100:.3f} cm from frame {HOST_MONO_RETURN}'s "
          f"({j['blackout']}; limit {HOST_MONO_RETURN_LIMIT_M * 100:.0f} cm)",
          flush=True)
    print(f"[15b] relocalize calls (ok, candidates tried, branch, inliers, "
          f"host ms, syncs): "
          f"{[(c['ok'], c['candidates_tried'], c['branch'], c['n_inliers'], round(c['ms'], 1), c['syncs']) for c in reloc]} "
          f"({j['reloc']}); the return frame {s['return_ms']:.1f} ms; one "
          f"initialisation attempt (reconstruct_graph, "
          f"{cfg.ransac.init_iterations} H and F hypotheses) {init_ms:.3f} "
          f"ms between CUDA events (median of 20, queued behind a "
          f"device-side sleep; {init_syncs} host syncs); FAST launches "
          f"{launches} for {n} frames; host syncs {sum(sites.values())} = "
          f"{sum(sites.values()) / n:.2f} per frame {sites}; {n} frames in "
          f"{secs:.1f} s; peak device memory {mem:.1f} MiB; on {card_line}",
          flush=True)
    jd = j["direct_epnp"]
    print(f"[15b] the Relocalizer on the return frame ({d['branch']} "
          f"branch): ok {d['ok']} ({jd['ok']}), {d['candidates_tried']} "
          f"candidates tried ({jd['candidates_tried']}), {d['n_inliers']} "
          f"inliers ({jd['n_inliers']}), centre "
          f"{(d['centre_err_m'] or float('nan')) * 100:.3f} cm from frame "
          f"{HOST_MONO_RETURN}'s ({jd['centre_err_m'] * 100:.3f}), "
          f"{d['ms']:.1f} ms, host syncs {d['syncs']} {d['sites']}; on "
          f"{card_line}", flush=True)
    bad = host_mono_failures(s)
    if launches != n:
        bad.append(f"{launches} FAST launches for {n} frames")
    if bad:
        _fail(f"host mono: {bad}")
    return launches, n


def host_epnp_phase(torch, fast_cuda, config, extractor, vocabulary,
                    synthetic, System, ate, dev, card_line):
    """[21]: the host mono System's recovery through the Relocalizer's EPnP
    branch (host_sensor_scenes.py): [15b]'s configuration at full width
    over frames 0-45 of the 1.2 m orbit, a blackout, then frame 15 again,
    beyond the fused step's widened gate. Returns (FAST launches, frames, the
    System, the true centre of a keyframe of its map)."""
    cfg = host_mono_config(config)
    frames, gt = host_epnp_frames(synthetic, cfg.camera, dev)
    t0 = time.perf_counter()
    voc = _vocabulary_of(extractor, vocabulary, cfg, [(g,) for g in frames],
                         HOST_EPNP_VOCAB_FRAMES, HOST_MONO_VOCAB)
    print(f"[21] scene vocabulary ({voc.n_words} words) trained in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    sysm = System(cfg, vocabulary=voc)
    rec = watch_calls([], sysm.relocalizer,
                      RELOC_ATTEMPTS["port"] + ("relocalize",))
    mark = []
    fast_cuda.LAUNCHES = 0
    torch.cuda.synchronize()
    with count_host_syncs(torch) as sites:
        t0 = time.perf_counter()
        s = run_host_mono(sysm, frames, torch.zeros_like(frames[0]), gt,
                          ate, HOST_EPNP_RETURN,
                          before_return=lambda: mark.append(len(rec)))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = fast_cuda.LAUNCHES
    n = HOST_EPNP_TRACK + HOST_MONO_BLACK + 1
    back = rec[mark[0]:]
    s["return_reloc"] = calls = reloc_calls(back)
    s["return_pnp"] = sum("pnp" in r[0] for r in back)
    j = JAX_CPU_HOST_EPNP
    last = calls[-1] if calls else {}
    print(f"[21] host mono kidnap beyond the widened gate (frames 0-"
          f"{HOST_EPNP_TRACK - 1}, {HOST_MONO_BLACK} black, frame "
          f"{HOST_EPNP_RETURN} again; JAX package on CPU in brackets): first "
          f"OK {s['first_ok']} ({j['first_ok']}), lost after it "
          f"{s['lost_after']} ({j['lost_after']}), last tracked frame "
          f"{s['last']}, keyframes {s['n_kf']} ({j['n_kf']}), Sim3 ATE "
          f"{s['ate_sim3_m'] * 100:.3f} cm ({j['ate_sim3_m'] * 100:.3f}); "
          f"after the blackout {s['after_black']}, on the return "
          f"{s['return_state']} with {s['return_inliers']} inliers "
          f"({j['return_inliers']}), centre {s['return_err_m'] * 100:.3f} cm "
          f"from frame {HOST_EPNP_RETURN}'s ({j['return_err_m'] * 100:.3f}; "
          f"limit {HOST_MONO_RETURN_LIMIT_M * 100:.0f} cm)", flush=True)
    print(f"[21] the return frame's relocalize calls (ok, candidates tried, "
          f"branch, inliers): "
          f"{[(c['ok'], c['candidates_tried'], c['branch'], c['n_inliers']) for c in calls]} "
          f"({j['return_reloc']}); EPnP RANSACs (ransac_epnp calls) "
          f"counted {s['return_pnp']} ({j['return_pnp']}); the recovering "
          f"relocalize call {last.get('ms', float('nan')):.1f} ms with "
          f"{last.get('syncs')} host syncs {last.get('sites')}; the whole "
          f"return frame {s['return_ms']:.1f} ms; FAST launches {launches} "
          f"for {n} frames; host syncs {sum(sites.values())} in {n} frames; "
          f"{secs:.1f} s; on {card_line}", flush=True)
    bad = host_epnp_failures(s)
    if launches != n:
        bad.append(f"{launches} FAST launches for {n} frames")
    if bad:
        _fail(f"host EPnP recovery: {bad}")
    return launches, n, sysm, lambda k: gt[host_mono_frame_of(
        round(sysm.map.kf_stamp[k] * 30), HOST_EPNP_TRACK, HOST_EPNP_RETURN)]


def mono_loop_phase(torch, fast_cuda, GlobalBA, ate, sysm, gt_of_kf,
                    card_line):
    """[20]: the monocular Sim3 loop closure on the card, on [21]'s map
    drifted in scale (host_sensor_scenes.drift_late_keyframes): the newest
    keyframe closed against the oldest through the System's loop closer.
    Returns its FAST launches (none: it processes no image)."""
    lc, m = sysm.loop_closer, sysm.map
    lc._global_ba = GlobalBA(sysm.cfg)
    rec = watch_calls([], lc, ("compute_sim3", "correct", "run_pose_graph"))
    watch_calls(rec, lc._global_ba, ("run",))
    sites = {}

    @contextlib.contextmanager
    def counted():
        torch.cuda.synchronize()
        with count_host_syncs(torch) as found:
            yield
            torch.cuda.synchronize()
        sites.update(found)

    fast_cuda.LAUNCHES = 0
    out = run_mono_loop(sysm, ate, gt_of_kf, around=counted)
    launches = fast_cuda.LAUNCHES
    before, drifted, after = out["before_m"], out["drifted_m"], out["after_m"]
    moved, secs = out["moved"], out["close_s"]
    stages = closure_stages(rec)
    kfs = m.valid_keyframes()
    oldest = int(kfs[np.argmin(m.kf_seq[kfs])])
    j = JAX_CPU_HOST_MONO_LOOP
    st = stages[0] if stages else {}
    print(f"[20] monocular Sim3 closure on [21]'s map ({len(kfs)} keyframes; "
          f"{len(moved)} moved with their points, {out['n_copies']} points "
          f"copied, by a similarity of scale {HOST_MONO_LOOP_DRIFT['scale']}; "
          f"JAX package on CPU in brackets): pair {out['pair']} "
          f"({j['pair']}), compute_sim3 {out['debug']} ({j['debug']}), S12 "
          f"scale {out.get('scale', float('nan')):.5f} "
          f"({j['scale']:.5f}); keyframe Sim3 ATE {before * 100:.3f} cm, "
          f"drifted {drifted * 100:.3f} ({j['drifted_m'] * 100:.3f}), after "
          f"the closure {after * 100:.3f} ({j['after_m'] * 100:.3f}; gate < "
          f"{HOST_MONO_LOOP_GAIN} x drifted)", flush=True)
    print(f"[20] the closure's stall by stage (host ms, host syncs): "
          f"compute_sim3 {st.get('compute_sim3_ms', float('nan')):.1f} / "
          f"{st.get('compute_sim3_syncs')}, correct's own "
          f"{st.get('correct_own_ms', float('nan')):.1f} / "
          f"{st.get('correct_own_syncs')}, pose graph "
          f"{st.get('pose_graph_ms', float('nan')):.1f} / "
          f"{st.get('pose_graph_syncs')}, global BA "
          f"{st.get('global_ba_ms', float('nan')):.1f} / "
          f"{st.get('global_ba_syncs')}; {secs * 1e3:.1f} ms in all with "
          f"{sum(sites.values())} host syncs; FAST launches {launches} (no "
          f"image); on {card_line}", flush=True)
    if not out["accepted"] or out["pair"][1] != oldest \
            or abs(out["scale"] - HOST_MONO_LOOP_DRIFT["scale"]) > 0.05 \
            or not after < HOST_MONO_LOOP_GAIN * drifted or launches:
        _fail(f"monocular Sim3 closure: {out['debug']}, scale "
              f"{out.get('scale')}, ATE {drifted} -> {after}")
    return launches


def host_flow_phase(torch, fast_cuda, config, synthetic, System, ate,
                    dynamic_mod, lk_flow, fundamental, BlurGate, dev,
                    card_line):
    """[15c]: System with the flow motion check over the walker scene on
    the card; one frame pair's dynamic_frontend against the CPU; lk_flow
    and good_features timed; BlurGate on the card against the CPU. Returns
    (FAST launches, frames)."""
    cfg = host_flow_config(config)
    planes = synthetic.make_room(seed=0, device=dev)
    quad = synthetic.make_walker(**HOST_FLOW_WALKER, device=dev)
    poses = synthetic.camera_trajectory(**HOST_FLOW_ORBIT)[:N_HOST_FLOW]
    frames = host_flow_frames(lambda p, i: synthetic.render(
        cfg.camera, p, planes, quad, i)[:3], poses)
    sysm = System(cfg)
    flags, check = [], sysm._flow_check

    def kept(*a):
        r = check(*a)
        flags.append(r.box_dynamic[0])
        return r

    sysm._flow_check = kept
    fast_cuda.LAUNCHES = 0
    peak_mib(torch)
    torch.cuda.synchronize()
    with count_host_syncs(torch) as sites:
        t0 = time.perf_counter()
        states = run_host_flow(sysm, frames)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches, mem = fast_cuda.LAUNCHES, peak_mib(torch)
    # The first frame has no previous image: the k-th check is on frame k.
    walker = [k + 1 for k, f in enumerate(torch.stack(flags).tolist()) if f]
    s = host_flow_summary(sysm, states, pose_centres(poses), ate, walker)
    n, syncs = s["n"], sum(sites.values())
    j = JAX_CPU_HOST_FLOW
    print(f"[15c] host flow motion check (JAX package on CPU in brackets): "
          f"frames OK {s['ok']}/{n} ({j['ok']}), lost {s['lost']} "
          f"({j['lost']}; gate <= {HOST_FLOW_MAX_LOST}), ATE "
          f"{s['ate_m'] * 100:.3f} cm ({j['ate_m'] * 100:.3f}; limit "
          f"{HOST_FLOW_ATE_LIMIT_M * 100:.0f} cm), walker's box dynamic on "
          f"{len(walker)} frames {walker} ({len(j['walker'])} frames "
          f"{j['walker']}), keyframes {s['n_kf']} ({j['n_kf']}); FAST "
          f"launches {launches} for {n} frames; host syncs {syncs} = "
          f"{syncs / n:.2f} per frame {sites}; {n} frames in {secs:.1f} s "
          f"({n / secs:.2f} fps, the card drained at the end); peak device "
          f"memory {mem:.1f} MiB", flush=True)
    bad = host_flow_failures(s)
    if launches != n:
        bad.append(f"{launches} FAST launches for {n} frames")

    # One frame pair's flow check on the card against the CPU, the same
    # F-RANSAC samples (drawn on the CPU from the correspondence mask).
    k = HOST_FLOW_PAIR
    boxes = torch.from_numpy(sysm._pad_boxes(frames[k + 1][2]))
    draw = lambda valid: fundamental.sample_indices(
        valid.cpu(), cfg.dynamic.f_ransac_iters,
        torch.Generator().manual_seed(0)).to(valid.device)
    res = {}
    for where in ("cpu", dev):
        res[str(where)] = dynamic_mod.dynamic_frontend(
            frames[k][0].to(where), frames[k + 1][0].to(where),
            boxes.to(where), cfg, idx=draw)
    c, g = res["cpu"], res[str(dev)]
    same = {f: bool(torch.equal(getattr(g, f).cpu(), getattr(c, f)))
            for f in ("mask", "box_dynamic", "box_blurred", "outlier_valid")}
    any_tm = g.outlier_valid.cpu() | c.outlier_valid
    gap = float((g.outliers.cpu() - c.outliers).abs().max())
    print(f"[15c] dynamic_frontend on frames {k}, {k + 1}, card vs CPU with "
          f"the same samples: equal {same}, T_M {int(g.n_outliers)} / "
          f"{int(c.n_outliers)}, walker's box dynamic "
          f"{bool(g.box_dynamic[0])}, tracked points max gap {gap:.3g} px "
          f"(tolerance {FLOW_CARD_TOL_PX:g})", flush=True)
    if not (same["mask"] and same["box_dynamic"] and same["box_blurred"]) \
            or not gap < FLOW_CARD_TOL_PX or not bool(any_tm.any()):
        bad.append(f"dynamic_frontend card vs CPU: {same}, gap {gap}")

    # lk_flow and good_features alone, at the path's shapes.
    prev, cur = frames[k][0], frames[k + 1][0]
    n_pts = cfg.dynamic.n_flow_points
    pts = lk_flow.good_features(prev, n_pts)[0]
    pp, cp = lk_flow.build_flow_pyramid(prev), lk_flow.build_flow_pyramid(cur)
    for name, fn in (
            (f"good_features ({n_pts} points, {tuple(prev.shape)})",
             lambda: lk_flow.good_features(prev, n_pts)),
            (f"lk_flow ({n_pts} points, 4 levels, 21x21, 10 steps)",
             lambda: lk_flow.lk_flow(pp, cp, pts))):
        ms = _device_ms(torch, fn, 20)
        n_kern, kern_ms = device_kernels(torch, fn)
        print(f"[15c] {name}: {ms:.4f} ms between CUDA events (median of "
              f"20, queued behind a device-side sleep), {n_kern} device "
              f"kernels per call ({kern_ms:.4f} ms of kernel time, "
              f"profiled); on {card_line}", flush=True)
        if not (np.isfinite(ms) and ms > 0):
            bad.append(f"{name}: time {ms}")

    # BlurGate over the first frames, on the card and on the CPU.
    emits = {}
    for where in ("cpu", dev):
        gate = BlurGate(device=where)
        emits[str(where)] = [
            (e, None if o is None else o[0])
            for e, o in (gate.push(frames[i][0].to(where), stamp=float(i))
                         for i in range(BLUR_GATE_FRAMES))]
    print(f"[15c] BlurGate over frames 0-{BLUR_GATE_FRAMES - 1} (emit, "
          f"stamp): card {emits[str(dev)]}, CPU {emits['cpu']}", flush=True)
    if emits[str(dev)] != emits["cpu"]:
        bad.append("BlurGate emits differ between card and CPU")
    if bad:
        _fail(f"host flow: {bad}")
    return launches, n


def checkpoint_phase(torch, checkpoint, System, SystemConfig, hsys, last,
                     card_line):
    """[15d]: [13]'s finished map saved, loaded into a fresh System in
    localization mode, and [13]'s last frame tracked against it."""
    import tempfile
    cfg = SystemConfig()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.npz")
        t0 = time.perf_counter()
        checkpoint.save_map(path, hsys.map, tracker_state=hsys.tracker.state)
        t1 = time.perf_counter()
        sysm = System(cfg)
        restored = checkpoint.resume(path, sysm)
        t2 = time.perf_counter()
        size = os.path.getsize(path)
    m = sysm.map
    n_kfs = len(m.valid_keyframes())
    stamp, g, d, b = last
    state, n = sysm.track_rgbd(g, d, stamp=stamp + 1.0, boxes=b)
    kept = len(sysm.map.valid_keyframes())
    print(f"[15d] checkpoint of [13]'s map: {size / 2 ** 20:.1f} MiB, saved "
          f"in {t1 - t0:.2f} s, loaded in {t2 - t1:.2f} s, {n_kfs} keyframes "
          f"and {len(m.valid_points())} points; localization mode on "
          f"[13]'s last frame: {state} with {n} inliers (gate > 100), "
          f"keyframes {n_kfs} -> {kept}; on {card_line}", flush=True)
    if not restored or state != "OK" or n <= 100 or kept != n_kfs:
        _fail(f"checkpoint resume: {state}, {n} inliers, keyframes "
              f"{n_kfs} -> {kept}")


def multichip_phase(torch, fast_cuda, orbit_session, handoff, card_line,
                    dev):
    """[17]: the entry step, dryrun_multichip over MULTICHIP_RANKS ranks on
    the card, and the sharded global BA and pose graph of the orbit's
    handed-off arena against their single-rank solves. Returns (the entry
    step's FAST launches, the dry run's dict)."""
    from coebslam_tpu_torch import entry as entry_mod
    from coebslam_tpu_torch.optim import local_ba, pose_graph
    from coebslam_tpu_torch.parallel import multihost, sharded_ba
    ocfg, ores, _ = orbit_session
    opt = ocfg.optimizer
    n = MULTICHIP_RANKS

    # a. the entry step on the card and on the CPU
    fn, args = entry_mod.entry()
    fast_cuda.LAUNCHES = 0
    with torch.no_grad():
        R_e, t_e, n_e = fn(*args)
        torch.cuda.synchronize()
        launches = fast_cuda.LAUNCHES
        fn_c, args_c = entry_mod.entry(device="cpu")
        R_c, t_c, n_c = fn_c(*args_c)
        ms = _device_ms(torch, lambda: fn(*args), 20)
    err = max(float((R_e.cpu() - R_c).abs().max()),
              float((t_e.cpu() - t_c).abs().max()))
    print(f"[17a] entry(): FAST launches {launches}; card vs CPU: pose "
          f"{err:.3g} (tol {ENTRY_POSE_TOL}), inliers {int(n_e)} / "
          f"{int(n_c)} (within 1); {ms:.4f} ms on the card (median of 20, "
          f"queued behind a device-side sleep); on {card_line}", flush=True)
    if launches != 1 or not err <= ENTRY_POSE_TOL \
            or abs(int(n_e) - int(n_c)) > 1:
        _fail(f"entry(): {launches} FAST launches, pose {err}, inliers "
              f"{int(n_e)} / {int(n_c)}")

    # b. the dry run of every multi-device path
    iters = {"a": opt.local_ba_iters_first + opt.local_ba_iters_second,
             "c": opt.global_ba_iters,
             "d": opt.essential_graph_iters, "e_hybrid": opt.global_ba_iters,
             "e_flat": opt.global_ba_iters,
             "e_pose_graph": opt.essential_graph_iters}
    dr = entry_mod.dryrun_multichip(n)
    for part, secs in dr["seconds"].items():
        k = dr["all_reduces"][part]
        comm = (f"{k / iters[part]:.2f} all-reduces per GN iteration, "
                f"{dr['all_reduce_bytes'][part] / k:.0f} bytes each on "
                f"average" if part in iters else "no all-reduce")
        print(f"[17b] dryrun part {part}: {secs:.3f} s on rank 0, {comm}, "
              f"backend {dr['backend']}", flush=True)
    print(f"[17b] dryrun_multichip({n}): per-frame counts {dr['counts']}, "
          f"FAST launches {dr['frontend_launches']}, segment-sharded GBA "
          f"vs 1-D {dr['gba_gap']:.3g} (tol {SHARD_POSE_TOL})", flush=True)
    if dr["frontend_launches"] != n or dr["gba_gap"] > SHARD_POSE_TOL:
        _fail(f"dryrun_multichip: {dr['frontend_launches']} FAST "
              f"launches, gap {dr['gba_gap']}")

    # c. the orbit's handed-off arena, segment-sharded over (2, 2)
    arena, _ = handoff.to_arena(ores, ocfg)
    prob, kfs, pts, seg = multihost.arena_to_ba_problem(
        arena, ocfg, n_segments=2, pad_points_to=2 * n, device="cpu")
    sh = sharded_ba.run_sharded(
        "global", prob, opt, n, cam=ocfg.camera, hybrid=True, dcn_size=2,
        axis=(multihost.DCN_AXIS, multihost.ICI_AXIS),
        n_blocks_per_device=2)
    prob_d = type(prob)(*[x.to(dev) for x in prob])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = local_ba.optimize_global_ba(prob_d, ocfg.camera, opt,
                                      n_blocks=2 * n)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    res = sh["result"]
    gap = max(float((res.kf_t - ref.kf_t.cpu()).abs().max()),
              float((res.kf_R - ref.kf_R.cpu()).abs().max()))
    pt_gap = float((res.pt_pos - ref.pt_pos.cpu()).norm(dim=-1).median())
    agree = all(torch.equal(x[0], y) for x in (sh["rank_R"], sh["rank_t"])
                for y in x)
    K = len(kfs)
    per = sh["all_reduce_bytes"] / max(sh["all_reduces"], 1)
    print(f"[17c] orbit arena ({K} keyframes, {len(pts)} points, segments "
          f"{[int((seg == i).sum()) for i in range(2)]}): sharded GBA over "
          f"mesh {sh['mesh']} (dcn,ici), backend {sh['backend']}: "
          f"{sh['seconds']:.3f} s on rank 0 against {ref_s:.3f} s in this "
          f"process; poses vs the single solve {gap:.3g} (tol "
          f"{SHARD_POSE_TOL}), median point gap {pt_gap:.3g} (tol "
          f"{SHARD_POINT_GAP}); ranks bit-equal {agree}; "
          f"{sh['all_reduces'] / opt.global_ba_iters:.2f} all-reduces per "
          f"GN iteration, {per:.0f} bytes each on average (S "
          f"{K * K * 36 * 4}, b {K * 6 * 4})",
          flush=True)
    if gap > SHARD_POSE_TOL or not pt_gap < SHARD_POINT_GAP or not agree:
        _fail(f"orbit arena sharded GBA: gap {gap}, points {pt_gap}, ranks "
              f"agree {agree}")

    # d. the pose graph of the arena's keyframes over the ranks
    pg, K_g, E_g = entry_mod.loop_graph(arena, n, "cpu")
    rng = np.random.RandomState(7)
    drift = torch.from_numpy(0.01 * rng.randn(K_g, 3).astype(np.float32))
    drift[0] = 0.0
    pg = pg._replace(t=pg.t + drift)
    pgs = sharded_ba.run_sharded("pose_graph", pg, opt, n, fix_scale=True)
    pg_ref = pose_graph.optimize_pose_graph(
        type(pg)(*[x.to(dev) for x in pg]), opt, fix_scale=True)
    pg_gap = max(float((pgs["result"].t - pg_ref.t.cpu()).abs().max()),
                 float((pgs["result"].R - pg_ref.R.cpu()).abs().max()))
    print(f"[17d] pose graph ({K_g} nodes, {E_g} edges) over {n} ranks, "
          f"backend {pgs['backend']}: {pgs['seconds']:.3f} s on rank 0; vs "
          f"the single-rank solve {pg_gap:.3g} (tol {SHARD_POSE_TOL}); "
          f"{pgs['all_reduces'] / opt.essential_graph_iters:.2f} "
          f"all-reduces per GN iteration (H {K_g * K_g * 49 * 4} bytes, b "
          f"{K_g * 7 * 4}). NCCL across cards is not verified: this machine "
          f"has {torch.cuda.device_count()} card(s)", flush=True)
    if pg_gap > SHARD_POSE_TOL:
        _fail(f"sharded pose graph: gap {pg_gap}")
    return launches, dr


def bank_session_main(argv):
    """``python3 chip_smoke.py --rt-bank-session {twin,reloc} VOCAB OUT``:
    one of [19]'s sessions on the card in a process of its own (VOCAB a
    vocabulary .npz, or - for none): the odometry twin of (a) over the
    whole circuit, or (b). Pickles to OUT the ``finish()`` result, the
    FAST launches, the seconds and, with a vocabulary, the maintenance
    dispatches' summary and the bank relocalizations' dispatches."""
    import pickle
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from coebslam_tpu_torch import config
    from coebslam_tpu_torch.ops import fast_cuda
    from coebslam_tpu_torch.slam import vocabulary
    from coebslam_tpu_torch.slam.realtime import RealtimeSlam, RTLimits
    from coebslam_tpu_torch.utils import synthetic
    kind, voc_path, out_path = argv
    dev = torch.device("cuda")
    ccfg = circuit_config(config)
    frames, _ = loop_scene(dev, range(synthetic.N_CIRCUIT
                                      + synthetic.N_OVERLAP),
                           synthetic.DEPTH_BIAS, synthetic, ccfg.camera)
    voc = None if voc_path == "-" else vocabulary.load(voc_path)
    rt = RealtimeSlam(ccfg, RTLimits(**BANK_LIMITS), vocabulary=voc,
                      maintain_every=1)
    rec = time_dispatches(torch, rt) if voc is not None else []
    black = (torch.zeros_like(frames[0][0]), torch.zeros_like(frames[0][1]))
    fast_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    if kind == "twin":
        res = run_realtime(rt, frames)
    else:
        res = run_bank_reloc(rt, frames, black, synthetic.N_CIRCUIT // 2)
    out = {"res": res, "launches": fast_cuda.LAUNCHES,
           "seconds": time.perf_counter() - t0}
    if rec:
        out.update(dispatch=dispatch_summary(rec),
                   bank_reloc=bank_dispatches(rec, 3))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def rt_bank_phase(torch, fast_cuda, extractor, vocabulary, RealtimeSlam,
                  RTLimits, synthetic, ate, ccfg, frames, gt, card_line):
    """[19]: the place bank on the card (rt_loop_scenes.py): (a) the
    drifted circuit with an 8-row ring and its odometry twin, (b) the
    relocalization to an evicted place; the scene's own vocabulary. The
    twin and (b) run in processes of their own (``bank_session_main``)
    beside (a), for the script's time. Returns the FAST launches of (a)
    (with the twin's) and (b)."""
    import pickle
    lim = RTLimits(**BANK_LIMITS)
    n_circ, n_over = synthetic.N_CIRCUIT, synthetic.N_OVERLAP
    t0 = time.perf_counter()
    voc = _vocabulary_of(extractor, vocabulary, ccfg, frames,
                         bank_vocab_frames(n_circ), BANK_VOCAB)
    print(f"[19] scene vocabulary ({voc.n_words} words) trained in "
          f"{time.perf_counter() - t0:.1f} s; the odometry twin and (b) run "
          f"in two more processes beside (a)", flush=True)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_bank_")
    voc_path = os.path.join(tmp.name, "vocabulary.npz")
    vocabulary.save(voc_path, voc)
    procs, logs = {}, {}
    try:
        for kind in ("twin", "reloc"):
            logs[kind] = open(os.path.join(tmp.name, f"{kind}.log"), "w")
            procs[kind] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--rt-bank-session", kind,
                 "-" if kind == "twin" else voc_path,
                 os.path.join(tmp.name, f"{kind}.pkl")],
                stdout=logs[kind], stderr=subprocess.STDOUT)
        # (a) the bank closure after the ring has wrapped
        rt = RealtimeSlam(ccfg, lim, vocabulary=voc, maintain_every=1)
        rec = time_dispatches(torch, rt)
        fast_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        res = run_realtime(rt, frames)
        loop_s = time.perf_counter() - t0
        loop_launches = fast_cuda.LAUNCHES
        other = {}
        for kind, proc in procs.items():
            rc = proc.wait(timeout=900)
            logs[kind].close()
            if rc != 0:
                with open(logs[kind].name) as f:
                    print(f.read()[-4000:], flush=True)
                _fail(f"[19] {kind} session exited {rc}")
            with open(os.path.join(tmp.name, f"{kind}.pkl"), "rb") as f:
                other[kind] = pickle.load(f)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        tmp.cleanup()
    twin = other["twin"]
    s = bank_loop_summary(res, twin["res"], gt, n_circ, n_over, ate)
    closes, disp = bank_dispatches(rec, 2), dispatch_summary(rec)
    j = JAX_CPU_RT_BANK_LOOP
    print(f"[19a] bank closure after the ring wraps (8-row ring, bank_cap "
          f"{lim.bank_cap}; JAX package on CPU in brackets): frames OK "
          f"{s['ok']}/{s['n']} ({j['ok']}), keyframes {s['n_kf']} "
          f"({j['n_kf']}; gate >= {3 * lim.max_kf}), bank entries "
          f"{s['bank_entries']} ({j['bank_entries']}; gate > {lim.max_kf}), "
          f"bank closures {s['n_bank_loops']} ({j['n_bank_loops']}; gate >= "
          f"1), applied closures' keyframe gaps {s['applied_gaps']} "
          f"({j['applied_gaps']}; gate: one > {lim.max_kf}), revisit gap "
          f"{s['gap_m'] * 100:.3f} cm against the odometry's "
          f"{s['gap_odo_m'] * 100:.3f} ({j['gap_m'] * 100:.3f} against "
          f"{j['gap_odo_m'] * 100:.3f}; gate < 0.6 x), ATE "
          f"{s['ate_m'] * 100:.3f} cm against the odometry's "
          f"{s['ate_odo_m'] * 100:.3f} ({j['ate_m'] * 100:.3f} against "
          f"{j['ate_odo_m'] * 100:.3f}; gate <= 1.1 x + 0.5 cm)", flush=True)
    n = len(frames)
    print(f"[19a] FAST launches {loop_launches} for {n} frames, the twin's "
          f"{twin['launches']} for {n}; {loop_s:.1f} s, the twin "
          f"{twin['seconds']:.1f} s; dispatches {disp['dispatches']}; the "
          f"bank closures' dispatches (host ms, device span ms) {closes}; "
          f"{dispatch_line(disp)}; on {card_line}", flush=True)
    bad = bank_loop_failures(s, lim.max_kf)
    if loop_launches != n or twin["launches"] != n:
        bad.append(f"{loop_launches} and {twin['launches']} FAST launches")
    if bad:
        _fail(f"bank closure: {bad}")
    # (b) the relocalization to an evicted place
    rel = other["reloc"]
    s = bank_reloc_summary(rel["res"])
    j = JAX_CPU_RT_BANK_RELOC
    print(f"[19b] bank relocalization to an evicted place (frames 0-"
          f"{n_circ // 2 - 1}, {BANK_RELOC_BLACK} black, frames 6-15 again; "
          f"JAX package on CPU in brackets): bank relocalizations "
          f"{s['n_bank_reloc']} ({j['n_bank_reloc']}; gate >= 1), revisit "
          f"frames OK {s['revisit_ok']}/{s['n_revisit']} ({j['revisit_ok']}; "
          f"gate >= {s['n_revisit'] - 2}), median centre error "
          f"{s['median_err_m'] * 100:.3f} cm ({j['median_err_m'] * 100:.3f}; "
          f"limit 30 cm); FAST launches {rel['launches']} for {s['n']} "
          f"frames, {rel['seconds']:.1f} s; the bank relocalizations' "
          f"dispatches (host ms, device span ms) {rel['bank_reloc']}; "
          f"{dispatch_line(rel['dispatch'])}; on {card_line}", flush=True)
    bad = bank_reloc_failures(s)
    if rel["launches"] != s["n"]:
        bad.append(f"{rel['launches']} FAST launches for {s['n']} frames")
    if bad:
        _fail(f"bank relocalization: {bad}")
    return loop_launches + twin["launches"], rel["launches"]


def replica_rows_phase(procs, t0, card_line):
    """[22]: join ``replica_rows.start``'s sessions, print their lines with
    the JAX package's CPU values, and fail on a failed session or gate.
    Returns {row: summary}."""
    rows, failed = replica_rows.join(procs, ROWS_JOIN_S)
    for row, msg in failed.items():
        print(f"[22] {row} session failed: {msg}", flush=True)
    if failed:
        _fail(f"[22] sessions failed: {sorted(failed)}")
    lines, bad = replica_rows.row_lines(rows, card_line, ROW_TAGS)
    for line in lines:
        print(line, flush=True)
    took = ", ".join(f"{r} {s['process_s']:.1f} s" for r, s in rows.items())
    print(f"[22] the four sessions took {took} "
          f"from their start to their summaries, beside [6]-[20] (joined "
          f"{time.perf_counter() - t0:.1f} s after they started); their "
          f"seconds and fps carry that contention", flush=True)
    if bad:
        _fail(f"[22] gates: {bad}")
    return rows


def train_phase(torch, out_path):
    """[18]: tools/train_detector.run on the card at TRAIN_DETECTOR."""
    from coebslam_tpu_torch.models import detector as detector_mod, yolov5
    from coebslam_tpu_torch.tools import train_detector
    c = TRAIN_DETECTOR
    peak_mib(torch)
    td = train_detector.run(train_detector.parse_args(
        ["--width", str(c["width"]), "--batch", str(c["batch"]), "--seqs",
         str(c["seqs"]), "--frames", str(c["frames"]), "--steps",
         str(c["steps"]), "--out", out_path]))
    mem = peak_mib(torch)
    losses = np.asarray(td["losses"])
    variables, meta = detector_mod.load_variables_npz(out_path)
    back = yolov5.from_flax_variables(variables)
    same = back.keys() == td["state_dict"].keys() and all(
        torch.equal(back[k], td["state_dict"][k]) for k in back)
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    digest = hashlib.sha1(losses.tobytes() + b"".join(
        td["state_dict"][k].numpy().tobytes()
        for k in sorted(td["state_dict"]))).hexdigest()
    print(f"[18] train_detector at width {c['width']}, batch {c['batch']}, "
          f"input {train_detector.INPUT}, cut to {c['seqs']} sequences x "
          f"{c['frames']} frames ({td['n_val']} held out) and {c['steps']} "
          f"steps (the tool's defaults: 3 x 130, 700): rendered in "
          f"{td['render_s']:.1f} s; loss {losses[0]:.4f} at step 0, "
          f"{losses[-1]:.4f} at step {len(losses) - 1} (means of the first "
          f"and last 10: {first:.4f}, {last:.4f}); {td['steps_per_s']:.2f} "
          f"steps/s; held-out IoU {td['miou']:.3f} over {td['n_boxes']} "
          f"boxes; peak device memory {mem:.1f} MiB; the .npz read back by "
          f"load_variables_npz equals the trained state: {same} (width "
          f"{float(meta['width'])}); deterministic (PyTorch's deterministic "
          f"algorithms, cuDNN deterministic, TF32 off): SHA-1 of the losses "
          f"and the trained weights {digest}, equal in every run of this "
          f"tree on one card", flush=True)
    if td["device"] != "cuda" or not np.isfinite(losses).all() \
            or not last < first or not same:
        _fail(f"train_detector: device {td['device']}, losses "
              f"{first} -> {last}, file equal {same}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    if sys.argv[1:2] == ["--rt-bank-session"]:
        return bank_session_main(sys.argv[2:])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from coebslam_tpu_torch import config
    from coebslam_tpu_torch.config import SystemConfig
    from coebslam_tpu_torch.eval import ate
    from coebslam_tpu_torch.examples import run_mono, run_stereo, \
        run_tum_rgbd
    from coebslam_tpu_torch.geometry.se3 import SE3
    from coebslam_tpu_torch.io import checkpoint, png, trajectory, tum
    from coebslam_tpu_torch.eval import rpe
    from coebslam_tpu_torch.tools import train_vocab
    from coebslam_tpu_torch.models import detector as detector_mod, yolov5
    from coebslam_tpu_torch.models.detector import BlurGate
    from coebslam_tpu_torch.ops import extractor, fast, fast_cuda, \
        initializer_ops
    from coebslam_tpu_torch.ops import fundamental, lk_flow, pnp
    from coebslam_tpu_torch.slam import dynamic as dynamic_mod
    from coebslam_tpu_torch.slam import frame as frame_mod
    from coebslam_tpu_torch.slam import handoff, vocabulary
    from coebslam_tpu_torch.slam.global_ba import GlobalBA
    from coebslam_tpu_torch.slam.realtime import RealtimeSlam, RTLimits
    from coebslam_tpu_torch.slam.system import System
    from coebslam_tpu_torch.utils import replica, synthetic

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    laps = [t_start]
    beside = []              # [22]'s sessions, while they run

    def lap(name):
        """Print the seconds of the phase that ends here (and whether [22]'s
        sessions ran beside it)."""
        now = time.perf_counter()
        print(f"[{name}] phase {now - laps[-1]:.1f} s"
              + (" (beside [22]'s four sessions)" if beside else ""),
              flush=True)
        laps.append(now)
    # ---- 1. card + build
    card_line = card()
    print(card_line, flush=True)
    t0 = time.perf_counter()
    lib = fast_cuda.build()
    fast_cuda.load(lib)
    print(f"[1] built {os.path.relpath(lib)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in ptxas_report(lib):
        print(f"[1] ptxas: {line}", flush=True)

    lap("1")
    # ---- 2. kernel vs plain on the card
    cfg = SystemConfig()
    cam = cfg.camera
    ccfg = circuit_config(config)
    planes = synthetic.make_room(seed=0, device=dev)
    pose = synthetic.camera_trajectory(10, radius=0.35)[3]
    frame = torch.clamp(synthetic.render(cam, pose, planes)[0], 0, 255)
    canv, hw = extractor.level_canvas(frame, cfg.orb)
    # The circuit's and the kidnap's first frame, as their path gets it.
    c_frame = loop_scene(dev, [0], 1.0, synthetic, ccfg.camera)[0][0][0]
    c_canv, c_hw = extractor.level_canvas(c_frame, ccfg.orb)

    def orb_thrs(orb):
        return (float(orb.fast_threshold_min),
                float(orb.fast_threshold_min_masked))

    cases = [("main path", canv, hw, orb_thrs(cfg.orb)),
             ("circuit and kidnap", c_canv, c_hw, orb_thrs(ccfg.orb))] + [
        (name, c, ext, (7.0, 10.0))
        for name, c, ext in fast_edge_cases(torch, dev)]
    max_err = 0.0
    for name, c, ext, thrs in cases:
        for thr in thrs:
            t = torch.tensor(thr, device=dev)
            st_k, sc_k = fast_cuda.strength_and_score(c, t, ext)
            st_p, sc_p = fast.strength_and_score_plain(c, t, ext)
            st_e = fast.strength_map(c)          # edge-padded reference
            torch.cuda.synchronize()
            if not torch.equal(sc_k, sc_p):
                _fail(f"FAST score differs from plain: {name}, thr {thr}")
            if not torch.equal(st_k, st_p):
                _fail(f"FAST strength differs from plain: {name}")
            for l, (h, w) in enumerate(ext.tolist()):
                if not torch.equal(st_k[l, 4:h - 4, 4:w - 4],
                                   st_e[l, 4:h - 4, 4:w - 4]):
                    _fail(f"FAST strength differs inside level {l}")
            max_err = max(max_err, float((sc_k - sc_p).abs().max()),
                          float((st_k - st_p).abs().max()))
            print(f"[2] FAST {name} {tuple(c.shape)} thr {thr:g}: score and "
                  f"strength bit-equal, {int((sc_k > 0).sum())} corners",
                  flush=True)

    lap("2")
    # ---- 3. extractor: kernel path vs plain path on the card
    mask = torch.zeros((cam.height, cam.width), dtype=torch.bool, device=dev)
    mask[:, :200] = True
    runs = [(f"orbit area_mode={area}", frame, cfg.orb,
             dict(dynamic_mask=mask, area_mode=torch.tensor(area, device=dev)))
            for area in (False, True)]
    runs.append(("circuit", c_frame, ccfg.orb, {}))   # no dynamic filtering
    for name, img, orb, kw in runs:
        fk = extractor.extract(img, orb, **kw)
        with _plain_fast(fast, fast_cuda):
            fp = extractor.extract(img, orb, **kw)
        if not torch.equal(fk.valid, fp.valid):
            _fail(f"extractor {name}: valid differs between kernel and "
                  f"plain FAST")
        uv_err = float((fk.uv - fp.uv).abs().max())
        if uv_err > 1e-4 or not torch.equal(fk.desc, fp.desc):
            _fail(f"extractor {name}: uv err {uv_err} / descriptors differ")
        print(f"[3] extractor {name}: {int(fk.valid.sum())} keypoints, valid "
              f"equal, uv err {uv_err:g}, desc bit-equal", flush=True)

    lap("3")
    # ---- 4. the main path
    t0 = time.perf_counter()
    G, D, B, C = synthetic.dynamic_orbit(cam, N_FRAMES)
    print(f"[4] rendered {N_FRAMES} frames in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    voc = vocabulary.load(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "artifacts", "vocab_1e5.npz"))
    rt = RealtimeSlam(cfg, RTLimits(), vocabulary=voc,
                      maintain_every=MAINTAIN_EVERY)
    dispatches = time_dispatches(torch, rt)
    print(f"[4] vocabulary loaded and on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    fast_cuda.LAUNCHES = 0
    peak_mib(torch)
    t0 = time.perf_counter()
    track_frames(rt, (G, D, B), 0, N_FRAMES)
    pass1_s = time.perf_counter() - t0
    with count_host_syncs(torch) as sync_sites:
        t0 = time.perf_counter()
        track_frames(rt, (G, D, B), N_FRAMES, 2 * N_FRAMES)
        pass2_s = time.perf_counter() - t0
    launches = fast_cuda.LAUNCHES
    n_syncs = sum(sync_sites.values())
    res = rt.finish()
    n = len(res["ok"])
    gt = np.tile(C, (2, 1))[:n]
    est = np.asarray([-R.T @ t for R, t in zip(res["R"], res["t"])])
    rmse = ate.ate_rmse(res["stamps"], est, np.arange(n) / 30.0, gt)["rmse"]
    fps = N_FRAMES / pass2_s
    print(f"[4] frames OK {int(res['ok'].sum())}/{n}, ATE {rmse * 100:.3f} cm "
          f"(limit {ATE_LIMIT_M * 100:.1f} cm; JAX package on CPU "
          f"{JAX_CPU_ATE_M * 100:.2f} cm), keyframes {res['n_kf']}, live "
          f"points {int(res['pt_valid'].sum())}, BA-culled "
          f"{res['n_ba_culled']}, fused {res['n_assoc']}", flush=True)
    print(f"[4] pass 1 {pass1_s:.1f} s ({N_FRAMES / pass1_s:.2f} fps), "
          f"pass 2 {pass2_s:.1f} s ({fps:.2f} fps); host syncs "
          f"{n_syncs} in pass 2 = {n_syncs / N_FRAMES:.2f} per frame "
          f"{sync_sites}; FAST launches {launches} for {n} frames",
          flush=True)
    orbit_disp = dispatch_summary(dispatches)
    print(f"[4] maintenance: {maint_line(res)} (JAX package on CPU: "
          f"{JAX_CPU_ORBIT}); keyframes processed (bow_next) "
          f"{int(rt.mstate.bow_next)}, keyframes at the last dispatch "
          f"{orbit_disp['n_kf_at_last']}; dispatches "
          f"{orbit_disp['dispatches']}; {dispatch_line(orbit_disp)}",
          flush=True)
    if n != 2 * N_FRAMES or not res["ok"].all():
        _fail(f"{int(res['ok'].sum())}/{n} frames tracked")
    if not np.isfinite(est).all() or rmse >= ATE_LIMIT_M:
        _fail(f"ATE {rmse} m >= {ATE_LIMIT_M} m")
    if launches != n:
        _fail(f"FAST kernel launched {launches} times for {n} frames")
    if orbit_disp["dispatches"] != n // MAINTAIN_EVERY:
        _fail(f"maintenance dispatched {orbit_disp['dispatches']} times "
              f"for {n} frames")
    print(f"[4] peak device memory {peak_mib(torch):.1f} MiB", flush=True)
    sessions = {"orbit": (cfg, res, gt)}

    lap("4")
    # ---- 5. kernel time beside the plain version and the bound
    thr = torch.tensor(float(cfg.orb.fast_threshold_min), device=dev)
    flush = l2_flush(torch)

    def kernel():
        return fast_cuda.strength_and_score(canv, thr, hw)

    def plain():
        return fast.strength_and_score_plain(canv, thr, hw)

    ms = _device_ms(torch, kernel, 200, flush)
    ms_warm = _device_ms(torch, kernel, 200)
    plain_ms = _device_ms(torch, plain, 50, flush)
    plain_warm = _device_ms(torch, plain, 50)
    ms_2 = _device_ms(torch, kernel, 200, flush)
    empty_ms = _device_ms(torch, lambda: torch.cuda._sleep(0), 200, flush)
    n_bytes, n_ops = fast_cuda.work(hw.tolist(), *canv.shape)
    bytes_ms = n_bytes / MEM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    times = (ms, ms_warm, plain_ms, plain_warm, ms_2, empty_ms)
    print(f"[5] FAST {tuple(canv.shape)}: kernel cold {ms:.4f} / {ms_2:.4f} "
          f"ms, warm {ms_warm:.4f} ms; plain cold {plain_ms:.4f} ms, warm "
          f"{plain_warm:.4f} ms; bound {bound_ms:.4f} ms (bytes {n_bytes} -> "
          f"{bytes_ms:.4f} ms, ops {n_ops} -> {ops_ms:.4f} ms), "
          f"{bound_ms / ms:.1%} of it cold; an empty kernel reads "
          f"{empty_ms:.4f} ms the same way; on {card_line}", flush=True)
    if not all(np.isfinite(t) and t > 0 for t in times):
        _fail(f"FAST times not finite: {times}")

    lap("5")
    # ---- 22. bench.py's dataset rows: four sessions in processes of their
    # own, started here (after [4] and [5], whose fps and kernel times are
    # measured alone) and joined before the last line.
    rows_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_rows_")
    rows_t0 = time.perf_counter()
    beside.append(replica_rows.start(rows_dir.name, nice=ROWS_NICE))
    print(f"[22] started "
          f"{', '.join(f'{r} ({n} frames)' for r, n in replica_rows.FULL.items())} "
          f"in processes of their own at CPU priority nice {ROWS_NICE}; the "
          f"phases [6]-[20] run beside them", flush=True)
    # ---- 6. the loop circuit (bench.py run_loop_event)
    clim = RTLimits(**CIRCUIT_LIMITS)
    n_circ = synthetic.N_CIRCUIT + synthetic.N_OVERLAP
    frames, gt = loop_scene(dev, range(n_circ), synthetic.DEPTH_BIAS,
                            synthetic, ccfg.camera)
    rt = RealtimeSlam(ccfg, clim, vocabulary=voc, maintain_every=1)
    rec = time_dispatches(torch, rt)
    fast_cuda.LAUNCHES = 0
    peak_mib(torch)
    t0 = time.perf_counter()
    res = run_realtime(rt, frames)
    circ_s = time.perf_counter() - t0
    circ_launches = fast_cuda.LAUNCHES
    n = len(res["ok"])
    rmse = ate.ate_rmse(res["stamps"], centres(res), res["stamps"],
                        gt)["rmse"]
    circ_disp = dispatch_summary(rec)
    applied = [e for e in res["loop_events"] if e["applied"]]
    print(f"[6] circuit: frames OK {int(res['ok'].sum())}/{n}, ATE "
          f"{rmse * 100:.3f} cm (limit {CIRCUIT_ATE_LIMIT_M * 100:.0f} cm; "
          f"JAX package on CPU {JAX_CPU_CIRCUIT_ATE_M * 100:.2f} cm, "
          f"{JAX_CPU_CIRCUIT}); {maint_line(res)}; keyframes {res['n_kf']}; "
          f"{n_circ} frames in {circ_s:.1f} s; FAST launches "
          f"{circ_launches}", flush=True)
    print(f"[6] events {res['loop_events']}", flush=True)
    print(f"[6] dispatches {circ_disp['dispatches']}; "
          f"{dispatch_line(circ_disp)}", flush=True)
    if not applied or any(e["cand_lid"] > 8 for e in applied):
        _fail(f"circuit closures: {res['loop_events']}")
    if not np.isfinite(rmse) or rmse >= CIRCUIT_ATE_LIMIT_M:
        _fail(f"circuit ATE {rmse} m >= {CIRCUIT_ATE_LIMIT_M} m")
    if circ_launches != n or circ_disp["dispatches"] != n:
        _fail(f"circuit: {circ_launches} launches, "
              f"{circ_disp['dispatches']} dispatches for {n} frames")
    print(f"[6] peak device memory {peak_mib(torch):.1f} MiB", flush=True)
    sessions["circuit"] = (ccfg, res, gt)
    circ_frames, gt_circ = frames, gt    # [14a] drives the host path on them

    lap("6")
    # ---- 7. kidnap relocalization (tests/test_realtime_loop.py)
    sched = list(range(0, 50)) + list(range(6, 16))
    frames, gt = loop_scene(dev, sched, 1.0, synthetic, ccfg.camera)
    rt = RealtimeSlam(ccfg, clim, vocabulary=voc, maintain_every=2)
    rec = time_dispatches(torch, rt)
    fast_cuda.LAUNCHES = 0
    peak_mib(torch)
    res = run_realtime(rt, frames)
    kid_launches = fast_cuda.LAUNCHES
    est = centres(res)
    n = len(est)
    tail = slice(n - 5, n)
    tail_rmse = ate.ate_rmse(res["stamps"][tail], est[tail],
                             res["stamps"][tail], gt[tail])["rmse"]
    kid_disp = dispatch_summary(rec)
    print(f"[7] kidnap: frames OK {int(res['ok'].sum())}/{n}, last 12 "
          f"{res['ok'][-12:].astype(int).tolist()}, tail ATE "
          f"{tail_rmse * 100:.3f} cm (limit "
          f"{KIDNAP_TAIL_LIMIT_M * 100:.0f} cm; JAX package on CPU "
          f"{JAX_CPU_KIDNAP_TAIL_M * 100:.3f} cm, {JAX_CPU_KIDNAP}); "
          f"{maint_line(res)}; FAST launches {kid_launches}; dispatches "
          f"{kid_disp['dispatches']}; {dispatch_line(kid_disp)}", flush=True)
    if res["n_relocalizations"] < 1 or not res["ok"][-4:].all():
        _fail("kidnap: no relocalization, or the last frames lost")
    if not np.isfinite(tail_rmse) or tail_rmse >= KIDNAP_TAIL_LIMIT_M:
        _fail(f"kidnap tail ATE {tail_rmse} m >= {KIDNAP_TAIL_LIMIT_M} m")
    if kid_launches != n:
        _fail(f"kidnap: {kid_launches} launches for {n} frames")
    print(f"[7] peak device memory {peak_mib(torch):.1f} MiB", flush=True)

    lap("7")
    # ---- 8. the orbit, self-detect (bench.py run_realtime_selfdetect)
    det = walker_detector(config, detector_mod, cfg.dynamic)
    # Its first call (cuDNN's algorithm choice) stays out of the run.
    det.detect_device(torch.from_numpy(G[0]).to(dev))
    det.dispatches = 0
    rt = RealtimeSlam(cfg, RTLimits(), detector=det,
                      detect_every=DETECT_EVERY)
    fast_cuda.LAUNCHES = 0
    peak_mib(torch)
    with count_host_syncs(torch) as sd_sites:
        t0 = time.perf_counter()
        for i in range(N_SELFDETECT):
            rt.track(G[i], D[i], stamp=i / 30.0)
        rt.block()
        sd_s = time.perf_counter() - t0
    sd_launches = fast_cuda.LAUNCHES
    sd_syncs = sum(sd_sites.values())
    sd_mem = peak_mib(torch)
    res = rt.finish()
    n = len(res["ok"])
    rmse = ate.ate_rmse(res["stamps"], centres(res), np.arange(n) / 30.0,
                        C[:n])["rmse"]
    iou = mean_best_iou(det.detect, G[:n], B[:n])
    j = JAX_CPU_SELFDETECT
    print(f"[8] self-detect ({N_SELFDETECT} frames; JAX package on CPU in "
          f"brackets): frames OK {int(res['ok'].sum())}/{n} ({j['ok']}/"
          f"{N_SELFDETECT}), "
          f"ATE {rmse * 100:.3f} cm ({j['ate_m'] * 100:.3f}; limit "
          f"{SELFDETECT_ATE_LIMIT_M * 100:.0f} cm), keyframes {res['n_kf']} "
          f"({j['n_kf']}), detections dispatched {det.dispatches} "
          f"({j['detections']}), box IoU {iou:.4f} ({j['box_iou']:.4f}); "
          f"host syncs {sd_syncs} = {sd_syncs / n:.2f} per frame "
          f"{sd_sites}; FAST launches {sd_launches}; {n} frames in "
          f"{sd_s:.1f} s ({n / sd_s:.2f} fps); peak device memory "
          f"{sd_mem:.1f} MiB", flush=True)
    if n != N_SELFDETECT or int(res["ok"].sum()) < j["ok"]:
        _fail(f"self-detect: {int(res['ok'].sum())}/{n} frames tracked")
    if not np.isfinite(rmse) or rmse >= SELFDETECT_ATE_LIMIT_M:
        _fail(f"self-detect ATE {rmse} m >= {SELFDETECT_ATE_LIMIT_M} m")
    if sd_launches != n or det.dispatches != -(-n // DETECT_EVERY):
        _fail(f"self-detect: {sd_launches} launches, {det.dispatches} "
              f"detections for {n} frames")

    lap("8")
    # ---- 9. the detector alone, full width and walker width
    g_cpu = torch.from_numpy(G[N_FRAMES // 2])
    g_dev = g_cpu.to(dev)
    full = config.DetectorConfig()
    weights = yolov5.init_random(
        yolov5.YoloV5s(full.num_classes), torch.Generator().manual_seed(0),
        calib=detector_mod.preprocess(torch.from_numpy(G[0]),
                                      full.input_size)).state_dict()
    # Random weights put many scores in near-ties, which rounding may
    # reorder: their boxes are printed, the trained detector's are held.
    for name, trained, make in (
            ("yolov5s (DetectorConfig(), seeded random weights calibrated "
             "on frame 0)", False,
             lambda d: detector_mod.YoloDetector(
                 full, cfg.dynamic, variables=weights, device=d)),
            ("walker (detector_walker.npz)", True,
             lambda d: walker_detector(config, detector_mod, cfg.dynamic,
                                       device=d))):
        on_cpu, on_dev = make("cpu"), make(dev)
        h_cpu, h_dev = on_cpu.heads(g_cpu), on_dev.heads(g_dev)
        head_err = max(float((a.cpu() - b).abs().max())
                       for a, b in zip(h_dev, h_cpu))
        heads_ok = all(torch.allclose(a.cpu(), b, rtol=1e-3, atol=1e-3)
                       for a, b in zip(h_dev, h_cpu))
        r_cpu, r_dev = on_cpu.run(g_cpu), on_dev.run(g_dev)
        box_err = float((r_dev[0].cpu() - r_cpu[0]).abs().max())
        score_err = float((r_dev[1].cpu() - r_cpu[1]).abs().max())
        n_valid = (int((r_dev[0][:, 0] >= 0).sum()),
                   int((r_cpu[0][:, 0] >= 0).sum()))
        peak_mib(torch)
        det_ms = _device_ms(torch, lambda: on_dev.detect_device(g_dev), 50)
        n_kern, kern_ms = device_kernels(
            torch, lambda: on_dev.detect_device(g_dev))
        size = on_dev.cfg.input_size
        flops = conv_flops(torch, on_dev.model,
                           torch.zeros((1, 3, size, size), device=dev))
        n_par = sum(p.numel() for p in on_dev.model.parameters())
        print(f"[9] detector {name}: {n_par} parameters, input {size}^2, "
              f"{flops / 1e9:.2f} GFLOP of convolution (fp32 bound "
              f"{flops / FP32_OPS_PER_S * 1e3:.4f} ms); card vs CPU: heads "
              f"max abs diff {head_err:.3g} (rtol 1e-3, atol 1e-3), boxes "
              f"{box_err:.3g} px, scores {score_err:.3g}, valid rows "
              f"{n_valid[0]} / {n_valid[1]}; detect_device {det_ms:.4f} ms "
              f"on the card (median of 50, queued behind a device-side "
              f"sleep), {n_kern} device kernels per detection "
              f"({kern_ms:.4f} ms of kernel time, profiled); peak device "
              f"memory {peak_mib(torch):.1f} MiB; on {card_line}",
              flush=True)
        if not heads_ok or (trained and (n_valid[0] != n_valid[1]
                                         or box_err > 0.5)):
            _fail(f"detector {name}: card and CPU differ")
        if not (np.isfinite(det_ms) and det_ms > 0):
            _fail(f"detector {name}: time {det_ms}")

    lap("9")
    # ---- 10. handoff and offline global BA of [4]'s and [6]'s sessions
    for name, (scfg, sres, sgt) in sessions.items():
        t0 = time.perf_counter()
        arena, kf_ids = handoff.to_arena(sres, scfg)
        t1 = time.perf_counter()
        gba = GlobalBA(scfg)
        n_opt = gba.run(arena)
        t2 = time.perf_counter()
        rep = refine_report(sres, arena, kf_ids, sgt, ate, handoff)
        rep.update(truncated_obs=gba.truncated_obs, gba_s=t2 - t1)
        j = JAX_CPU_REFINE[name]
        print(f"[10] {name} refine (JAX package on CPU in brackets): " + ", "
              .join(f"{k} {rep[k]:.6g} ({j[k]:.6g})" for k in j)
              + f"; handoff {t1 - t0:.2f} s; peak device memory "
              f"{peak_mib(torch):.1f} MiB", flush=True)
        if n_opt != len(kf_ids) or not np.isfinite(
                [rep["kf_ate_refined_m"], rep["ate_refined_m"]]).all():
            _fail(f"{name} refine: {n_opt} of {len(kf_ids)} optimized")
        if name == "orbit" and rep["kf_ate_refined_m"] >= \
                REFINED_KF_ATE_LIMIT_M:
            _fail(f"orbit refined keyframe ATE {rep['kf_ate_refined_m']}")
        if name == "circuit" and not (
                rep["ate_refined_m"] < rep["ate_realtime_m"]
                and rep["ate_refined_m"] < CIRCUIT_ATE_LIMIT_M):
            _fail(f"circuit refined ATE {rep['ate_refined_m']} against "
                  f"{rep['ate_realtime_m']} realtime")

    lap("10")
    # ---- 11. stereo at full width (tests/test_stereo_wide.py's scene)
    scfg = stereo_config(config)
    t0 = time.perf_counter()
    frames, sgt = stereo_scene(torch, synthetic, replica, scfg.camera, dev,
                               N_STEREO_RUN)
    print(f"[11] rendered the first {N_STEREO_RUN} of {N_STEREO} stereo "
          f"pairs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rt = RealtimeSlam(scfg, RTLimits())
    fast_cuda.LAUNCHES = 0
    peak_mib(torch)
    with count_host_syncs(torch) as st_sites:
        t0 = time.perf_counter()
        for i, (gl, gr, b) in enumerate(frames):
            rt.track_stereo(gl, gr, stamp=i / 30.0, boxes=b)
        rt.block()
        st_s = time.perf_counter() - t0
    st_launches = fast_cuda.LAUNCHES
    st_syncs = sum(st_sites.values())
    res = rt.finish()
    n = len(res["ok"])
    n_ok = int(res["ok"].sum())
    rmse = ate.ate_rmse(res["stamps"], centres(res), np.arange(n) / 30.0,
                        sgt)["rmse"]
    j = JAX_CPU_STEREO
    print(f"[11] stereo (JAX package on CPU in brackets): frames OK "
          f"{n_ok}/{n} ({j['ok']}/{N_STEREO_RUN}; gate >= {STEREO_MIN_OK}), "
          f"ATE "
          f"{rmse * 100:.3f} cm ({j['ate_m'] * 100:.3f}; limit "
          f"{STEREO_ATE_LIMIT_M * 100:.0f} cm), keyframes {res['n_kf']} "
          f"({j['n_kf']}), live points {int(res['pt_valid'].sum())} "
          f"({j['live_points']}); FAST launches {st_launches} for {n} "
          f"frames; {n} frames in {st_s:.1f} s ({n / st_s:.2f} fps); host "
          f"syncs {st_syncs} = {st_syncs / n:.2f} per frame {st_sites}; peak "
          f"device memory {peak_mib(torch):.1f} MiB", flush=True)
    if n != N_STEREO_RUN or n_ok < STEREO_MIN_OK:
        _fail(f"stereo: {n_ok}/{n} frames tracked")
    if not np.isfinite(rmse) or rmse >= STEREO_ATE_LIMIT_M:
        _fail(f"stereo ATE {rmse} m >= {STEREO_ATE_LIMIT_M} m")
    if st_launches != 2 * n:
        _fail(f"stereo: {st_launches} FAST launches for {n} frames")
    del frames

    lap("11")
    # ---- 12. monocular at full width (tests/test_realtime_mono.py's scene)
    mcfg = mono_config(config)
    # [15b] takes the first HOST_MONO_TRACK of these frames.
    frames, mgt = mono_scene(synthetic, mcfg.camera, dev,
                             max(N_MONO_RUN, HOST_MONO_TRACK))
    mono_frames, mono_gt = frames, mgt
    frames, mgt = frames[:N_MONO_RUN], mgt[:N_MONO_RUN]
    rt = RealtimeSlam(mcfg, RTLimits())
    attempts = []
    fit = initializer_ops.reconstruct_graph

    def kept(*a, **kw):
        attempts.append((a, kw))
        return fit(*a, **kw)

    initializer_ops.reconstruct_graph = kept
    fast_cuda.LAUNCHES = 0
    peak_mib(torch)
    try:
        with count_host_syncs(torch) as mo_sites:
            t0 = time.perf_counter()
            for i, g in enumerate(frames):
                rt.track_mono(g, stamp=i / 30.0)
            rt.block()
            mo_s = time.perf_counter() - t0
    finally:
        initializer_ops.reconstruct_graph = fit
    mo_launches = fast_cuda.LAUNCHES
    mo_syncs = sum(mo_sites.values())
    mo_mem = peak_mib(torch)
    res = rt.finish()
    n = len(res["ok"])
    ms_ = mono_summary(res["ok"], centres(res), mgt, ate)
    inits = res["init_attempts"]
    done = [a for a in inits if a["ok"]]
    # The successful attempt again, on its correspondences: its device time
    # and its reads.
    init_ms = init_syncs = float("nan")
    if done:
        a, kw = attempts[inits.index(done[0])]
        kw = dict(kw, generator=torch.Generator(device=dev))

        def one():
            kw["generator"].manual_seed(0)
            return fit(*a, **kw)

        init_ms = _device_ms(torch, one, 20)
        with count_host_syncs(torch) as one_sites:
            one()
            torch.cuda.synchronize()
        init_syncs = sum(one_sites.values())
    j = JAX_CPU_MONO
    print(f"[12] mono (JAX package on CPU in brackets): initialised on frame "
          f"{done[0]['frame'] if done else None} with "
          f"{'H' if done and done[0]['homography'] else 'F'}, "
          f"{done[0]['good'] if done else 0} correspondences triangulated, "
          f"{done[0]['points'] if done else 0} landmarks ({j['init']}); "
          f"{len(inits)} attempts {inits}; first tracked frame "
          f"{ms_['first_ok']} ({j['first_ok']}; gate <= "
          f"{MONO_FIRST_OK_MAX}), lost after it {ms_['lost_after']} "
          f"({j['lost_after']}; gate <= {MONO_MAX_LOST_AFTER}), frames OK "
          f"{ms_['ok']}/{n} ({j['ok']}), keyframes {res['n_kf']} "
          f"({j['n_kf']}; gate >= 3), Sim3 ATE "
          f"{ms_['ate_sim3_m'] * 100:.3f} cm ({j['ate_sim3_m'] * 100:.3f}; "
          f"limit {MONO_ATE_LIMIT_M * 100:.0f} cm)", flush=True)
    print(f"[12] one initialisation attempt (reconstruct_graph, "
          f"{mcfg.ransac.init_iterations} H and F hypotheses) {init_ms:.3f} "
          f"ms between CUDA events (median of 20, queued behind a device-side "
          f"sleep; its {init_syncs} host syncs let the host's dispatch "
          f"show after the first); FAST launches {mo_launches} for {n} "
          f"frames; {n} frames in {mo_s:.1f} s ({n / mo_s:.2f} fps); host "
          f"syncs {mo_syncs} = {mo_syncs / n:.2f} per frame {mo_sites}; peak "
          f"device memory {mo_mem:.1f} MiB; on {card_line}", flush=True)
    if not done or ms_["first_ok"] > MONO_FIRST_OK_MAX \
            or ms_["lost_after"] > MONO_MAX_LOST_AFTER or res["n_kf"] < 3:
        _fail(f"mono: {ms_}, {res['n_kf']} keyframes, attempts {inits}")
    if not np.isfinite(ms_["ate_sim3_m"]) \
            or ms_["ate_sim3_m"] >= MONO_ATE_LIMIT_M:
        _fail(f"mono Sim3 ATE {ms_['ate_sim3_m']} m >= {MONO_ATE_LIMIT_M} m")
    if mo_launches != n:
        _fail(f"mono: {mo_launches} FAST launches for {n} frames")
    lap("12")
    # ---- 16a. the replica written as TUM files
    files = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    rep_root = os.path.join(files.name, "replica")
    rep_boxes = os.path.join(rep_root, "boxes.txt")
    t0 = time.perf_counter()
    written = replica.write(rep_root, **HOST_SCHEDULE, frames=range(N_HOST),
                            device=dev)
    w_s = time.perf_counter() - t0
    for i in (0, N_HOST - 1):
        f = next(replica.generate(**HOST_SCHEDULE, frames=[i], device=dev))
        name = f"{f.stamp:.6f}.png"
        g = png.read(os.path.join(rep_root, "rgb", name))
        d = png.read(os.path.join(rep_root, "depth", name))
        if g.dtype != np.uint8 or d.dtype != np.uint16 \
                or not np.array_equal(g, f.gray) \
                or not np.array_equal(d, f.depth):
            _fail(f"replica frame {i} does not decode to generate's arrays")
    print(f"[16a] replica.write: the first {N_HOST} frames of the 400-frame "
          f"replica (seed 0) rendered on the card and written as TUM files "
          f"in {w_s:.1f} s, {written['bytes'] / 2 ** 20:.1f} MiB; frames 0 "
          f"and {N_HOST - 1} decode (io/png) to generate's arrays exactly",
          flush=True)
    lap("16a")
    # ---- 13. the host-orchestrated System, fed from the files by the
    # offline driver (run_tum_rgbd, host mode, --boxes)
    seq = tum.load_tum_sequence(rep_root)
    hgt = seq.gt_poses[:N_HOST_RUN, :3]
    h_out, h_launches, h_syncs, h_sites, h_s, h_mem = driver_phase(
        torch, fast_cuda, run_tum_rgbd.run, run_tum_rgbd.parse_args(
            [rep_root, "--boxes", rep_boxes, "--max-frames", str(N_HOST_RUN),
             "--out", os.path.join(files.name, "host")]))
    hsys = h_out["system"]               # [15d] saves its map
    hs = host_summary(hsys, h_out["states"], seq.gt_stamps[:N_HOST_RUN], hgt,
                      ate)
    stage_ms = dict(hsys.mapper.stage_ms)
    j = JAX_CPU_HOST
    print(f"[13] host System through run_tum_rgbd from the files, "
          f"synchronous mapping (JAX package on CPU in "
          f"brackets): frames OK {hs['ok']}/{hs['n']} ({j['ok']}), lost "
          f"{hs['lost']} ({j['lost']}; gate <= {HOST_MAX_LOST}), ATE "
          f"{hs['ate_m'] * 100:.3f} cm ({j['ate_m'] * 100:.3f}; limit "
          f"{HOST_ATE_LIMIT_M * 100:.0f} cm), keyframes {hs['n_kf']} "
          f"({j['n_kf']}), live points {hs['live_points']} "
          f"({j['live_points']}), local BAs {hs['local_ba']} "
          f"({j['local_ba']}), culled keyframes {hs['culled_kf']} "
          f"({j['culled_kf']}) and points {hs['culled_pt']} "
          f"({j['culled_pt']})", flush=True)
    print(f"[13] FAST launches {h_launches} for {hs['n']} frames; host syncs "
          f"{h_syncs} = {h_syncs / hs['n']:.2f} per frame {h_sites}; "
          f"{hs['n']} frames in {h_s:.1f} s with PNG decoding and the "
          f"trajectory files ({hs['n'] / h_s:.2f} fps, the card drained at "
          f"the end), {h_out['track_s']:.1f} s in track_rgbd "
          f"({hs['n'] / h_out['track_s']:.2f} fps, host clock); mapper "
          f"stage ms {({k: round(v, 1) for k, v in stage_ms.items()})}; "
          f"peak device memory {h_mem:.1f} MiB; on {card_line}", flush=True)
    if hs["lost"] > HOST_MAX_LOST:
        _fail(f"host System: {hs['lost']} frames lost")
    if not np.isfinite(hs["ate_m"]) or hs["ate_m"] >= HOST_ATE_LIMIT_M:
        _fail(f"host System ATE {hs['ate_m']} m >= {HOST_ATE_LIMIT_M} m")
    if h_launches != hs["n"]:
        _fail(f"host System: {h_launches} FAST launches for {hs['n']} "
              f"frames")
    stamp, g, d = seq.load_frame(N_HOST_RUN - 1)
    h_last = (stamp, g, d, run_tum_rgbd.box_lookup(
        rep_boxes, SystemConfig().dynamic.max_boxes)(stamp))
    lap("13")
    # ---- 14a. host loop closing: System(vocabulary=) over [6]'s circuit
    hl_launches, hl_n = host_loop_phase(
        torch, fast_cuda, extractor, vocabulary, System, GlobalBA, ate,
        config, synthetic, circ_frames, gt_circ, card_line)
    lap("14a")
    # ---- 14b. host relocalization after a blackout
    hr_launches, hr_n = host_reloc_phase(
        torch, fast_cuda, extractor, vocabulary, frame_mod, fundamental, pnp,
        System, config, synthetic, dev, card_line)
    lap("14b")
    # ---- 15a. the host System's stereo entry
    hst_launches, _ = host_stereo_phase(torch, fast_cuda, config, synthetic,
                                        System, ate, dev, card_line)
    lap("15a")
    # ---- 15b. the host System's monocular entry, with a kidnap
    hmo_launches, _ = host_mono_phase(
        torch, fast_cuda, config, extractor, vocabulary, initializer_ops,
        frame_mod, System, ate, mono_frames, mono_gt, card_line)
    lap("15b")
    # ---- 15c. the flow motion check
    hfl_launches, _ = host_flow_phase(
        torch, fast_cuda, config, synthetic, System, ate, dynamic_mod,
        lk_flow, fundamental, BlurGate, dev, card_line)
    lap("15c")
    # ---- 15d. a checkpoint of [13]'s map, resumed in localization mode
    checkpoint_phase(torch, checkpoint, System, SystemConfig, hsys,
                     h_last, card_line)
    lap("15d")
    # ---- 16b. [13]'s trajectory files read back; RPE
    hdir = h_out["out_dir"]
    est_stamps, est_xyzq = trajectory.load_tum(
        os.path.join(hdir, "CameraTrajectory.txt"))
    kf_stamps, _ = trajectory.load_tum(
        os.path.join(hdir, "KeyFrameTrajectory.txt"))
    if len(est_stamps) != hs["n"] or len(kf_stamps) != hs["n_kf"] \
            or not np.isfinite(est_xyzq).all():
        _fail(f"[13]'s trajectory files: {len(est_stamps)} frames, "
              f"{len(kf_stamps)} keyframes")
    gt_at = np.searchsorted(seq.gt_stamps, est_stamps)
    r = rpe.rpe(trajectory.tum_to_matrices(est_xyzq),
                trajectory.tum_to_matrices(seq.gt_poses[gt_at]))
    print(f"[16b] [13]'s CameraTrajectory.txt ({len(est_stamps)} rows) and "
          f"KeyFrameTrajectory.txt ({len(kf_stamps)} rows) read back "
          f"(io/trajectory); RPE over {r['pairs']} frame pairs: "
          f"translation RMSE {r['trans_rmse'] * 1000:.3f} mm, rotation RMSE "
          f"{np.degrees(r['rot_rmse']):.4f} deg", flush=True)
    lap("16b")
    # ---- 16c. the driver's realtime path with refinement, same files
    rt_out, rt_launches, rt_syncs, rt_sites, rt_s, rt_mem = driver_phase(
        torch, fast_cuda, run_tum_rgbd.run, run_tum_rgbd.parse_args(
            [rep_root, "--boxes", rep_boxes, "--max-frames", str(N_HOST),
             "--realtime", "--refine", "--hybrid-gba", "--out",
             os.path.join(files.name, "realtime")]))
    ds = driver_summary(rt_out)
    j = JAX_CPU_DRIVER_RT
    print(f"[16c] run_tum_rgbd --realtime --refine --hybrid-gba --boxes on "
          f"the {N_HOST} "
          f"files (JAX package on CPU in brackets): frames OK "
          f"{ds['ok']}/{ds['n']} ({j['ok']}; gate >= "
          f"{DRIVER_RT_MIN_OK}), ATE {ds['ate_m'] * 100:.3f} cm "
          f"({j['ate_m'] * 100:.3f}; limit {DRIVER_RT_ATE_LIMIT_M * 100:.1f} "
          f"cm), keyframes {ds['n_kf']} ({j['n_kf']}), global BA over "
          f"{ds['n_opt']} keyframes ({j['n_opt']}), refined ATE "
          f"{ds['refined_ate_m'] * 100:.3f} cm "
          f"({j['refined_ate_m'] * 100:.3f}; limit "
          f"{DRIVER_RT_REFINED_LIMIT_M * 100:.1f} cm and below the "
          f"raw ATE)", flush=True)
    print(f"[16c] FAST launches {rt_launches} for {ds['n']} frames; "
          f"{rt_out['fps']:.2f} fps (the driver's: dispatch and the final "
          f"drain, frames 2-{ds['n']}, host clock), the first frame "
          f"{rt_out['first_s']:.1f} s; the whole run {rt_s:.1f} s with PNG "
          f"decoding and the refinement; host syncs {rt_syncs}; peak "
          f"device memory {rt_mem:.1f} MiB; on {card_line}", flush=True)
    if ds["ok"] < DRIVER_RT_MIN_OK or not ds["ate_m"] < DRIVER_RT_ATE_LIMIT_M \
            or not ds["refined_ate_m"] < DRIVER_RT_REFINED_LIMIT_M \
            or not ds["refined_ate_m"] < ds["ate_m"]:
        _fail(f"driver realtime: {ds}")
    if rt_launches != ds["n"]:
        _fail(f"driver realtime: {rt_launches} FAST launches for "
              f"{ds['n']} frames")
    hy, arena_rt = rt_out["hybrid"], rt_out["arena"]
    hy_gap = max(float(np.abs(hy["kf_t"] - arena_rt.kf_t[hy["kfs"]]).max()),
                 float(np.abs(hy["kf_R"] - arena_rt.kf_R[hy["kfs"]]).max()))
    print(f"[16c] hybrid-mesh GBA: {len(hy['kfs'])} keyframes, mesh "
          f"{hy['mesh']} (dcn,ici) of {hy['n_ranks']} rank(s), backend "
          f"{hy['backend']}, segment point counts {hy['segment_counts']}, "
          f"{hy['seconds']:.3f} s, {hy['all_reduces']} all-reduces "
          f"({hy['all_reduce_bytes']} bytes); keyframe poses within "
          f"{hy_gap:.3g} of the refine step's (limit {SHARD_POSE_TOL})",
          flush=True)
    if hy["n_ranks"] != torch.cuda.device_count() or hy_gap > SHARD_POSE_TOL \
            or (hy["n_ranks"] <= torch.cuda.device_count()
                and hy["backend"] != "nccl"):
        _fail(f"hybrid-mesh GBA: {hy['n_ranks']} ranks, backend "
              f"{hy['backend']}, pose gap {hy_gap}")
    lap("16c")
    # ---- 16d. the stereo and mono drivers on KITTI and EuRoC files
    ex_frames = example_frames(torch, synthetic, SE3, cam, dev)
    kroot, eroot = write_example_sequences(png, ex_frames, files.name)
    ex_launches = {}
    for name, mod, argv, out_dir in (
            ("stereo", run_stereo, ["kitti", kroot], "kitti_out"),
            ("mono", run_mono, ["euroc", eroot], "euroc_out")):
        out_dir = os.path.join(files.name, out_dir)
        ex, ex_launches[name], _, _, ex_s, _ = driver_phase(
            torch, fast_cuda, mod.run, mod.parse_args(argv + ["--out",
                                                              out_dir]))
        traj = ["KeyFrameTrajectory.txt"] + (
            ["CameraTrajectoryKITTI.txt", "CameraTrajectory.txt"]
            if name == "stereo" else ["CameraTrajectory.txt"])
        missing = [t for t in traj
                   if not os.path.exists(os.path.join(out_dir, t))]
        rows = ""
        if name == "stereo" and not missing:
            k = np.loadtxt(os.path.join(out_dir, traj[1])).reshape(-1, 12)
            rows = f", {len(k)} KITTI rows"
            if len(k) != N_EXAMPLE:
                _fail(f"run_stereo: {len(k)} KITTI rows")
        print(f"[16d] run_{name} {argv[0]} on {N_EXAMPLE} PNG frames: states "
              f"{ex['states']}, {', '.join(traj)} written{rows}; FAST "
              f"launches {ex_launches[name]} (expected "
              f"{EXAMPLE_LAUNCHES[name]}); {ex_s:.1f} s", flush=True)
        if missing:
            _fail(f"run_{name}: {missing} not written")
        if ex_launches[name] != EXAMPLE_LAUNCHES[name]:
            _fail(f"run_{name}: {ex_launches[name]} FAST launches")
        if name == "stereo" and "OK" not in ex["states"]:
            _fail(f"run_stereo tracked no frame: {ex['states']}")
    lap("16d")
    # ---- 16e. the ORBvoc text format, both ways, on the committed
    # vocabulary; [4]'s first frame's words before and after
    voc_txt = os.path.join(files.name, "ORBvoc.txt")
    t0 = time.perf_counter()
    vocabulary.save_orbvoc_text(voc_txt, voc)
    t1 = time.perf_counter()
    voc2 = vocabulary.load_orbvoc_text(voc_txt)
    t2 = time.perf_counter()
    f0 = extractor.extract(torch.from_numpy(G[0]).to(dev, torch.float32),
                           cfg.orb)
    d0 = f0.desc[f0.valid].cpu().numpy()
    w_before = vocabulary.transform_host(voc, d0)[0]
    w_after = vocabulary.transform_host(voc2, d0)[0]
    same = all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(voc, voc2))
    print(f"[16e] ORBvoc text of artifacts/vocab_1e5.npz ({voc.n_words} "
          f"words, {len(voc.node_desc)} nodes): written in {t1 - t0:.2f} s, "
          f"{os.path.getsize(voc_txt) / 2 ** 20:.1f} MiB, read in "
          f"{t2 - t1:.2f} s; every array equal: {same}; [4]'s first frame's "
          f"{len(d0)} descriptors give equal words before and after: "
          f"{np.array_equal(w_before, w_after)}", flush=True)
    if not same or not np.array_equal(w_before, w_after):
        _fail("ORBvoc text round trip changed the vocabulary")
    lap("16e")
    # ---- 16f. train a small vocabulary (tools/train_vocab)
    voc_npz = os.path.join(files.name, "vocab_small.npz")
    tv, tv_launches, _, _, tv_s, _ = driver_phase(
        torch, fast_cuda, train_vocab.run, train_vocab.parse_args(
            [voc_npz, "--frames", str(VOCAB_TRAIN["frames"]), "--depth",
             str(VOCAB_TRAIN["depth"])]))
    back = vocabulary.load(voc_npz)
    print(f"[16f] train_vocab --frames {VOCAB_TRAIN['frames']} --depth "
          f"{VOCAB_TRAIN['depth']}: {tv['n_descriptors']} descriptors "
          f"harvested on the card in {tv['harvest_s']:.1f} s, "
          f"{tv['vocabulary'].n_words} words trained in "
          f"{tv['train_s']:.1f} s ({tv_s:.1f} s in all); vocabulary.load "
          f"reads back {back.n_words} words; FAST launches {tv_launches}",
          flush=True)
    if tv_launches != VOCAB_TRAIN["frames"] \
            or back.n_words != tv["vocabulary"].n_words \
            or not np.array_equal(back.children, tv["vocabulary"].children):
        _fail(f"train_vocab: {tv_launches} FAST launches, "
              f"{back.n_words} words read back")
    lap("16f")
    entry_launches, dr = multichip_phase(
        torch, fast_cuda, sessions["orbit"], handoff, card_line, dev)
    lap("17")
    train_phase(torch, os.path.join(files.name, "detector.npz"))
    files.cleanup()
    lap("18")
    # ---- 19. the realtime place bank: a closure and a relocalization to
    # places the 8-row ring has evicted
    bank_loop_launches, bank_reloc_launches = rt_bank_phase(
        torch, fast_cuda, extractor, vocabulary, RealtimeSlam, RTLimits,
        synthetic, ate, ccfg, circ_frames, gt_circ, card_line)
    lap("19")
    # ---- 21. the host System's recovery through the Relocalizer's EPnP
    hep_launches, _, mono_sys, gt_of_kf = host_epnp_phase(
        torch, fast_cuda, config, extractor, vocabulary, synthetic, System,
        ate, dev, card_line)
    lap("21")
    # ---- 20. the monocular Sim3 loop closure, on [21]'s map
    hml_launches = mono_loop_phase(torch, fast_cuda, GlobalBA, ate,
                                   mono_sys, gt_of_kf, card_line)
    lap("20")
    # ---- 22. join bench.py's dataset rows
    rows = replica_rows_phase(beside.pop(), rows_t0, card_line)
    rows_dir.cleanup()
    lap("22")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    kernels = [{
        "name": "fast_strength_score", "route": "cuda",
        "source": "coebslam_tpu_torch/csrc/fast.cu",
        "replaces": "coebslam_tpu/ops/fast_pallas.py:37",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "ms_warm": ms_warm, "plain_ms": plain_ms,
        "plain_ms_warm": plain_warm, "empty_kernel_ms": empty_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bound_share": bound_ms / ms, "bytes": n_bytes, "ops": n_ops,
        "library_ms": None,
        "launches_by_path": {"orbit": launches, "circuit": circ_launches,
                             "kidnap": kid_launches,
                             "selfdetect": sd_launches,
                             "stereo": st_launches, "mono": mo_launches,
                             "host_replica": h_launches,
                             "host_loop": hl_launches,
                             "host_reloc": hr_launches,
                             "host_stereo": hst_launches,
                             "host_mono": hmo_launches,
                             "host_flow": hfl_launches,
                             "driver_realtime": rt_launches,
                             "driver_stereo": ex_launches["stereo"],
                             "driver_mono": ex_launches["mono"],
                             "train_vocab": tv_launches,
                             "entry": entry_launches,
                             "multichip_frontend":
                                 dr["frontend_launches"],
                             "rt_bank_loop": bank_loop_launches,
                             "rt_bank_reloc": bank_reloc_launches,
                             "host_epnp_reloc": hep_launches,
                             "host_mono_loop": hml_launches,
                             **{f"replica_{r}": s["launches"]
                                for r, s in rows.items()}},
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

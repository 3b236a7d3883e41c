"""coebslam_tpu_torch — the PyTorch/CUDA port of coebslam_tpu.

The port runs the zero-sync realtime RGB-D, stereo and monocular paths
(extraction, the COEB dynamic front-end with the YOLOv5 detector in the
stream, tracking, keyframing and windowed BA), their maintenance program
(BoW loop closing, the place bank, relocalization), the offline
refinement of a finished session (handoff to a host map, global BA) and
the host-orchestrated ``System`` (host tracker, covisibility mapper
with culling) and its file-based entry points, multi-device bundle
adjustment and detector training as PyTorch code on an NVIDIA GPU, with
the FAST corner kernel written by hand in CUDA C++
(``csrc/fast.cu``). Module paths mirror the JAX package so each
counterpart is found under the same name; this package imports neither
JAX nor the JAX package, nor PIL or PyYAML.

Sub-packages
------------
geometry   SO3/SE3/Sim3 Lie-group ops, pinhole camera model
ops        pyramid, FAST (+ CUDA kernel), grid selection, BRIEF, matching,
           fundamental-matrix RANSAC, blur gate, 3D-3D alignment RANSAC
optim      pose-only Gauss-Newton, Schur-complement local and global BA,
           Sim3 pose graph
models     YOLOv5s network, decode and fixed-size NMS; the detector
slam       frame constructor, dynamic front-end, tracking step and host
           tracker, realtime loop, BoW vocabulary, maintenance program,
           host map arena and its device mirror, local mapper, System
           facade, global BA, handoff and refine
utils      synthetic RGB-D renderer (the room, the walker, the loop
           circuit), the TUM-format replica scenes (in memory and written
           to disk), metrics, offline visualization
io         PNG codec (zlib and numpy), TUM, EuRoC and KITTI sequences,
           TUM and KITTI trajectory files, map checkpoints
eval       ATE and RPE metrics
examples   the offline drivers (rgbd_tum, stereo, mono, synthetic)
tools      the replica writer, the vocabulary and the detector trainers
parallel   multi-device BA over torch.distributed: meshes of ranks, the
           sharded local and global BA and pose graph, the rank launcher
entry      the driver's entry step and the multi-device dry run
"""

import torch

__version__ = "0.1.0"


def _set_matmul_precision() -> None:
    """f32 products must be f32: TF32 keeps ~3 decimal digits, which
    quantizes point geometry and diverges tracking (the JAX package forces
    f32 matmul precision for the same reason)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


_set_matmul_precision()

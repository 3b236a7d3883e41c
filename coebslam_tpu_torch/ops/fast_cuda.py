"""Wrapper of the hand-written CUDA FAST kernel (``csrc/fast.cu``).

The kernel is the port of ``coebslam_tpu/ops/fast_pallas.py::_kernel``:
FAST-9/16 strength, threshold + border gate and strict 3x3 NMS over all
pyramid levels of a frame in one launch. The library is compiled with
``nvcc`` for ``sm_90a`` at first use into the repository's ``build/``
directory and loaded with ctypes.

A tensor on the CPU goes to the plain version
(``fast.strength_and_score_plain``); a CUDA tensor launches the kernel or
raises. ``LAUNCHES`` counts kernel launches. The C launcher picks the
kernel's 16-byte load/store variant when ``W % 4 == 0`` and the three maps
are 16-byte aligned, its 4-byte variant otherwise.

Contract: the canvas is zero beyond each level's true extent ``hw[l]``, as
``extractor.level_canvas`` builds it and as the reference's canvas mode
(``fast_pallas.strength_and_score(..., true_h, true_w)``) assumes. The
kernel reads only each level's extent and writes 0 beyond row ``h + 3``
and column ``w + 3`` without computing there, which is what the plain
version gives on such a canvas. Checking it would need a host
synchronisation, so the wrapper does not; the CPU tests hold the property.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from . import fast

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "fast.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

#: Number of kernel launches in this process (the main path adds one per
#: frame: all pyramid levels go in one launch).
LAUNCHES = 0

#: Operations per live pixel as ``csrc/fast.cu`` counts them: 86
#: two-operand min/max for the two arc reductions, 2 subtractions of the
#: centre and 1 max for max(a, -b), 3 for the gate and 5 for the NMS.
FAST_OPS_PER_PIXEL = 97

#: Most levels one launch takes (a warp's lanes hold them).
MAX_LEVELS = 32

_lib = None
_lock = threading.Lock()


def work(hw_shapes, L: int, H: int, W: int):
    """(bytes, operations) the fused function needs on a [L, H, W] canvas
    whose levels have the true extents ``hw_shapes`` [(h, w), ...]: each
    live input float read once, both full outputs written once, and
    ``FAST_OPS_PER_PIXEL`` operations per live pixel."""
    live = sum(int(h) * int(w) for h, w in hw_shapes)
    return 4 * live + 2 * 4 * L * H * W, FAST_OPS_PER_PIXEL * live


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = os.path.join(cand, "bin", "nvcc") if cand else ""
        if path and os.path.exists(path):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: cannot build the FAST kernel")
    return found


def build(src: Path = _SRC, defines=()) -> Path:
    """Compile a FAST kernel source (by default ``csrc/fast.cu``) with the
    macros ``defines`` (for example ``("FAST_TIMELINE",)``) into ``build/``,
    keyed by the source's hash and the macros, and return the library's
    path; a library already built the same way is reused. The compiler's
    ``-Xptxas -v`` report goes beside it as ``<name>.ptxas.txt``."""
    flags = [f"-D{d}" for d in defines]
    digest = hashlib.sha256(Path(src).read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libcoebslam_fast_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *flags,
           "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    (BUILD_DIR / f"{out.stem}.ptxas.txt").write_text(proc.stderr)
    return out


def load(path) -> ctypes.CDLL:
    """Load a built FAST library and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    fn = lib.coebslam_fast_strength_score
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _library():
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
    return _lib


def strength_and_score(canvas, thr, hw):
    """FAST strength and gated NMS score of a [L, H, W] canvas stack.

    Args:
      canvas: [L, H, W] float32, level l in ``canvas[l, :h_l, :w_l]``, zero
        elsewhere (the contract above).
      thr: 0-d float32 tensor, the detection threshold (may live on the
        device: it is never read to the host).
      hw: [L, 2] int32, the true (h, w) of each level, at most (H, W);
        1 <= L <= ``MAX_LEVELS``.
    Returns:
      (strength, score): [L, H, W] float32 each.
    """
    global LAUNCHES
    if canvas.device.type == "cpu":
        return fast.strength_and_score_plain(canvas, thr, hw)
    out = run(_library(), canvas, thr, hw)
    LAUNCHES += 1
    return out


def run(lib, canvas, thr, hw):
    """Check the inputs and launch the kernel of ``lib`` (a library from
    ``load``) on the current stream; return (strength, score)."""
    if canvas.device.type != "cuda":
        raise ValueError(f"FAST kernel needs a CUDA tensor, got {canvas.device}")
    if canvas.dtype != torch.float32 or canvas.dim() != 3 \
            or not canvas.is_contiguous():
        raise ValueError("canvas must be a contiguous [L, H, W] float32 tensor")
    L, H, W = canvas.shape
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"canvas must hold 1 to {MAX_LEVELS} levels, got {L}")
    if thr.dtype != torch.float32 or thr.numel() != 1 \
            or thr.device != canvas.device:
        raise ValueError("thr must be one float32 on the canvas' device")
    if hw.dtype != torch.int32 or tuple(hw.shape) != (L, 2) \
            or not hw.is_contiguous() or hw.device != canvas.device:
        raise ValueError("hw must be a contiguous [L, 2] int32 tensor on the "
                         "canvas' device")
    strength = torch.empty_like(canvas)
    score = torch.empty_like(canvas)
    thr = thr.contiguous()
    stream = torch.cuda.current_stream(canvas.device).cuda_stream
    err = lib.coebslam_fast_strength_score(
        canvas.data_ptr(), hw.data_ptr(), thr.data_ptr(), strength.data_ptr(),
        score.data_ptr(), L, H, W, stream)
    if err != 0:
        raise RuntimeError(f"FAST kernel launch failed: cudaError {err}")
    return strength, score

"""Start ranks on this machine and run a function on each.

PyTorch has no single-process mesh of virtual devices (JAX's tests get one
from ``--xla_force_host_platform_device_count``), so the sharded solvers
run in one process per rank. ``launch(fn, n, *args)`` spawns ``n`` ranks
(``torch.multiprocessing``, ``spawn``), joins them in a process group
through a file in a temporary directory (no network), runs ``fn(*args)``
on each and returns rank 0's result. A rank's exception is raised in the
caller; there is no retry and no fall back to fewer ranks. With ``n == 1``
the function runs in this process over a 1-rank group.

Backends: ``gloo`` on the CPU; on CUDA ``nccl`` when each rank has a card
of its own, ``gloo`` (with host copies, ``sharded_ba``) when ranks share
cards, since NCCL refuses two ranks on one device. A collective that waits
longer than ``COLLECTIVE_TIMEOUT_S`` fails the rank instead of hanging
it.

``fn`` must be importable by name (a module-level function of a package),
since spawned ranks start from a fresh import.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..utils.device import resolve_device

COLLECTIVE_TIMEOUT_S = 120.0

_rank_device = None      # the device this process serves as a rank


def backend_for(device_type: str, n_ranks: int) -> str:
    """The collective backend for ``n_ranks`` ranks on ``device_type``."""
    if device_type == "cuda" and n_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device() -> torch.device:
    """This rank's device: the one ``launch`` gave it; in a group made
    otherwise (``multihost.initialize``), the current card under NCCL,
    else the CPU."""
    if _rank_device is not None:
        return _rank_device
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@contextlib.contextmanager
def process_group(rank: int, n_ranks: int, device_type: str, store: str):
    """This process as rank ``rank`` of ``n_ranks`` on ``device_type``
    (a card chosen round-robin under CUDA), meeting at the file
    ``store``; the group is destroyed on exit."""
    global _rank_device
    if dist.is_initialized():
        raise RuntimeError("a process group already exists in this process")
    device = torch.device("cpu")
    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        torch.cuda.init()           # DeviceMesh then keeps this card
    dist.init_process_group(backend_for(device_type, n_ranks),
                            init_method=f"file://{store}", rank=rank,
                            world_size=n_ranks,
                            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    _rank_device = device
    try:
        yield
    finally:
        _rank_device = None
        dist.destroy_process_group()


def _rank_main(rank, n_ranks, device_type, store, threads, out_path, fn,
               args):
    torch.set_num_threads(threads)
    with process_group(rank, n_ranks, device_type, store):
        result = fn(*args)
    if rank == 0:
        torch.save(result, out_path)


def launch(fn, n_ranks: int, *args, device=None):
    """Run ``fn(*args)`` on ``n_ranks`` ranks on ``device``'s type (default
    CUDA); returns rank 0's result. Pass tensors in ``args`` on the CPU;
    ``fn`` moves them to ``rank_device()``."""
    device = resolve_device(device, "launch")
    if n_ranks < 1:
        raise ValueError(f"launch: {n_ranks} ranks")
    tmp = tempfile.mkdtemp(prefix="coebslam_ranks_")
    store = os.path.join(tmp, "store")
    try:
        if n_ranks == 1:
            with process_group(0, 1, device.type, store):
                return fn(*args)
        out_path = os.path.join(tmp, "result.pt")
        threads = max(1, torch.get_num_threads() // n_ranks)
        mp.start_processes(
            _rank_main, args=(n_ranks, device.type, store, threads,
                              out_path, fn, args),
            nprocs=n_ranks, join=True, start_method="spawn")
        return torch.load(out_path, weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

"""Meshes of ranks for the distributed solvers.

Counterpart of ``coebslam_tpu/parallel/mesh.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group (one rank per device), with named dimensions; ``axis_groups`` gives
the process group and this rank's coordinate along a dimension or a tuple
of dimensions, which is what the sharded solvers reduce and slice by.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .launch import rank_device

POINT_AXIS = "pts"      # data-parallel axis over map points / observations
FRAME_AXIS = "frames"   # data-parallel axis over camera frames

Axis = Union[str, Sequence[str]]


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = POINT_AXIS) -> DeviceMesh:
    """1-D mesh over the first ``n_devices`` ranks (all by default). Every
    rank of the process group calls it (it creates process groups)."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh: {n} ranks asked, the group has {world}")
    return DeviceMesh(rank_device().type, torch.arange(n),
                      mesh_dim_names=(axis_name,))


def axis_groups(mesh: DeviceMesh, axis: Axis) -> Tuple[object, int, int]:
    """(process group, size, this rank's index) along ``axis``: a mesh
    dimension's name, or a tuple of names flattened row-major (the order
    of JAX's ``PartitionSpec((a, b))``). A tuple must name every dimension
    of a mesh over every rank; its group is the default one."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    dims = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh")
    size, index = 1, 0
    for name in names:
        d = dims.index(name)
        size *= mesh.shape[d]
        index = index * mesh.shape[d] + coord[d]
    if len(names) == 1:
        group = mesh.get_group(names[0])
    elif sorted(names) == sorted(dims) \
            and mesh.mesh.numel() == dist.get_world_size():
        group = dist.group.WORLD      # row-major: rank = flat coordinate
    else:
        raise ValueError(f"axis {names}: a tuple must name every dimension "
                         f"of a mesh over every rank ({dims})")
    if dist.get_rank(group) != index:
        raise RuntimeError(f"axis {names}: group rank "
                           f"{dist.get_rank(group)} is not the coordinate "
                           f"{index}")
    return group, size, index

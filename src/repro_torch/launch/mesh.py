"""Device meshes over the initialised process group.

The port's counterpart of the JAX package's ``launch/mesh.py``.  A mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` with named axes, made by
``init_device_mesh`` over every rank of the default group, row-major (the
last axis is the fastest).  Single pod: ``(16, 16)`` = 256 ranks,
``('data', 'model')``.  Multi-pod: ``(2, 16, 16)`` = 512 ranks,
``('pod', 'data', 'model')``.  A CUDA mesh needs the NCCL backend and a
CPU mesh gloo: there is no fallback from one to the other.  Nothing here
runs at import.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..distributed.simplex_sharding import BACKENDS, _group_backend
from ..kernels.policy import resolve_device

__all__ = ["make_mesh", "make_production_mesh"]


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None):
    """A named mesh of ``shape`` over every rank of the default group.

    Args:
        shape: Ranks along each axis; their product is the world size.
        axes: The axes' names, e.g. ``("data", "model")``.
        device: The ranks' device type: None for the card (NCCL), or
            ``'cpu'`` (gloo).

    Returns:
        ``DeviceMesh`` with ``mesh_dim_names == tuple(axes)``.

    Raises:
        ValueError: no group is initialised, its world size is not the
            product of ``shape``, the names do not match the shape, or the
            group's backend is not the device's.
    """
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    device_type = resolve_device(device).type
    if device_type not in BACKENDS:
        raise ValueError(f"no collective backend for {device_type} tensors")
    need = math.prod(shape)
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"need a process group of {need} ranks for a {shape} mesh over "
                         f"{axes}; call torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"need {need} ranks for a {shape} mesh over {axes}, found a group "
                         f"of {world}")
    backend = _group_backend(device_type)
    if backend != BACKENDS[device_type]:
        raise ValueError(f"{device_type} tensors take the {BACKENDS[device_type]} backend, "
                         f"the group runs {backend or 'none for them'}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh: ``(16, 16)`` over ``('data', 'model')``, or with
    ``multi_pod`` ``(2, 16, 16)`` over ``('pod', 'data', 'model')``.

    Raises:
        ValueError: as ``make_mesh``, e.g. a group of other than 256 (512)
            ranks.
    """
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device)
    return make_mesh((16, 16), ("data", "model"), device)

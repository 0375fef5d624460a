"""Multi-process glue: process-group start-up and partition ownership.

Counterpart of :mod:`spsparse_tpu.dist.multihost` on ``torch.distributed``.
Under ``torchrun`` (one process a GPU) a program is::

    from spsparse_torch.dist import multihost as mh

    mh.initialize()                       # from torchrun's environment
    mesh = mh.pod_mesh()                  # one partition a rank
    part = partition_rows(A, mesh.n_parts, device="cpu")
    y = dist_spmv(part, x_parts, mesh)    # this rank's (1, rows_local)
    save_netcdf_sharded(prefix, part, parts=mh.my_partitions(part.n_parts))

In one process with no launcher configuration the same calls work:
``initialize`` does nothing, ``is_multiprocess`` is false, ``pod_mesh``
is a one-partition :class:`~.mesh.StackedMesh` and ``my_partitions``
returns every partition.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch

from .mesh import GroupMesh, StackedMesh

__all__ = ["initialize", "pod_mesh", "my_partitions", "is_multiprocess"]

_LAUNCH_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR")


def initialize(**kwargs) -> None:
    """``torch.distributed.init_process_group`` with NCCL when CUDA is
    present and Gloo otherwise, from the ``torchrun`` environment
    (``env://``) unless ``kwargs`` give ``init_method``/``store``, rank
    and world size. Does nothing when a group already exists, or in a
    single process with neither launcher environment nor ``kwargs``."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if not kwargs and not all(k in os.environ for k in _LAUNCH_ENV):
        return
    kwargs.setdefault("backend",
                      "nccl" if torch.cuda.is_available() else "gloo")
    if kwargs["backend"] == "nccl" and "device_id" not in kwargs:
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(**kwargs)


def is_multiprocess() -> bool:
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_world_size() > 1


def pod_mesh(axis: str = "x", device=None):
    """A :class:`~.mesh.GroupMesh` over the world (one partition a rank),
    or, with no process group, a one-partition
    :class:`~.mesh.StackedMesh` on ``device``."""
    import torch.distributed as dist

    if dist.is_initialized():
        return GroupMesh(device=device, axis=axis)
    return StackedMesh(1, device, axis=axis)


def my_partitions(n_parts: int) -> Sequence[int]:
    """The partitions this process owns for its checkpoint writes:
    partition ``p`` belongs to rank ``p % world``, as the JAX package
    assigns partition ``p`` to the host of device ``p % devices``."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return list(range(n_parts))
    world, me = dist.get_world_size(), dist.get_rank()
    return [p for p in range(n_parts) if p % world == me]

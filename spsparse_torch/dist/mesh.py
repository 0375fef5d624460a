"""The two meshes the distributed ops run over, and their collectives.

Counterpart of ``jax.sharding.Mesh`` with the collectives that the JAX
package's ``shard_map`` bodies use (``all_gather``, ``ppermute`` to a ring
neighbour, ``all_to_all``, ``pmax``/``pmin``/``psum`` and ``axis_index``).
Every op of :mod:`spsparse_torch.dist` is written once, as a body batched
over a leading axis of the partitions a mesh *owns*, and runs over either
mesh:

* :class:`StackedMesh` — all ``P`` partitions on one device in one process
  (the counterpart of the JAX package's single-process mesh of 8 virtual
  CPU devices, or of one TPU slice). The owned axis is all of ``P``, and a
  collective is a tensor op on it: a ring shift is ``roll``, ``all_to_all``
  a transpose of the two partition axes, ``all_gather`` the stack itself,
  ``pmax`` a max.
* :class:`GroupMesh` — one partition per rank of a ``torch.distributed``
  process group (NCCL on CUDA cards, Gloo on the CPU): the counterpart of
  :mod:`spsparse_tpu.dist.multihost`. The owned axis has length 1, and the
  collectives are ``all_gather_into_tensor``, ``all_to_all_single``,
  ``batch_isend_irecv`` to the ring neighbours and ``all_reduce``.

Shapes: a *global* array has a leading axis of ``P`` partitions; an
*owned* array has a leading axis of ``len(mesh.owned)``. :meth:`shard`
takes the first to the second on the mesh's device, :meth:`gather` the
second back to the first (on every rank of a group).

Layouts: an op given a global layout (a :class:`RowPartitionedCSR` and
the like) shards it on every call. :meth:`shard_layout` does it once: it
returns the layout holding only the mesh's own blocks on its device,
marked with an :class:`Owned` record, and the ops take that as it is. On
a group, build the layout on the host (``device="cpu"``) and hold
``mesh.shard_layout(part)``: each card then holds its own block only.

Ring shifts: ``mesh.shift(t, k)`` gives each partition ``p`` the block
that partition ``(p + k) % P`` held, so ``k = 1`` is the JAX ring's
``ppermute`` with ``perm = [(i, (i - 1) % P)]``. ``shift_start`` posts the
exchange and returns a handle whose ``wait()`` gives the result: on a
group the receive of the next block is posted before the caller computes
on the current one, which keeps the overlap the JAX ring is built around.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["StackedMesh", "GroupMesh", "Owned", "check_mesh"]

Tensor = torch.Tensor


def _tensor(t, device) -> Tensor:
    """numpy array or tensor as a tensor on ``device``."""
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(t))
    return t.to(device)


def _check_global(t, n_parts: int) -> None:
    if t.shape[0] != n_parts:
        raise ValueError(f"shard: leading axis {t.shape[0]} != mesh size "
                         f"{n_parts}")


@dataclasses.dataclass(eq=False)
class Owned:
    """The mark of a layout that holds only a mesh's own blocks (made by
    ``mesh.shard_layout``): the mesh's partition count, the partition ids
    of the layout's leading axis and their device. ``col_span`` caches the
    ``(P, 2)`` host table of each partition's least and greatest live
    column, which the halo SpMV reads (filled on its first call)."""

    n_parts: int
    parts: tuple
    device: torch.device
    col_span: np.ndarray | None = None


def layout_parts(layout, leading: int) -> int:
    """A layout's partition count: the mesh's, once sharded, else the
    leading axis of its arrays."""
    return leading if layout.owner is None else layout.owner.n_parts


def shard_layout(mesh, layout):
    """``layout`` with every array field (each leads with the partition
    axis) replaced by the mesh's own blocks on its device, marked
    :class:`Owned`. A layout already sharded for this mesh comes back as
    it is; one sharded for another raises ``ValueError``."""
    own = layout.owner
    if own is not None:
        if (own.n_parts, own.parts, own.device) != (
                mesh.n_parts, tuple(mesh.owned), mesh.device):
            raise ValueError(
                f"layout sharded for partitions {own.parts} of "
                f"{own.n_parts} on {own.device}, not for {mesh!r}")
        return layout
    arrays = {f.name: mesh.shard(getattr(layout, f.name))
              for f in dataclasses.fields(layout)
              if isinstance(getattr(layout, f.name), (Tensor, np.ndarray))}
    return dataclasses.replace(
        layout, **arrays,
        owner=Owned(mesh.n_parts, tuple(mesh.owned), mesh.device))


class _Done:
    """The handle of an exchange that completed when it was posted."""

    def __init__(self, value: Tensor):
        self._value = value

    def wait(self) -> Tensor:
        return self._value


class StackedMesh:
    """All ``n_parts`` partitions on one ``device`` (the card unless the
    caller passes another), one process. ``owned`` is ``range(n_parts)``;
    collectives are tensor ops on the leading axis."""

    def __init__(self, n_parts: int, device=None, axis: str = "x"):
        if int(n_parts) < 1:
            raise ValueError(f"StackedMesh needs n_parts >= 1, got {n_parts}")
        self.n_parts = int(n_parts)
        self.device = resolve_device(device)
        self.axis = axis
        self.owned = range(self.n_parts)

    def __repr__(self) -> str:
        return f"StackedMesh(n_parts={self.n_parts}, device={self.device})"

    def shard(self, t) -> Tensor:
        """A global ``(P, ...)`` array on the mesh's device."""
        _check_global(t, self.n_parts)
        return _tensor(t, self.device)

    def shard_layout(self, layout):
        """The layout on the mesh's device, marked :class:`Owned`, once
        (see :func:`shard_layout`)."""
        return shard_layout(self, layout)

    def gather(self, t: Tensor) -> Tensor:
        """The owned blocks are all of them: ``t`` itself."""
        return t

    def axis_index(self) -> Tensor:
        """Partition ids of the owned blocks, ``(n_own,)`` int64."""
        return torch.arange(self.n_parts, device=self.device)

    def all_gather(self, t: Tensor) -> Tensor:
        """Owned ``(n_own, ...)`` -> the global ``(P, ...)`` stack, the same
        for every owned partition."""
        return t

    def shift(self, t: Tensor, k: int) -> Tensor:
        """Partition ``p`` receives partition ``(p + k) % P``'s block."""
        return torch.roll(t, -int(k), dims=0)

    def shift_start(self, t: Tensor, k: int) -> _Done:
        return _Done(self.shift(t, k))

    def all_to_all(self, t: Tensor) -> Tensor:
        """``t (n_own, P, ...)``, ``t[o, q]`` the block that owned partition
        ``o`` sends to ``q``; returns ``r (n_own, P, ...)`` with ``r[o, q]``
        the block ``q`` sent to ``o``."""
        return t.transpose(0, 1)

    def pmax(self, t: Tensor) -> Tensor:
        """Max over the partitions of owned ``(n_own, ...)``: ``(...)``."""
        return t.amax(dim=0)

    def pmin(self, t: Tensor) -> Tensor:
        return t.amin(dim=0)

    def psum(self, t: Tensor) -> Tensor:
        return t.sum(dim=0)


class _Pending:
    """The receive of a ring shift on a group, posted and not yet waited
    for."""

    def __init__(self, works, out: Tensor):
        self._works, self._out = works, out

    def wait(self) -> Tensor:
        for w in self._works:
            w.wait()
        return self._out[None]


class GroupMesh:
    """One partition per rank of a ``torch.distributed`` process group
    (the default group when ``group`` is None). ``owned`` is ``[rank]``.
    ``device`` defaults to ``cuda:<LOCAL_RANK>`` under NCCL and to the CPU
    under Gloo."""

    def __init__(self, group=None, device=None, axis: str = "x"):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                "GroupMesh needs an initialized torch.distributed process "
                "group (see spsparse_torch.dist.multihost.initialize)")
        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.n_parts = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        if device is None:
            device = (f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
                      if self.backend == "nccl" else "cpu")
        self.device = torch.device(device)
        self.axis = axis
        self.owned = [self.rank]

    def __repr__(self) -> str:
        return (f"GroupMesh(rank={self.rank}, n_parts={self.n_parts}, "
                f"backend={self.backend}, device={self.device})")

    def _global_rank(self, r: int) -> int:
        if self.group is None:
            return r
        return self._dist.get_global_rank(self.group, r)

    def shard(self, t) -> Tensor:
        """This rank's block ``t[rank:rank+1]`` of a global ``(P, ...)``
        array, on the mesh's device."""
        _check_global(t, self.n_parts)
        return _tensor(t[self.rank:self.rank + 1], self.device)

    def shard_layout(self, layout):
        """The layout holding this rank's block only, on the mesh's
        device, marked :class:`Owned`, once (see :func:`shard_layout`)."""
        return shard_layout(self, layout)

    def gather(self, t: Tensor) -> Tensor:
        """Owned ``(1, ...)`` -> global ``(P, ...)`` on every rank."""
        return self.all_gather(t)

    def axis_index(self) -> Tensor:
        return torch.tensor([self.rank], device=self.device)

    def all_gather(self, t: Tensor) -> Tensor:
        t = t.contiguous()
        out = torch.empty((self.n_parts,) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        gather = self._dist.all_gather_into_tensor
        if t.dtype == torch.bool:
            gather(out.view(torch.uint8), t.view(torch.uint8),
                   group=self.group)
        else:
            gather(out, t, group=self.group)
        return out

    def shift_start(self, t: Tensor, k: int) -> _Pending:
        """Post the receive from ``rank + k`` and the send to ``rank - k``;
        the returned handle's ``wait()`` gives the received block."""
        P = self.n_parts
        blk = t[0].contiguous()
        out = torch.empty_like(blk)
        if int(k) % P == 0:
            out.copy_(blk)
            return _Pending([], out)
        dist = self._dist
        src = self._global_rank((self.rank + int(k)) % P)
        dst = self._global_rank((self.rank - int(k)) % P)
        ops = [dist.P2POp(dist.irecv, out, src, self.group),
               dist.P2POp(dist.isend, blk, dst, self.group)]
        return _Pending(dist.batch_isend_irecv(ops), out)

    def shift(self, t: Tensor, k: int) -> Tensor:
        return self.shift_start(t, k).wait()

    def all_to_all(self, t: Tensor) -> Tensor:
        src = t[0].contiguous()
        out = torch.empty_like(src)
        self._dist.all_to_all_single(out, src, group=self.group)
        return out[None]

    def _reduce(self, t: Tensor, op) -> Tensor:
        out = t[0].clone()
        self._dist.all_reduce(out, op=op, group=self.group)
        return out

    def pmax(self, t: Tensor) -> Tensor:
        return self._reduce(t, self._dist.ReduceOp.MAX)

    def pmin(self, t: Tensor) -> Tensor:
        return self._reduce(t, self._dist.ReduceOp.MIN)

    def psum(self, t: Tensor) -> Tensor:
        return self._reduce(t, self._dist.ReduceOp.SUM)


def check_mesh(mesh, n_parts: int, axis: str, what: str,
               exc=ValueError) -> None:
    """The checks every op makes: ``axis`` is the mesh's one axis name, and
    the mesh holds as many partitions as the operand (raised as ``exc``,
    the JAX op's own error type where it has the check)."""
    if axis != mesh.axis:
        raise ValueError(f"{what}: axis {axis!r} is not the mesh's axis "
                         f"{mesh.axis!r}")
    if mesh.n_parts != int(n_parts):
        raise exc(f"{what}: layout built for P={n_parts}, the mesh has "
                  f"{mesh.n_parts}")

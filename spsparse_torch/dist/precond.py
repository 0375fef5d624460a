"""Distributed preconditioning: partition-local block-Jacobi.

Counterpart of :mod:`spsparse_tpu.dist.precond`. With the diagonal blocks
aligned inside the row partitions, applying ``M^{-1}`` is a batched matmul
local to every partition: no collective, so it adds no barrier to a CG
loop. Set-up (a batched ``torch.linalg.inv`` of the ``bs x bs`` diagonal
blocks) is paid once.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.coo import SparseCOO
from ..core.errors import SpSparseError
from ..solvers.precond import extract_diag_blocks
from .mesh import Owned, layout_parts

__all__ = ["DistBlockJacobi", "dist_block_jacobi"]

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DistBlockJacobi:
    """Inverted diagonal blocks, partition-major: ``inv (m, nb_local, bs,
    bs)``. Callable on a block-row-partitioned residual ``r (m,
    rows_local)`` (the layout of :func:`~.partition.partition_vector`):
    one batched matmul, local to every partition. On a group mesh, give
    each rank ``mesh.shard_layout(pre)``: its own blocks only."""

    inv: Tensor
    owner: Owned | None = None

    @property
    def n_parts(self) -> int:
        return layout_parts(self, self.inv.shape[0])

    @property
    def rows_local(self) -> int:
        return self.inv.shape[1] * self.inv.shape[3]

    def __call__(self, r_parts: Tensor) -> Tensor:
        m, nb, bs, _ = self.inv.shape
        rb = r_parts.reshape(m, nb, bs).to(self.inv.dtype)
        z = torch.einsum("pbij,pbj->pbi", self.inv, rb)
        return z.reshape(m, nb * bs).to(r_parts.dtype)


def dist_block_jacobi(a: SparseCOO, n_parts: int, *, bs: int = 128,
                      eps: float = 1e-12) -> DistBlockJacobi:
    """The partition-aligned block-Jacobi preconditioner of the block-row
    distribution of :func:`~.partition.partition_rows`, on ``a``'s device.

    ``bs`` is clipped to ``rows_local`` and must divide it (a block may not
    straddle two partitions: applying it would need a halo). Rows with an
    empty diagonal (the padding rows of the last partition among them) get
    a unit diagonal — the guard of the single-device
    :func:`spsparse_torch.solvers.block_jacobi_preconditioner`."""
    if a.rank != 2:
        raise SpSparseError("dist_block_jacobi requires a rank-2 array")
    rows_local = -(-a.shape[0] // n_parts)
    bs = min(bs, rows_local)
    if rows_local % bs:
        raise SpSparseError(
            f"bs={bs} must divide rows_local={rows_local} (blocks cannot "
            "straddle partition boundaries)")
    blocks = extract_diag_blocks(a, bs)                 # (ceil(n/bs), ...)
    pad = n_parts * rows_local // bs - blocks.shape[0]
    if pad > 0:
        blocks = torch.cat([blocks, blocks.new_zeros((pad, bs, bs))])
    d = torch.diagonal(blocks, dim1=1, dim2=2)
    fix = (d.abs() <= eps).to(blocks.dtype)
    inv = torch.linalg.inv(blocks + torch.diag_embed(fix))
    return DistBlockJacobi(inv=inv.reshape(n_parts, rows_local // bs, bs,
                                           bs))

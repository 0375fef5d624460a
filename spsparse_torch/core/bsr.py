"""BSR (block sparse row) storage: a sparse pattern of dense tiles.

Counterpart of :mod:`spsparse_tpu.core.bsr`, field for field:
``row_ptr (nbrows+1,)`` int32 over block rows, ``bcols (cap_blocks,)``
int32 block-column ids (sentinel ``nbcols`` on padding), ``blocks
(cap_blocks, bh, bw)`` dense tiles (zero padding) and ``nnz_blocks``, the
live block count (a Python int, as ``SparseCOO.nnz``). Each stored tile
makes one ``(bh, bw) @ (bw, N)`` product in :func:`spsparse_torch.ops.
spmm_bsr`. The layout is built with tensor ops on the operand's device.
"""

from __future__ import annotations

import dataclasses

import torch

from .coo import SparseCOO, round_up_pow2
from .errors import SpSparseError

__all__ = ["SparseBSR", "to_bsr"]

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SparseBSR:
    row_ptr: Tensor
    bcols: Tensor
    blocks: Tensor
    nnz_blocks: int
    shape: tuple

    @property
    def block_shape(self) -> tuple[int, int]:
        return self.blocks.shape[1], self.blocks.shape[2]

    @property
    def nbrows(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def nbcols(self) -> int:
        return -(-self.shape[1] // self.blocks.shape[2])

    @property
    def cap_blocks(self) -> int:
        return self.bcols.shape[0]

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def valid_mask(self) -> Tensor:
        return torch.arange(self.cap_blocks, device=self.device) \
            < self.nnz_blocks

    def block_rows(self) -> Tensor:
        """Per-block block-row ids (int32), derived from ``row_ptr``."""
        slots = torch.arange(self.cap_blocks, dtype=self.row_ptr.dtype,
                             device=self.device)
        return (torch.searchsorted(self.row_ptr, slots, right=True)
                .to(torch.int32) - 1)

    def to_dense(self) -> Tensor:
        bh, bw = self.block_shape
        nr, nc = self.nbrows * bh, self.nbcols * bw
        nb = self.nnz_blocks
        dense = torch.zeros((self.nbrows, self.nbcols, bh, bw),
                            dtype=self.blocks.dtype, device=self.device)
        dense.index_put_((self.block_rows()[:nb].long(),
                          self.bcols[:nb].long()),
                         self.blocks[:nb], accumulate=True)
        return dense.permute(0, 2, 1, 3).reshape(nr, nc)[
            : self.shape[0], : self.shape[1]]


def to_bsr(a: SparseCOO, block_shape: tuple[int, int] = (8, 128), *,
           cap_blocks: int | None = None) -> SparseBSR:
    """COO -> BSR on the operand's device: group entries into dense
    ``block_shape`` tiles (duplicates sum)."""
    if a.rank != 2:
        raise SpSparseError("to_bsr requires a rank-2 array")
    bh, bw = block_shape
    idx = a.indices[: a.nnz].long()
    vals = a.vals[: a.nnz]
    dev = idx.device
    nbrows = -(-a.shape[0] // bh)
    nbcols = -(-a.shape[1] // bw)
    key = (idx[:, 0] // bh) * nbcols + idx[:, 1] // bw
    uniq = torch.unique(key)
    nblocks = uniq.shape[0]
    if cap_blocks is None:
        cap_blocks = round_up_pow2(max(nblocks, 1))
    elif nblocks > cap_blocks:
        raise SpSparseError(f"cap_blocks={cap_blocks} < {nblocks}")
    blocks = torch.zeros((cap_blocks, bh, bw), dtype=vals.dtype, device=dev)
    block_of = torch.searchsorted(uniq, key)
    blocks.index_put_((block_of, idx[:, 0] % bh, idx[:, 1] % bw), vals,
                      accumulate=True)
    bcols = torch.full((cap_blocks,), nbcols, dtype=torch.int32, device=dev)
    bcols[:nblocks] = (uniq % nbcols).to(torch.int32)
    row_ptr = torch.searchsorted(
        uniq // nbcols, torch.arange(nbrows + 1, device=dev)).to(torch.int32)
    return SparseBSR(row_ptr=row_ptr, bcols=bcols, blocks=blocks,
                     nnz_blocks=int(nblocks), shape=tuple(a.shape))

"""Preconditioners over the port's formats.

PyTorch counterpart of :mod:`spsparse_tpu.solvers.precond`:

* **Jacobi** (:func:`spsparse_torch.solvers.jacobi_preconditioner`) —
  elementwise inverse diagonal.
* **Block-Jacobi** (:func:`block_jacobi_preconditioner`) — batched dense
  inverses of the ``bs x bs`` diagonal blocks, applied as one batched
  matmul per iteration.
* **Neumann series** (:func:`neumann_preconditioner`) —
  ``M^-1 = sum_{i<k} (I - D^-1 A)^i D^-1``: ``k-1`` extra applications of
  the operator's own SpMV, no triangular solves.

:func:`extract_diagonal` feeds them from COO, CSR, DIA, BSR and tiled COO
operands.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.bsr import SparseBSR
from ..core.coo import SparseCOO
from ..core.dia import SparseDIA
from ..core.errors import SpSparseError
from ..core.structure import SparseCSR
from ..core.tiled import TILE, SparseTiledCOO

Tensor = torch.Tensor

__all__ = ["extract_diagonal", "block_jacobi_preconditioner",
           "neumann_preconditioner", "extract_diag_blocks"]

def _diag_len(shape) -> int:
    return min(shape[0], shape[1])


def _scatter_diag(n: int, rows: Tensor, hit: Tensor, vals: Tensor) -> Tensor:
    """``out[rows[e]] += vals[e]`` over the entries with ``hit``; length
    ``n`` (duplicates sum, as COO ADD semantics)."""
    idx = torch.where(hit, rows.long(), n)
    out = torch.zeros(n + 1, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, idx, torch.where(hit, vals,
                                              torch.zeros_like(vals)))[:n]


def extract_diagonal(a) -> Tensor:
    """``diag(A)`` as a dense ``(min(shape),)`` vector of a rank-2
    :class:`SparseCOO`, :class:`SparseCSR`, :class:`SparseDIA`,
    :class:`SparseBSR` (square blocks) or :class:`SparseTiledCOO`.
    Duplicate entries sum."""
    if isinstance(a, SparseCOO):
        if a.rank != 2:
            raise SpSparseError("extract_diagonal requires a rank-2 array")
        i, j = a.indices[:, 0], a.indices[:, 1]
        return _scatter_diag(_diag_len(a.shape), i,
                             a.valid_mask() & (i == j), a.vals)
    if isinstance(a, SparseCSR):
        rows = a.row_ids()
        hit = (a.cols == rows) & (a.cols < a.ncols)
        return _scatter_diag(_diag_len(a.shape), rows, hit, a.vals)
    if isinstance(a, SparseDIA):
        n = _diag_len(a.shape)
        if 0 in a.offsets:
            return a.data[a.offsets.index(0), :n]
        return torch.zeros(n, dtype=a.data.dtype, device=a.device)
    if isinstance(a, SparseBSR):
        bh, bw = a.block_shape
        if bh != bw:
            raise SpSparseError(
                "extract_diagonal on BSR requires square blocks")
        n = _diag_len(a.shape)
        nb = -(-n // bh)
        # Block k carries main-diagonal entries iff its column is its row.
        brow = a.block_rows().long()
        hit = a.valid_mask() & (a.bcols.long() == brow)
        bdiag = torch.diagonal(a.blocks, dim1=1, dim2=2)       # (cap, bh)
        dest = brow[:, None] * bh + torch.arange(bh, device=a.device)
        out = _scatter_diag(nb * bh, dest.reshape(-1),
                            hit[:, None].expand(-1, bh).reshape(-1),
                            bdiag.reshape(-1))
        return out[:n]
    if isinstance(a, SparseTiledCOO):
        n = _diag_len(a.shape)
        live = a.valid_mask()[:, None] & (a.vals != 0)
        on_diag = ((a.tile_row == a.tile_col)[:, None]
                   & (a.rows == a.cols) & live)
        gi = a.tile_row[:, None].long() * TILE + a.rows.long()
        return _scatter_diag(n, gi.reshape(-1), on_diag.reshape(-1),
                             a.vals.reshape(-1))
    raise SpSparseError(f"extract_diagonal: unsupported type {type(a)!r}")


def extract_diag_blocks(a, bs: int) -> Tensor:
    """The ``bs x bs`` main-diagonal blocks of a rank-2 :class:`SparseCOO`
    as a dense ``(nb, bs, bs)`` stack (zero-filled; the last block of a
    non-multiple extent is zero-padded). Entries outside the blocks are
    ignored."""
    if not isinstance(a, SparseCOO) or a.rank != 2:
        raise SpSparseError("extract_diag_blocks requires a rank-2 "
                            "SparseCOO (convert other formats via COO)")
    n = _diag_len(a.shape)
    nb = -(-n // bs)
    i, j = a.indices[:, 0].long(), a.indices[:, 1].long()
    bi, bj = i // bs, j // bs
    hit = a.valid_mask() & (bi == bj) & (i < n) & (j < n)
    flat = (bi * bs + i % bs) * bs + j % bs
    out = _scatter_diag(nb * bs * bs, flat, hit, a.vals)
    return out.reshape(nb, bs, bs)


def block_jacobi_preconditioner(a, bs: int = 128,
                                eps: float = 1e-12) -> Callable:
    """Block-Jacobi ``z = M^{-1} r`` with ``bs x bs`` diagonal blocks.

    Set-up inverts the diagonal blocks once (batched
    :func:`torch.linalg.inv`); rows with an empty diagonal (the zero
    padding of the last block, or a missing entry) get a unit diagonal so
    every block stays invertible. Application is one batched matmul.
    Returns a callable for :func:`spsparse_torch.solvers.pcg_solve`."""
    blocks = extract_diag_blocks(a, bs)
    nb = blocks.shape[0]
    n = _diag_len(a.shape)
    d = torch.diagonal(blocks, dim1=1, dim2=2)
    fix = (d.abs() <= eps).to(blocks.dtype)
    # Only the inverses are kept: the blocks themselves are not needed.
    inv = torch.linalg.inv(blocks + torch.diag_embed(fix))
    del blocks

    def apply(r: Tensor) -> Tensor:
        rp = torch.nn.functional.pad(r, (0, nb * bs - r.shape[0]))
        z = torch.einsum("bij,bj->bi", inv, rp.reshape(nb, bs).to(inv.dtype))
        return z.reshape(-1)[:n].to(r.dtype)

    return apply


def neumann_preconditioner(matvec: Callable[[Tensor], Tensor], diag: Tensor,
                           k: int = 2, eps: float = 1e-12) -> Callable:
    """Truncated Neumann-series preconditioner: with ``D = diag(A)`` and
    ``N = I - D^{-1} A``, ``M^{-1} r = (I + N + ... + N^{k-1}) D^{-1} r``,
    each extra term one application of the operator's own SpMV. ``k=1`` is
    Jacobi."""
    if k < 1:
        raise SpSparseError("neumann_preconditioner requires k >= 1")
    dinv = torch.where(diag.abs() > eps, 1.0 / diag, torch.ones_like(diag))

    def apply(r: Tensor) -> Tensor:
        y = dinv * r
        z = y
        for _ in range(k - 1):
            y = y - dinv * matvec(y)
            z = z + y
        return z

    return apply

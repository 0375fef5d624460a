"""SpMV/SpMM over the tiled COO format.

Counterpart of :mod:`spsparse_tpu.ops.tiled_ops`. The JAX package computes
each tile's contribution as a pair of one-hot matrix products, which is
the TPU's way to gather and scatter on its matrix unit. That is XLA code,
not a Pallas kernel, so the port computes the same function directly: for
every live tile ``t`` and entry ``e``,

    Y[tile_row[t]*128 + rows[t, e]] +=
        vals[t, e] * X[tile_col[t]*128 + cols[t, e]]

by a gather of X rows and an ``index_add_`` into Y, in float32. The work is
blocked over tiles so that no intermediate exceeds about
:data:`BLOCK_BYTES` (the role of the JAX package's ``_SPMM_BLOCK_BYTES``);
the ``(nt, cap, 128)`` one-hots are never built. Padding slots (value 0 at
offset (0, 0)) are summed like live entries, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..core.coo import operand_tensor
from ..core.errors import spsparse_error
from ..core.tiled import TILE, SparseTiledCOO
from .spmm import _gather_rows

__all__ = ["spmv_tiled", "spmm_tiled", "BLOCK_BYTES", "chunks"]

Tensor = torch.Tensor

# Bound on a materialised intermediate of the blocked plain products.
BLOCK_BYTES = 128 << 20


def chunks(n: int, bytes_per_item: int, limit: int = BLOCK_BYTES):
    """Slices of ``range(n)`` whose items take at most about ``limit``
    bytes together (at least one item a slice)."""
    step = max(1, limit // max(int(bytes_per_item), 1))
    for lo in range(0, n, step):
        yield slice(lo, min(n, lo + step))


def spmm_tiled(tl: SparseTiledCOO, X: Tensor) -> Tensor:
    """``Y = A @ X`` (float32, ``(shape[0], N)``) over the tiled format."""
    X = operand_tensor(X, tl.device)
    if X.shape[0] != tl.shape[1]:
        spsparse_error(-1, "Inner dimensions for A (%d) and X (%d) must "
                       "match!", tl.shape[1], X.shape[0])
    N = X.shape[1]
    nbr, cap = tl.nbrows, tl.tile_cap
    Xf = X.to(torch.float32)
    Y = torch.zeros((nbr * TILE, N), dtype=torch.float32, device=X.device)
    for sl in chunks(tl.n_tiles, 3 * cap * N * 4):
        gcol = (tl.tile_col[sl, None].long() * TILE
                + tl.cols[sl].long()).reshape(-1)
        grow = (tl.tile_row[sl, None].long() * TILE
                + tl.rows[sl].long()).reshape(-1)
        prod = tl.vals[sl].reshape(-1, 1) * _gather_rows(Xf, gcol)
        Y.index_add_(0, grow, prod)
    return Y[: tl.shape[0]]


def spmv_tiled(tl: SparseTiledCOO, x: Tensor) -> Tensor:
    """``y = A @ x`` (float32) over the tiled format; dense 1-D ``x``."""
    x = operand_tensor(x, tl.device)
    if x.shape[0] != tl.shape[1]:
        spsparse_error(-1, "Inner dimensions for A (%d) and x (%d) must "
                       "match!", tl.shape[1], x.shape[0])
    return spmm_tiled(tl, x[:, None])[:, 0]

"""General (unstructured) sparse SpMV/SpMM: one prepared operand, the best
layout for its fill.

Counterpart of :mod:`spsparse_tpu.ops.general`. :func:`prepare_general`
runs once per matrix, on the operand's device:

1. :func:`spsparse_torch.core.tiled.pack_columns`, a column permutation
   that clusters each row block's columns into fewer 128x128 tiles (kept
   only when it lowers the tile count; the dense operand's rows are then
   permuted by one gather at multiply time);
2. :func:`spsparse_torch.core.tiled.to_tiled`;
3. a choice by the post-packing fill (entries per occupied tile):
   ``>= DENSE_FILL_THRESHOLD`` -> dense blocks, with the super-row window
   layout (kernel K5) when the window span check passes and the per-tile
   layout (kernel K6) otherwise; ``>= GATHER_FILL_THRESHOLD`` -> the entry
   layout (kernel K7); below that a row-gather layout, ELL when row lengths
   are even enough and an entry list otherwise. The gather products are
   plain PyTorch (they are XLA code in the JAX package too).

The thresholds are the JAX package's, so that both packages choose the
same layout for the same matrix. They were measured on a TPU; re-deriving
them on the H100 is ROADMAP item 14.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import torch

from ..core.coo import SparseCOO, operand_tensor
from ..core.errors import SpSparseError, spsparse_error
from ..core.tiled import SparseTiledCOO, pack_columns, to_tiled
from .spmm import _gather_rows
from .tiled_ops import chunks
from .tiled_spmm import (DENSE_FILL_THRESHOLD, PreparedTiledDense,
                         prepare_tiled_dense,
                         prepare_tiled_rows, spmm_tiled_dense,
                         spmm_tiled_onehot)
from .tiled_window import (PreparedTiledWindow, prepare_tiled_window,
                           spmm_tiled_window)

__all__ = ["PreparedGeneral", "PreparedGather", "PreparedGatherEll",
           "prepare_general", "spmm_general", "spmv_general",
           "GATHER_FILL_THRESHOLD"]

Tensor = torch.Tensor

# Entries per occupied tile below which the row-gather layouts take over
# from the tiled kernels. TPU-derived (the v5e crossover of a tile visit
# against a row gather); ROADMAP item 14 re-derives it on the H100.
GATHER_FILL_THRESHOLD = 32.0

# ELL is chosen while Kmax * nrows <= this multiple of nnz. TPU-derived
# (the v5e crossover of the ELL reduce against the entry-list segment sum);
# ROADMAP item 14 re-derives it on the H100.
_ELL_PAD_LIMIT = 3.0


@dataclasses.dataclass(frozen=True)
class PreparedGather:
    """Row-gather entry list of a consolidated (row-major sorted) COO, at
    its capacity: ``rows`` keeps the sentinel ``nrows`` on padding (the sum
    routes it to a dropped bucket); ``cols`` are clamped in range (padding
    values are zero)."""

    rows: Tensor
    cols: Tensor
    vals: Tensor
    shape: tuple

    @property
    def device(self) -> torch.device:
        return self.vals.device


@dataclasses.dataclass(frozen=True)
class PreparedGatherEll:
    """ELL row-gather layout: ``cols/vals (m, Kmax)``; padding slots hold
    column 0 and value 0. The product is a gather and a row reduce."""

    cols: Tensor
    vals: Tensor
    shape: tuple

    @property
    def device(self) -> torch.device:
        return self.vals.device


@dataclasses.dataclass(frozen=True)
class PreparedGeneral:
    """Kernel-ready general operand: the column order (new -> old; ``None``
    = identity, no X gather) and the prepared layout chosen at prepare time
    from the post-packing fill."""

    order: Any
    prep: Any

    @property
    def shape(self) -> tuple:
        return self.prep.shape

    @property
    def device(self) -> torch.device:
        return self.prep.device

    @property
    def kernel(self) -> str:
        if isinstance(self.prep, PreparedGatherEll):
            return "gather_ell"
        if isinstance(self.prep, PreparedGather):
            return "gather"
        if isinstance(self.prep, PreparedTiledWindow):
            return "dense_window"
        return ("dense_block" if isinstance(self.prep, PreparedTiledDense)
                else "one_hot")


def _prepare_gather(a: SparseCOO, dtype=None):
    """The ELL layout when ``Kmax * nrows <= _ELL_PAD_LIMIT * nnz``, else
    the entry list."""
    ac = a.consolidate((0, 1))
    idx = ac.indices
    nrows, ncols = ac.shape
    nnz = ac.nnz
    rows = idx[:nnz, 0].long()
    counts = torch.bincount(rows, minlength=nrows)
    kmax = int(counts.max()) if counts.numel() else 0
    if kmax and kmax * nrows <= _ELL_PAD_LIMIT * max(nnz, 1):
        ell_cols = torch.zeros((nrows, kmax), dtype=idx.dtype,
                               device=idx.device)
        ell_vals = torch.zeros((nrows, kmax), dtype=ac.vals.dtype,
                               device=idx.device)
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.arange(nnz, device=idx.device) - starts[rows]
        ell_cols[rows, slot] = idx[:nnz, 1]
        ell_vals[rows, slot] = ac.vals[:nnz]
        if dtype is not None and dtype != torch.float32:
            # halves the A payload; the product still sums in float32
            ell_vals = ell_vals.to(dtype)
        return PreparedGatherEll(cols=ell_cols, vals=ell_vals,
                                 shape=ac.shape)
    return PreparedGather(rows=idx[:, 0], cols=idx[:, 1].clamp(max=ncols - 1),
                          vals=ac.vals, shape=ac.shape)


def prepare_general(a: SparseCOO | SparseTiledCOO, *, pack: bool = True,
                    dtype=torch.float32) -> PreparedGeneral:
    """Prepare a rank-2 COO (or a ready :class:`SparseTiledCOO`) for
    repeated products, on its device.

    The layout follows the post-packing fill (see the module docstring).
    ``pack=False`` skips the column permutation (``order`` = identity), for
    an X that cannot be permuted. ``dtype=torch.bfloat16`` selects bfloat16
    blocks (dense layouts) or values (ELL), with float32 accumulation."""
    if isinstance(a, SparseTiledCOO):
        tl, order = a, None
    else:
        if a.rank != 2:
            spsparse_error(-1, "prepare_general requires a rank-2 array")
        tl_raw = to_tiled(a)
        tl, order = tl_raw, None
        if pack:
            ap, p_order = pack_columns(a)
            tl_packed = to_tiled(ap)
            if tl_packed.n_tiles < tl_raw.n_tiles:
                tl, order = tl_packed, p_order
    fill = int((tl.vals != 0).sum()) / max(tl.n_tiles, 1)
    if fill < GATHER_FILL_THRESHOLD and isinstance(a, SparseCOO):
        prep_g = _prepare_gather(a, dtype=dtype)
        if (dtype not in (torch.float32, None)
                and isinstance(prep_g, PreparedGather)):
            warnings.warn(
                "prepare_general: low fill + long-tailed rows select "
                "the entry-list row-gather layout, which is f32; "
                f"dtype={dtype} does not apply (the ELL layout would "
                "honor it)", stacklevel=2)
        return PreparedGeneral(order=None, prep=prep_g)
    if fill >= DENSE_FILL_THRESHOLD:
        try:
            prep = prepare_tiled_window(tl, dtype=dtype or torch.float32)
        except SpSparseError:
            prep = prepare_tiled_dense(tl, dtype=dtype or torch.float32)
    else:
        if dtype not in (torch.float32, None):
            warnings.warn(
                f"prepare_general: fill {fill:.1f} < {DENSE_FILL_THRESHOLD} "
                "selects the one-hot kernel, which streams f32 payloads "
                f"only; the requested dtype={dtype} mixed mode does not "
                "apply here", stacklevel=2)
        prep = prepare_tiled_rows(tl)
    return PreparedGeneral(order=order, prep=prep)


def _spmm_ell(p: PreparedGatherEll, X: Tensor) -> Tensor:
    """``(vals[:, :, None] * X[cols]).sum(1)`` in float32, blocked over
    rows; the gather is in X's own type."""
    m, kmax = p.cols.shape
    N = X.shape[1]
    Y = torch.empty((m, N), dtype=torch.float32, device=X.device)
    for sl in chunks(m, 3 * kmax * N * 4):
        g = X[p.cols[sl].reshape(-1).long()].to(torch.float32)
        Y[sl] = (p.vals[sl].to(torch.float32)[:, :, None]
                 * g.reshape(-1, kmax, N)).sum(dim=1)
    return Y


def _spmm_gather(p: PreparedGather, X: Tensor) -> Tensor:
    """Entry-list product: gathered X rows scaled and summed per row in
    float32 (padding rows go to a dropped extra row)."""
    nrows = p.shape[0]
    N = X.shape[1]
    Xf = X.to(torch.float32)
    Y = torch.zeros((nrows + 1, N), dtype=torch.float32, device=X.device)
    for sl in chunks(p.rows.shape[0], 3 * N * 4):
        prod = p.vals[sl].to(torch.float32)[:, None] \
            * _gather_rows(Xf, p.cols[sl])
        Y.index_add_(0, p.rows[sl].long(), prod)
    return Y[:nrows]


def spmm_general(pg: PreparedGeneral, X: Tensor) -> Tensor:
    """``Y = A @ X`` (float32) through the prepared layout; the rows of
    ``X`` are permuted by the packing order first. The tiled layouts run
    kernels K5, K6 or K7 on CUDA tensors."""
    X = operand_tensor(X, pg.device)
    if X.shape[0] != pg.shape[1]:
        spsparse_error(-1, "Inner dimensions for A (%d) and X (%d) must "
                       "match!", pg.shape[1], X.shape[0])
    Xp = X if pg.order is None else X[pg.order]
    if isinstance(pg.prep, PreparedGatherEll):
        return _spmm_ell(pg.prep, Xp)
    if isinstance(pg.prep, PreparedGather):
        return _spmm_gather(pg.prep, Xp)
    if isinstance(pg.prep, PreparedTiledWindow):
        return spmm_tiled_window(pg.prep, Xp)
    if isinstance(pg.prep, PreparedTiledDense):
        return spmm_tiled_dense(pg.prep, Xp)
    return spmm_tiled_onehot(pg.prep, Xp)


def spmv_general(pg: PreparedGeneral, x: Tensor) -> Tensor:
    """``y = A @ x``: the SpMM layouts at N = 1."""
    x = operand_tensor(x, pg.device)
    return spmm_general(pg, x[:, None])[:, 0]

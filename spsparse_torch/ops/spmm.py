"""Sparse x dense products: SpMV (dense vector) and SpMM (dense block).

PyTorch counterpart of :mod:`spsparse_tpu.ops.spmm`: the generic
CSR/COO/ELL paths (gather + per-row scatter-add) and BSR SpMM
(:func:`spmm_bsr`, one batched tile product). The DIA kernels live in
:mod:`spsparse_torch.ops.dia_stream`, the tiled kernels in
:mod:`spsparse_torch.ops.tiled_spmm` and :mod:`spsparse_torch.ops.
tiled_window`.

``filter_nan`` treats non-finite entries of the dense operand as zero so
that they do not poison the whole output row (the reference sketch,
``multiply_dense.hpp:20-23``).
"""

from __future__ import annotations

import torch

from ..core.bsr import SparseBSR
from ..core.coo import SparseCOO, operand_tensor
from ..core.errors import spsparse_error
from ..core.structure import SparseCSR, SparseELL, to_csr
from ..utils.trace import traced

__all__ = ["spmv", "spmm", "spmm_bsr"]

Tensor = torch.Tensor


def _clean(x: Tensor, filter_nan: bool) -> Tensor:
    if filter_nan:
        return torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    return x


def _as_csr(A, transpose: bool) -> SparseCSR:
    if isinstance(A, SparseCSR):
        if not transpose:
            return A
        A = A.to_coo()
    if isinstance(A, SparseCOO):
        return to_csr(A, transpose=transpose)
    raise TypeError(f"unsupported sparse operand type {type(A)}")


def _gather_rows(X: Tensor, cols: Tensor) -> Tensor:
    """``X[cols]`` with sentinel columns (``>= len(X)``) reading zero."""
    n = X.shape[0]
    ok = cols < n
    g = X[torch.where(ok, cols, 0).long()]
    mask = ok if X.ndim == 1 else ok[:, None]
    return torch.where(mask, g, torch.zeros((), dtype=X.dtype,
                                            device=X.device))


def _check_inner(ncols: int, k: int, what: str) -> None:
    if ncols != k:
        spsparse_error(-1, "Inner dimensions for A (%d) and %s (%d) must "
                       "match!", ncols, what, k)


@traced("spsparse.spmv")
def spmv(A, x, *, transpose: bool = False, filter_nan: bool = False) -> Tensor:
    """``y = A^(T?) @ x`` for a dense vector ``x``; returns a dense vector
    in the dtype promoted from ``A`` and ``x``. Accepts :class:`SparseCOO`,
    :class:`SparseCSR` or :class:`SparseELL` (ELL ignores ``transpose``)."""
    x = operand_tensor(x, A.vals.device)
    if isinstance(A, SparseELL):
        if transpose:
            raise NotImplementedError("transpose SpMV on ELL: convert first")
        _check_inner(A.ncols, x.shape[0], "x")
        xg = _gather_rows(_clean(x, filter_nan), A.cols.reshape(-1))
        return (A.vals * xg.reshape(A.cols.shape)).sum(dim=1)
    csr = _as_csr(A, transpose)
    _check_inner(csr.ncols, x.shape[0], "x")
    xv = _clean(x, filter_nan)
    out_dtype = torch.promote_types(csr.vals.dtype, xv.dtype)
    prod = (csr.vals.to(out_dtype)
            * _gather_rows(xv, csr.cols).to(out_dtype))[: csr.nnz]
    rows = csr.row_ids()[: csr.nnz].long()
    y = torch.zeros(csr.nrows, dtype=out_dtype, device=csr.device)
    return y.index_add_(0, rows, prod)


@traced("spsparse.spmm")
def spmm(A, X, *, transpose: bool = False, filter_nan: bool = False,
         accum_dtype=None) -> Tensor:
    """``Y = A^(T?) @ X`` for a dense block ``X (K, N)``; returns ``(I, N)``.
    ``accum_dtype`` forces the accumulation precision."""
    X = operand_tensor(X, A.device if isinstance(A, SparseBSR)
                       else A.vals.device)
    if X.ndim == 1:
        return spmv(A, X, transpose=transpose, filter_nan=filter_nan)
    if isinstance(A, SparseELL):
        if transpose:
            raise NotImplementedError("transpose SpMM on ELL: convert first")
        _check_inner(A.ncols, X.shape[0], "X")
        Xc = _clean(X, filter_nan)
        acc = accum_dtype or torch.promote_types(A.vals.dtype, Xc.dtype)
        g = _gather_rows(Xc, A.cols.reshape(-1)).reshape(
            *A.cols.shape, X.shape[1])
        return torch.einsum("rk,rkn->rn", A.vals.to(acc), g.to(acc))
    if isinstance(A, SparseBSR):
        if transpose:
            raise NotImplementedError("transpose SpMM on BSR: convert first")
        return spmm_bsr(A, _clean(X, filter_nan), accum_dtype=accum_dtype)
    csr = _as_csr(A, transpose)
    _check_inner(csr.ncols, X.shape[0], "X")
    Xc = _clean(X, filter_nan)
    acc = accum_dtype or torch.promote_types(csr.vals.dtype, Xc.dtype)
    prod = (csr.vals[:, None].to(acc)
            * _gather_rows(Xc, csr.cols).to(acc))[: csr.nnz]
    rows = csr.row_ids()[: csr.nnz].long()
    Y = torch.zeros((csr.nrows, X.shape[1]), dtype=acc, device=csr.device)
    return Y.index_add_(0, rows, prod)


def spmm_bsr(bsr: SparseBSR, X, *, accum_dtype=None) -> Tensor:
    """BSR x dense block: one ``(bh, bw) @ (bw, N)`` product per stored
    tile (a batched ``einsum``), summed into the block rows of ``Y``."""
    X = operand_tensor(X, bsr.device)
    bh, bw = bsr.block_shape
    _check_inner(bsr.shape[1], X.shape[0], "X")
    acc = accum_dtype or torch.promote_types(bsr.blocks.dtype, X.dtype)
    N = X.shape[1]
    nb = bsr.nnz_blocks
    rows = bsr.bcols[:nb, None].long() * bw + torch.arange(bw,
                                                           device=X.device)
    ok = rows < X.shape[0]
    gathered = X[torch.where(ok, rows, 0)].to(acc) * ok[:, :, None]
    tiles = torch.einsum("chw,cwn->chn", bsr.blocks[:nb].to(acc), gathered)
    Y = torch.zeros((bsr.nbrows, bh, N), dtype=acc, device=X.device)
    Y.index_add_(0, bsr.block_rows()[:nb].long(), tiles)
    return Y.reshape(bsr.nbrows * bh, N)[: bsr.shape[0]]

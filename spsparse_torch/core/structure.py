"""Row/column structure over sorted COO arrays: dim_beginnings + CSR/ELL views.

PyTorch counterpart of :mod:`spsparse_tpu.core.structure` (the reference's
row-offset machinery, ``algorithm.hpp:59-233``):

* :func:`dim_beginnings` — on a sorted array, the offset of each new value
  of the leading sorted dimension plus an end sentinel: compressed row
  pointers over *present rows only*; unsorted input raises.
* :class:`SparseCSR` — the full fixed-row-count CSR view.
* :class:`SparseELL` — every row padded to the longest row.

The JAX package builds CSR pointers through sort-based joins
(``core/joinfill.py``) to avoid the TPU's slow gathers. Here they are
plain ``torch.searchsorted`` calls (:func:`row_ptr_from_sorted_rows`,
:func:`row_ids_from_row_ptr`).
"""

from __future__ import annotations

import dataclasses

import torch

from .coo import SparseCOO, default_index_dtype
from .errors import SpSparseError, spsparse_error

__all__ = ["dim_beginnings", "DimBeginnings", "SparseCSR", "to_csr",
           "to_csc", "to_ell", "SparseELL", "row_ptr_from_sorted_rows",
           "row_ids_from_row_ptr"]

Tensor = torch.Tensor


def row_ptr_from_sorted_rows(rows: Tensor, nrows: int) -> Tensor:
    """CSR ``row_ptr (nrows+1,)`` int32 from a sorted per-entry row vector
    (padding rows hold the ``nrows`` sentinel): ``row_ptr[r]`` is the first
    entry with ``rows[p] >= r``."""
    q = torch.arange(nrows + 1, dtype=rows.dtype, device=rows.device)
    return torch.searchsorted(rows.contiguous(), q,
                              side="left").to(torch.int32)


def row_ids_from_row_ptr(row_ptr: Tensor, cap: int) -> Tensor:
    """Per-entry row ids from CSR ``row_ptr``: entry ``p`` belongs to the
    last row ``r`` with ``row_ptr[r] <= p``; entries past ``row_ptr[-1]``
    get ``nrows``."""
    p = torch.arange(cap, dtype=row_ptr.dtype, device=row_ptr.device)
    return (torch.searchsorted(row_ptr.contiguous(), p, side="right")
            .to(torch.int32) - 1)


@dataclasses.dataclass(frozen=True)
class DimBeginnings:
    """Present-rows row-pointer structure of a sorted :class:`SparseCOO`.

    ``begins[r]`` is the entry offset where present row ``r`` starts, for
    ``r < n_rows``; ``begins[n_rows]`` is the end sentinel (``nnz``).
    ``row_index[r]`` is the index value of present row ``r`` along the
    leading sorted dimension. Buffers are padded to ``cap + 1`` / ``cap``.
    """

    begins: Tensor      # (cap+1,)
    row_index: Tensor   # (cap,)
    n_rows: int
    dim: int

    def to_list(self) -> list[int]:
        """``[begin_0, ..., begin_{n-1}, end]`` — the reference's vector."""
        return self.begins[: self.n_rows + 1].tolist()

    def rows_to_list(self) -> list[int]:
        return self.row_index[: self.n_rows].tolist()


def dim_beginnings(a: SparseCOO) -> DimBeginnings:
    """Present-rows row pointers of a sorted array; raises through the
    error handler when ``a`` is not sorted."""
    if a.sort_order is None:
        spsparse_error(
            -1, "dim_beginnings() requires the SparseCOO to be sorted first.")
    dim = a.sort_order[0]
    cap = a.cap
    lead = a.indices[: a.nnz, dim]
    is_new = torch.ones(a.nnz, dtype=torch.bool, device=a.device)
    if a.nnz > 1:
        is_new[1:] = lead[1:] != lead[:-1]
    starts = torch.nonzero(is_new).squeeze(1)
    n_rows = starts.numel()
    begins = torch.zeros(cap + 1, dtype=torch.int32, device=a.device)
    begins[:n_rows] = starts.to(torch.int32)
    begins[n_rows] = a.nnz
    row_index = torch.zeros(cap, dtype=lead.dtype, device=a.device)
    row_index[:n_rows] = lead[starts]
    return DimBeginnings(begins=begins, row_index=row_index, n_rows=n_rows,
                         dim=dim)


@dataclasses.dataclass(frozen=True)
class SparseCSR:
    """Fixed-row-count CSR view: ``row_ptr (nrows+1,)``, ``cols (cap,)``,
    ``vals (cap,)``. Padding entries have ``cols == ncols`` (sentinel) and
    zero values."""

    row_ptr: Tensor
    cols: Tensor
    vals: Tensor
    nnz: int
    shape: tuple

    @property
    def cap(self) -> int:
        return self.cols.shape[0]

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def row_ids(self) -> Tensor:
        """Expand ``row_ptr`` to a per-entry row-id vector ``(cap,)``."""
        return row_ids_from_row_ptr(self.row_ptr, self.cap)

    def valid_mask(self) -> Tensor:
        return torch.arange(self.cap, device=self.device) < self.nnz

    def to_coo(self, sort_order=(0, 1)) -> SparseCOO:
        idt = default_index_dtype(self.shape)
        rows = torch.where(self.valid_mask(), self.row_ids().to(idt),
                           self.nrows)
        idx = torch.stack([rows, self.cols.to(idt)], dim=1)
        return SparseCOO(indices=idx, vals=self.vals, nnz=self.nnz,
                         shape=self.shape, sort_order=tuple(sort_order))

    def to_dense(self) -> Tensor:
        return self.to_coo().to_dense()


def to_csr(a: SparseCOO, *, transpose: bool = False) -> SparseCSR:
    """COO matrix → CSR view (consolidating row-major first if needed).
    With ``transpose=True`` this is the CSR of ``a.T`` (the CSC of ``a``),
    free when ``a`` is already column-major sorted."""
    if a.rank != 2:
        raise SpSparseError("to_csr requires a rank-2 array")
    aw = a.transposed((1, 0)) if transpose else a
    if aw.sort_order != (0, 1):
        aw = aw.consolidate((0, 1))
    valid = aw.valid_mask()
    rows = torch.where(valid, aw.indices[:, 0], aw.shape[0])
    row_ptr = row_ptr_from_sorted_rows(rows, aw.shape[0])
    cols = torch.where(valid, aw.indices[:, 1], aw.shape[1])
    return SparseCSR(row_ptr=row_ptr, cols=cols, vals=aw.repad().vals,
                     nnz=aw.nnz, shape=aw.shape)


def to_csc(a: SparseCOO) -> SparseCSR:
    """CSC view of ``a`` as the CSR of ``a.T``; ``spmv(to_csc(a), u)``
    computes ``a.T @ u``."""
    return to_csr(a, transpose=True)


@dataclasses.dataclass(frozen=True)
class SparseELL:
    """ELLPACK view: every row padded to ``max_row_nnz`` entries.

    ``cols (nrows, max_row_nnz)`` with sentinel ``ncols`` padding and
    ``vals (nrows, max_row_nnz)`` with zero padding.
    """

    cols: Tensor
    vals: Tensor
    shape: tuple

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def max_row_nnz(self) -> int:
        return self.cols.shape[1]

    def _live(self):
        rows = torch.arange(self.nrows, device=self.vals.device)[:, None]
        rows = rows.expand(self.cols.shape)
        live = self.cols < self.ncols
        return rows[live], self.cols[live], self.vals[live]

    def to_dense(self) -> Tensor:
        dense = torch.zeros(self.shape, dtype=self.vals.dtype,
                            device=self.vals.device)
        rows, cols, vals = self._live()
        return dense.index_put_((rows, cols.long()), vals, accumulate=True)

    def to_coo(self) -> SparseCOO:
        """ELL → COO, dropping only the sentinel-padded slots."""
        rows, cols, vals = self._live()
        idx = torch.stack([rows, cols.long()], dim=1)
        return SparseCOO.from_arrays(idx, vals, self.shape, check=False)


def to_ell(a: SparseCOO | SparseCSR,
           max_row_nnz: int | None = None) -> SparseELL:
    """COO/CSR → ELL. ``max_row_nnz`` defaults to the longest row; longer
    rows are cut."""
    csr = a if isinstance(a, SparseCSR) else to_csr(a)
    lengths = (csr.row_ptr[1:] - csr.row_ptr[:-1]).long()
    if max_row_nnz is None:
        max_row_nnz = int(lengths.max()) if csr.nrows else 0
        max_row_nnz = max(max_row_nnz, 1)
    k = torch.arange(max_row_nnz, device=csr.device)[None, :]
    src = csr.row_ptr[:-1, None].long() + k            # (nrows, K)
    in_row = k < lengths[:, None]
    src = torch.where(in_row, src, 0).clamp_max(max(csr.cap - 1, 0))
    cols = torch.where(in_row, csr.cols[src], csr.ncols).to(csr.cols.dtype)
    vals = torch.where(in_row, csr.vals[src],
                       torch.zeros((), dtype=csr.vals.dtype,
                                   device=csr.device))
    return SparseELL(cols=cols, vals=vals, shape=csr.shape)

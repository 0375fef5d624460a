"""Segmented row sums (the CSR row reduction): kernel K10.

Counterpart of :mod:`spsparse_tpu.ops.pallas_segsum` (the Pallas kernel
``_segsum_kernel``; the module-name rule drops ``pallas_``). Given
per-entry products in row-pointer order it returns the per-row totals

    y[r] = sum_{e in [row_ptr[r], row_ptr[r+1])} prod[e]      (float32)

On CUDA tensors :func:`segmented_row_sums` launches ``sps_segsum``
(``spsparse_torch/csrc/segsum.cu``: a group of lanes per row, a shuffle
reduction); on CPU tensors it runs the plain version
:func:`segmented_row_sums_reference` (an ``index_add_`` over the entries'
row ids). The TPU kernel reduced ``rows_per_block`` rows at a time over a
DMA window of ``entries_per_block`` entries; both only sized that window.
The port keeps them in the signatures, so callers port unchanged, and the
kernel is right whatever they are. :func:`pad_products` and
:func:`max_entries_per_rowblock` are kept for the same reason; the kernel
reads only ``prod[row_ptr[0]:row_ptr[nrows]]`` and needs no padding.

:func:`spmv_csr_segsum` (the JAX ``spmv_csr_pallas``) forms
``vals * x[cols]`` with padding entries masked to 0, as the JAX package
does in XLA, and reduces the products with K10.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import backend
from ..core.coo import operand_tensor
from ..core.structure import SparseCSR
from .spmm import _gather_rows

__all__ = ["segmented_row_sums", "segmented_row_sums_reference",
           "csr_products", "spmv_csr_segsum", "pad_products",
           "max_entries_per_rowblock"]

Tensor = torch.Tensor


def pad_products(prod: Tensor, entries_per_block: int) -> Tensor:
    """Zero-pad ``prod`` as the JAX package pads it for its DMA windows
    (the window length, 1024-aligned, plus 1024). The port's kernel needs
    no padding; this keeps the JAX call sequence valid."""
    w = -(-(entries_per_block + 1024) // 1024) * 1024
    return torch.nn.functional.pad(prod, (0, w + 1024))


def max_entries_per_rowblock(row_ptr, rows_per_block: int) -> int:
    """Host-side: max entry count under any aligned block of R rows."""
    if isinstance(row_ptr, Tensor):
        row_ptr = row_ptr.cpu().numpy()
    rp = np.asarray(row_ptr)
    nrows = rp.shape[0] - 1
    R = rows_per_block
    nblocks = -(-nrows // R)
    pad = nblocks * R + 1 - rp.shape[0]
    if pad > 0:
        rp = np.concatenate([rp, np.full(pad, rp[-1], rp.dtype)])
    starts = rp[0:nblocks * R:R]
    ends = rp[R:nblocks * R + 1:R]
    return int((ends - starts).max(initial=0))


def _row_ptr(row_ptr: Tensor, nrows: int) -> Tensor:
    """``row_ptr[:nrows+1]`` as contiguous int32; a shorter pointer array
    is extended with its last value (rows past it are empty), as the JAX
    wrapper extends it."""
    row_ptr = row_ptr.to(torch.int32)
    if row_ptr.shape[0] < nrows + 1:
        row_ptr = torch.cat([row_ptr, row_ptr[-1:].expand(
            nrows + 1 - row_ptr.shape[0])])
    return row_ptr[: nrows + 1].contiguous()


def segmented_row_sums_reference(prod: Tensor, row_ptr: Tensor,
                                 nrows: int) -> Tensor:
    """Plain PyTorch K10: each entry's row id by ``searchsorted`` and one
    ``index_add_`` in float32."""
    rp = _row_ptr(row_ptr, nrows).long()
    prod = prod.to(torch.float32)
    e = torch.arange(prod.shape[0], device=prod.device)
    r = torch.searchsorted(rp, e, right=True) - 1
    ok = (r >= 0) & (e < rp[nrows])
    y = torch.zeros(nrows, dtype=torch.float32, device=prod.device)
    return y.index_add_(0, r[ok], prod[ok])


def _lanes_per_row(n_entries: int, nrows: int) -> int:
    """Lanes a row gets in K10: the power of two at or above a quarter of
    the mean row length (about four entries a lane), at most a warp."""
    quarter = -(-n_entries // (4 * max(nrows, 1)))
    return min(1 << max(quarter - 1, 0).bit_length(), 32)


def segmented_row_sums(prod: Tensor, row_ptr: Tensor, *, nrows: int,
                       rows_per_block: int, entries_per_block: int) -> Tensor:
    """Per-row sums (float32, ``(nrows,)``) of ``prod`` in row-pointer
    order; ``row_ptr`` holds at least ``nrows + 1`` offsets into ``prod``
    (fewer: the rows past it are empty). ``rows_per_block`` and
    ``entries_per_block`` are accepted for the JAX signature and do not
    change the result.

    CUDA tensors launch kernel K10 (``segmented_row_sums.launches`` counts
    the launches); CPU tensors take :func:`segmented_row_sums_reference`."""
    del rows_per_block, entries_per_block
    if prod.ndim != 1 or row_ptr.ndim != 1:
        raise ValueError("segmented_row_sums: prod and row_ptr must be 1-D")
    if prod.device != row_ptr.device:
        raise ValueError(f"prod is on {prod.device} but row_ptr is on "
                         f"{row_ptr.device}")
    if prod.device.type == "cpu":
        return segmented_row_sums_reference(prod, row_ptr, nrows)
    prod = prod.to(torch.float32).contiguous()
    rp = _row_ptr(row_ptr, nrows)
    y = torch.empty(nrows, dtype=torch.float32, device=prod.device)
    lib = backend.load_kernels()
    err = lib.sps_segsum(prod.data_ptr(), rp.data_ptr(), nrows,
                         _lanes_per_row(prod.shape[0], nrows), y.data_ptr(),
                         backend.current_stream(prod.device))
    backend.check(err, "sps_segsum")
    segmented_row_sums.launches += 1
    return y


segmented_row_sums.launches = 0


def csr_products(csr: SparseCSR, x: Tensor) -> Tensor:
    """``vals * x[cols]`` in float32 over the CSR buffer, padding entries
    (and sentinel columns) 0: the products K10 reduces."""
    x = operand_tensor(x, csr.device)
    prod = csr.vals * _gather_rows(x, csr.cols)
    prod = torch.where(csr.valid_mask(), prod, torch.zeros((), dtype=prod.dtype,
                                                           device=csr.device))
    return prod.to(torch.float32)


def spmv_csr_segsum(csr: SparseCSR, x: Tensor, *, rows_per_block: int = 256,
                    entries_per_block: int | None = None) -> Tensor:
    """CSR SpMV (float32): the products ``vals * x[cols]`` by a gather,
    the row reduction by K10 (the JAX ``spmv_csr_pallas``)."""
    return segmented_row_sums(
        csr_products(csr, x), csr.row_ptr, nrows=csr.nrows,
        rows_per_block=rows_per_block,
        entries_per_block=entries_per_block or 0)

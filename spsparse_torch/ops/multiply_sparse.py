"""The diag-scaled sparse multiply chain: SpGEMM (MM) and SpMV (MV).

PyTorch counterpart of :mod:`spsparse_tpu.ops.multiply` (the reference's
``multiply_sparse.hpp:117-365``). The module takes the reference's file
name so that ``spsparse_torch.ops.multiply`` is the function alone: in the
JAX package the function of that name shadows its own module.

MM:  ``ret = C · diag(scalei) · A^(T?) · diag(scalej) · B^(T?) · diag(scalek)``
MV:  ``ret = C · diag(scalei) · A^(T?) · diag(scalej) · V``

Semantic contract, as in the JAX package:

* transposition is free — an index-column swap plus re-consolidation;
* operands are consolidated with the caller's ``duplicate_policy`` /
  ``zero_nan`` before multiplying;
* ``scalei``/``scalek`` are *sparse* vectors: a row (column) missing from
  the scale vector, or whose scale value is exactly zero, is skipped;
* ``scalej`` masks the inner index: an inner index absent from ``scalej``
  contributes nothing;
* dot products that sum to exactly zero are not emitted; NaN sums *are*;
* mismatched inner dimensions raise through the pluggable error handler.

MM is a row-wise Gustavson SpGEMM in expand–sort–compress (ESC) form: the
products of every A entry with its B row are enumerated by gathers (stream
order (i, k, j)), stably sorted by (i, j) — which keeps ascending-k order
inside each output cell — and merged by a segmented sum. The JAX package's
``"join"`` expansion replaces those gathers with sorts because gathers are
slow on a TPU; the port has only the gather expansion.

``merge_method``: ``"scatter"`` sums each cell left to right (bitwise the
reference's sequential accumulation on the CPU); ``"compact"`` sums each
run with a segmented reduction (see :mod:`spsparse_torch.core.consolidate`).
"""

from __future__ import annotations

import dataclasses
import numbers

import torch

from ..core.consolidate import (
    consolidate as _consolidate,
    filter_compact,
    fused_sort_merge,
    merge_sorted_entries,
)
from ..core.coo import SparseCOO, default_index_dtype, round_up_pow2
from ..core.errors import DuplicatePolicy, spsparse_error
from ..core.structure import SparseCSR, to_csr
from ..utils.trace import traced

__all__ = ["multiply", "multiply_mv", "multiply_chain", "expansion_size",
           "expand_products_raw", "sort_and_merge_products"]

Tensor = torch.Tensor


def _result_dtype(tensors, C) -> torch.dtype:
    """Promoted dtype of the operand values and the scalar ``C`` (a Python
    number is weakly typed, as in JAX)."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    if isinstance(C, Tensor):
        return torch.promote_types(dt, C.dtype)
    if isinstance(C, numbers.Number):
        return torch.result_type(torch.empty(0, dtype=dt), C)
    return dt


def _dense_scale(scale: SparseCOO | None, n: int):
    """Sparse scale vector → dense ``(present, value)`` of length ``n+1``
    (the trailing slot swallows sentinel-index gathers)."""
    if scale is None:
        return None, None
    idx = scale.indices[: scale.nnz, 0].long()
    pres = torch.zeros(n + 1, dtype=torch.bool, device=scale.device)
    pres[idx] = True
    vals = torch.zeros(n + 1, dtype=scale.dtype, device=scale.device)
    vals[idx] = scale.vals[: scale.nnz]
    return pres, vals


def expansion_size(a_inner_cols: Tensor, a_live: Tensor, b_csr: SparseCSR,
                   sj_pres: Tensor | None = None) -> int:
    """Exact ESC expansion size: over live A entries, the length of the B
    row at the entry's inner index (zero where ``scalej`` lacks it)."""
    return int(_product_counts(a_inner_cols, a_live, b_csr.row_ptr,
                               sj_pres).sum())


def _product_counts(k_a, a_live, row_ptr, sj_pres):
    nrows_b = row_ptr.numel() - 1
    row_len = (row_ptr[1:] - row_ptr[:-1]).long()
    if nrows_b == 0:
        return torch.zeros_like(k_a, dtype=torch.long)
    k = k_a.long().clamp(0, nrows_b - 1)
    cnt = torch.where(a_live & (k_a < nrows_b), row_len[k], 0)
    if sj_pres is not None:
        cnt = torch.where(sj_pres[k_a.long().clamp_max(sj_pres.numel() - 1)],
                          cnt, 0)
    return cnt


def expand_products_raw(i_a, k_a, v_a, a_live, row_ptr, b_cols, b_vals,
                        sj_pres=None, sj_val=None,
                        expand_cap: int | None = None):
    """Enumerate every (A entry) x (B-row entry) product.

    ``row_ptr`` is B's CSR row pointer over ``b_cols``/``b_vals``. Returns
    ``(i, j, v)`` of the first ``expand_cap`` products (all by default) in
    stream order (i, k, j) for an A sorted row-major.
    """
    v_a = torch.where(a_live, v_a, torch.zeros((), dtype=v_a.dtype,
                                               device=v_a.device))
    cnt = _product_counts(k_a, a_live, row_ptr, sj_pres)
    if sj_pres is not None:
        k = k_a.long().clamp_max(sj_val.numel() - 1)
        kp = sj_pres[k]
        v_a = v_a * torch.where(kp, sj_val[k], 0).to(v_a.dtype)
    total = int(cnt.sum())
    n_t = total if expand_cap is None else min(total, int(expand_cap))
    src = torch.arange(cnt.numel(), device=cnt.device)
    e = torch.repeat_interleave(src, cnt)[:n_t]
    first = (torch.cumsum(cnt, 0) - cnt)[e]
    b_pos = (row_ptr[:-1].long()[k_a.long()[e]]
             + torch.arange(n_t, device=cnt.device) - first)
    return i_a[e], b_cols[b_pos], v_a[e] * b_vals[b_pos]


def sort_and_merge_products(i_t, j_t, v_t, out_shape,
                            merge_cap: int | None = None,
                            merge_method: str = "compact",
                            with_run_count: bool = False):
    """Compress an ESC product stream: stable (i, j) sort, which keeps the
    ascending-k accumulation order inside each cell, then segmented sum.
    Returns the unscaled, unfiltered merged COO (row-major sorted), plus
    the true run count with ``with_run_count``."""
    merge_cap = i_t.shape[0] if merge_cap is None else merge_cap
    live = torch.ones(i_t.shape[0], dtype=torch.bool, device=i_t.device)
    return fused_sort_merge(
        (i_t, j_t), v_t, live, extents=out_shape, shape=out_shape,
        duplicate_policy=DuplicatePolicy.ADD, cap=merge_cap,
        sort_order=(0, 1), index_dtype=default_index_dtype(out_shape),
        with_run_count=with_run_count, method=merge_method)


def _scaled_keep(merged: SparseCOO, C, out_dtype, scales):
    """Emission mask and scaled values (reference ``:195,211,238-243``):
    drop zero sums, ``C == 0``, and rows/cols missing from or zero in a
    scale vector. ``scales`` pairs each index column with its dense
    ``(present, value)`` scale."""
    keep = merged.valid_mask() & (merged.vals != 0) & bool(C != 0)
    val = merged.vals * torch.as_tensor(C, dtype=out_dtype,
                                        device=merged.device)
    for d, (pres, sval) in scales:
        m = merged.indices[:, d].long().clamp_max(merged.shape[d])
        keep &= pres[m] & (sval[m] != 0)
        val = val * sval[m].to(out_dtype)
    return keep, dataclasses.replace(merged, vals=val)


@traced("spsparse.multiply_mm")
def multiply(
    C,
    A: SparseCOO,
    B: SparseCOO,
    *,
    scalei: SparseCOO | None = None,
    scalej: SparseCOO | None = None,
    scalek: SparseCOO | None = None,
    transpose_a: bool = False,
    transpose_b: bool = False,
    duplicate_policy: DuplicatePolicy = DuplicatePolicy.ADD,
    zero_nan: bool = False,
    cap: int | None = None,
    expand_cap: int | None = None,
    merge_method: str = "compact",
) -> SparseCOO:
    """MM chain: ``C · diag(scalei) · A^(T?) · diag(scalej) · B^(T?) ·
    diag(scalek)``. Returns a row-major-sorted :class:`SparseCOO` of shape
    ``(A'.rows, B'.cols)``; ``cap`` defaults to the next power of two of
    the emitted count."""
    if A.rank != 2 or B.rank != 2:
        spsparse_error(-1, "multiply (MM) requires rank-2 operands")
    Aw = A.transposed((1, 0)) if transpose_a else A
    Bw = B.transposed((1, 0)) if transpose_b else B
    out_shape = (Aw.shape[0], Bw.shape[1])
    if Aw.shape[1] != Bw.shape[0]:
        spsparse_error(
            -1, "Inner dimensions for A (%d) and B (%d) must match!",
            Aw.shape[1], Bw.shape[0])

    acon = Aw if Aw.sort_order == (0, 1) else _consolidate(
        Aw, (0, 1), duplicate_policy, zero_nan, method=merge_method)
    bcon = Bw if Bw.sort_order == (0, 1) else _consolidate(
        Bw, (0, 1), duplicate_policy, zero_nan, method=merge_method)
    b_csr = to_csr(bcon)

    sj_pres, sj_val = _dense_scale(scalej, Aw.shape[1])
    si = _dense_scale(scalei, out_shape[0])
    sk = _dense_scale(scalek, out_shape[1])
    out_dtype = _result_dtype(
        [A.vals, B.vals] + [s.vals for s in (scalei, scalej, scalek)
                            if s is not None], C)

    a_live = acon.valid_mask()
    if expand_cap is None:
        expand_cap = round_up_pow2(expansion_size(
            acon.indices[:, 1], a_live, b_csr, sj_pres))
    i_t, j_t, v_t = expand_products_raw(
        acon.indices[:, 0], acon.indices[:, 1], acon.vals, a_live,
        b_csr.row_ptr, b_csr.cols, b_csr.vals, sj_pres, sj_val, expand_cap)
    merged = sort_and_merge_products(i_t, j_t, v_t.to(out_dtype), out_shape,
                                     merge_cap=expand_cap,
                                     merge_method=merge_method)
    scales = [(d, s) for d, s, given in ((0, si, scalei), (1, sk, scalek))
              if given is not None]
    keep, result = _scaled_keep(merged, C, out_dtype, scales)
    if cap is None:
        cap = round_up_pow2(int(keep.sum()))
    return filter_compact(result, keep, cap=cap)


@traced("spsparse.multiply_mv")
def multiply_mv(
    C,
    A: SparseCOO,
    V: SparseCOO,
    *,
    scalei: SparseCOO | None = None,
    scalej: SparseCOO | None = None,
    transpose_a: bool = False,
    duplicate_policy: DuplicatePolicy = DuplicatePolicy.ADD,
    zero_nan: bool = False,
    cap: int | None = None,
    merge_method: str = "compact",
) -> SparseCOO:
    """MV chain: ``C · diag(scalei) · A^(T?) · diag(scalej) · V`` for a
    sparse rank-1 ``V`` (consolidated first). Returns a sorted rank-1
    :class:`SparseCOO` over the present rows."""
    if A.rank != 2 or V.rank != 1:
        spsparse_error(-1, "multiply (MV) requires rank-2 A and rank-1 V")
    Aw = A.transposed((1, 0)) if transpose_a else A
    out_len, K = Aw.shape
    if K != V.shape[0]:
        spsparse_error(
            -1, "Inner dimensions for A (%d) and V (%d) must match!",
            K, V.shape[0])

    acon = Aw if Aw.sort_order == (0, 1) else _consolidate(
        Aw, (0, 1), duplicate_policy, zero_nan, method=merge_method)
    vcon = V if V.sort_order == (0,) else _consolidate(
        V, (0,), duplicate_policy, zero_nan, method=merge_method)

    v_pres, v_val = _dense_scale(vcon, K)
    sj_pres, sj_val = _dense_scale(scalej, K)
    si = _dense_scale(scalei, out_len)
    out_dtype = _result_dtype(
        [A.vals, V.vals] + [s.vals for s in (scalei, scalej)
                            if s is not None], C)

    # Per-A-entry contribution a_ik * sj[k] * v[k], structurally zero where
    # either is absent (the reference's 2/3-way join).
    live = acon.valid_mask()
    k_a = torch.where(live, acon.indices[:, 1], K).long().clamp_max(K)
    pres = v_pres[k_a] & live
    contrib = acon.vals.to(out_dtype) * v_val[k_a].to(out_dtype)
    if scalej is not None:
        pres &= sj_pres[k_a]
        contrib = contrib * sj_val[k_a].to(out_dtype)
    contrib = torch.where(pres, contrib, torch.zeros((), dtype=out_dtype,
                                                     device=contrib.device))

    # Every live A row yields a segment, possibly summing to zero (dropped
    # below, like the reference).
    idt = default_index_dtype((out_len,))
    rows = torch.where(live, acon.indices[:, 0], out_len).to(idt)
    merged = merge_sorted_entries(
        (rows,), contrib, live, shape=(out_len,),
        duplicate_policy=DuplicatePolicy.ADD, cap=acon.cap,
        sort_order=(0,), index_dtype=idt, method=merge_method)
    scales = [(0, si)] if scalei is not None else []
    keep, result = _scaled_keep(merged, C, out_dtype, scales)
    if cap is None:
        cap = round_up_pow2(int(keep.sum()))
    return filter_compact(result, keep, cap=cap)


def multiply_chain(ret_unused=None, C=1.0, scalei=None, A=None, tA=".",
                   scalej=None, B=None, tB=".", scalek=None,
                   duplicate_policy=DuplicatePolicy.ADD, zero_nan=False):
    """Positional-parity shim mirroring the reference signature
    (``multiply_sparse.hpp:139-150``); prefer :func:`multiply`."""
    return multiply(C, A, B, scalei=scalei, scalej=scalej, scalek=scalek,
                    transpose_a=(tA == "T"), transpose_b=(tB == "T"),
                    duplicate_policy=duplicate_policy, zero_nan=zero_nan)

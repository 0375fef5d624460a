"""Elementwise sparse algebra: concatenation, linear combination, scaling,
elementwise binary operations and stacking.

Counterpart of :mod:`spsparse_tpu.core.algebra`. As there, everything is
composed from an order-preserving compaction
(:func:`.consolidate.compact_select`) and :func:`.consolidate.consolidate`;
nothing scatters. Concatenation keeps operand order, so a later
consolidate's LEAVE_ALONE/REPLACE policies see the reference's
insertion-order semantics (two successive ``copy()`` calls into one
accumulator). Everything runs on the operands' device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .consolidate import (_lexsort, _pack_cols, _plan_packing, _unpack_cols,
                          compact_select, consolidate)
from .coo import SparseCOO, default_index_dtype, round_up_pow2
from .errors import DuplicatePolicy, SpSparseError

__all__ = ["coo_concat", "coo_add", "coo_scale",
           "coo_hstack", "coo_vstack", "coo_block_diag",
           "coo_binop", "coo_multiply", "coo_maximum", "coo_minimum",
           "coo_power"]

Tensor = torch.Tensor


def _out_cap(arrays, cap: int | None, what: str) -> int:
    """The sum of operand caps rounded up to a power of two, or an explicit
    ``cap``, which must hold every live entry."""
    if cap is None:
        return round_up_pow2(sum(x.cap for x in arrays))
    cap = int(cap)
    total = sum(x.nnz for x in arrays)
    if cap < total:
        raise SpSparseError(f"{what} cap={cap} < total live entries {total}")
    return cap


def _promoted(dtypes) -> torch.dtype:
    out = dtypes[0]
    for d in dtypes[1:]:
        out = torch.promote_types(out, d)
    return out


def coo_concat(*arrays: SparseCOO, cap: int | None = None) -> SparseCOO:
    """Concatenate the live entries of sparse arrays of one shape into one
    unsorted COO: duplicates are kept and entry order is operand order.
    ``cap`` defaults to the sum of operand caps rounded up to a power of
    two; an explicit ``cap`` below the total live count raises."""
    if not arrays:
        raise SpSparseError("coo_concat requires at least one operand")
    shape = arrays[0].shape
    for x in arrays[1:]:
        if x.shape != shape:
            raise SpSparseError(
                f"coo_concat shape mismatch: {x.shape} vs {shape}")
    cap = _out_cap(arrays, cap, "coo_concat")
    idt = _promoted([x.index_dtype for x in arrays])
    vdt = _promoted([x.dtype for x in arrays])
    dev = arrays[0].device
    cols = [torch.cat([x.indices[:, d].to(dev, idt) for x in arrays])
            for d in range(len(shape))]
    vals = torch.cat([x.vals.to(dev, vdt) for x in arrays])
    valid = torch.cat([x.valid_mask().to(dev) for x in arrays])
    carried, n = compact_select(valid, tuple(cols) + (vals,), cap_out=cap)
    out = SparseCOO(indices=torch.stack(carried[:-1], 1), vals=carried[-1],
                    nnz=n, shape=shape, sort_order=None)
    return out.repad()


def coo_add(a: SparseCOO, b: SparseCOO, *, alpha=1.0, beta=1.0,
            duplicate_policy: DuplicatePolicy = DuplicatePolicy.ADD,
            zero_nan: bool = False, cap: int | None = None) -> SparseCOO:
    """``alpha*A + beta*B`` (under ``ADD``), sorted row-major.

    With ``LEAVE_ALONE`` the result is B's entries only where A has none
    (A wins); with ``REPLACE``, B overlays A. Consolidate semantics apply:
    structural zeros of the inputs are dropped, merged sums that cancel to
    exactly zero are kept (reference ``algorithm.hpp:287``)."""
    both = coo_concat(coo_scale(a, alpha), coo_scale(b, beta), cap=cap)
    return consolidate(both, None, duplicate_policy, zero_nan)


def coo_binop(a: SparseCOO, b: SparseCOO,
              f: Callable[[Tensor, Tensor], Tensor], *,
              require_both: bool = False, drop_zeros: bool = True,
              cap: int | None = None) -> SparseCOO:
    """Elementwise ``f(A, B)`` over the union of the two structures, missing
    entries counting as 0 — the combiner under :func:`coo_multiply`,
    :func:`coo_maximum` and :func:`coo_minimum`.

    Each operand is consolidated (duplicates summed); the two entry
    streams are concatenated with an operand tag and stable-sorted by
    (packed index words, tag), so each key's run holds at most one entry of
    each operand, ``a``'s first. ``f`` is evaluated once per distinct key.
    ``require_both`` keeps only keys that both operands store (scipy's
    ``A.multiply(B)`` never evaluates ``NaN * 0`` against an implicit zero);
    ``drop_zeros`` does not store exact-zero results (NaNs are stored).
    ``cap`` defaults to the operand-cap sum, or the smaller operand's cap
    with ``require_both``, rounded up to a power of two. The result is
    row-major sorted with unique keys."""
    if a.shape != b.shape:
        raise SpSparseError(
            f"coo_binop shape mismatch: {a.shape} vs {b.shape}")
    ca = consolidate(a, None, DuplicatePolicy.ADD, False)
    cb = consolidate(b, None, DuplicatePolicy.ADD, False)
    rank, shape, dev = ca.rank, ca.shape, ca.device
    idt = torch.promote_types(ca.index_dtype, cb.index_dtype)
    vdt = torch.promote_types(ca.dtype, cb.dtype)
    if cap is None:
        cap = round_up_pow2(min(ca.cap, cb.cap) if require_both
                            else ca.cap + cb.cap)
    cap = int(cap)
    exts = [int(s) + 1 for s in shape]
    plan = _plan_packing(exts)
    words = _pack_cols(
        [torch.cat([ca.indices[: ca.nnz, d].long(),
                    cb.indices[: cb.nnz, d].to(dev).long()])
         for d in range(rank)], exts, plan)
    tag = torch.cat([torch.zeros(ca.nnz, dtype=torch.int64, device=dev),
                     torch.ones(cb.nnz, dtype=torch.int64, device=dev)])
    vals = torch.cat([ca.vals[: ca.nnz].to(vdt),
                      cb.vals[: cb.nnz].to(dev, vdt)])
    perm = _lexsort(list(words) + [tag])
    sw, stag, svals = [w[perm] for w in words], tag[perm], vals[perm]
    m = svals.numel()
    same_prev = torch.zeros(m, dtype=torch.bool, device=dev)
    if m > 1:
        same = torch.ones(m - 1, dtype=torch.bool, device=dev)
        for w in sw:
            same &= w[1:] == w[:-1]
        same_prev[1:] = same
    next_same = torch.cat([same_prev[1:], same_prev.new_zeros(1)])
    zero = torch.zeros((), dtype=vdt, device=dev)
    av = torch.where(stag == 0, svals, zero)
    bv_here = torch.where(stag == 1, svals, zero)
    bv_next = torch.cat([bv_here[1:], bv_here.new_zeros(1)])
    bv = bv_here + torch.where(next_same, bv_next, zero)
    out = f(av, bv).to(vdt)
    keep = ~same_prev
    if require_both:
        keep &= next_same
    if drop_zeros:
        keep &= out != 0
    comp, n = compact_select(keep, tuple(sw) + (out,), cap_out=cap)
    cols = _unpack_cols(comp[:-1], exts, plan, idt)
    res = SparseCOO(indices=torch.stack(cols, 1), vals=comp[-1],
                    nnz=min(n, cap), shape=shape,
                    sort_order=tuple(range(rank)))
    return res.repad()


def coo_multiply(a: SparseCOO, b: SparseCOO, *,
                 cap: int | None = None) -> SparseCOO:
    """Hadamard product ``A ∘ B`` (scipy's ``A.multiply(B)``): structural
    intersection, duplicates summed first, exact-zero products dropped."""
    return coo_binop(a, b, torch.mul, require_both=True, cap=cap)


def coo_maximum(a: SparseCOO, b: SparseCOO, *,
                cap: int | None = None) -> SparseCOO:
    """Elementwise ``max(A, B)`` (scipy's ``A.maximum(B)``): missing
    entries count as 0."""
    return coo_binop(a, b, torch.maximum, cap=cap)


def coo_minimum(a: SparseCOO, b: SparseCOO, *,
                cap: int | None = None) -> SparseCOO:
    """Elementwise ``min(A, B)`` (scipy's ``A.minimum(B)``): missing
    entries count as 0."""
    return coo_binop(a, b, torch.minimum, cap=cap)


def coo_power(a: SparseCOO, p) -> SparseCOO:
    """Elementwise power of the stored entries (scipy's ``A.power(p)``).
    ``p == 0`` raises: it would make every implicit zero a 1."""
    if p == 0:
        raise SpSparseError("coo_power: zero power would densify "
                            "(scipy parity: not supported)")
    # 0 ** p is inf or nan for p < 0: padding is re-zeroed explicitly.
    vals = torch.where(a.valid_mask(), a.vals ** p,
                       torch.zeros((), dtype=a.dtype, device=a.device))
    return dataclasses.replace(a, vals=vals)


def coo_scale(a: SparseCOO, c) -> SparseCOO:
    """``c * A``: the values scaled, the structure and sortedness kept."""
    c = (c.to(a.device, a.dtype) if isinstance(c, Tensor)
         else torch.tensor(c, dtype=a.dtype, device=a.device))
    return dataclasses.replace(a, vals=a.vals * c)


def _coo_stack2d(arrays, row_offs, col_offs, out_shape,
                 cap: int | None) -> SparseCOO:
    """Shift each operand's live indices by its (row, col) offset,
    concatenate and compact: unsorted, operand entry order kept."""
    cap = _out_cap(arrays, cap, "stacking")
    idt = _promoted([default_index_dtype(out_shape)]
                    + [x.index_dtype for x in arrays])
    vdt = _promoted([x.dtype for x in arrays])
    dev = arrays[0].device
    rows, cols, vals, valid = [], [], [], []
    for x, ro, co in zip(arrays, row_offs, col_offs):
        idx = x.indices.to(dev, idt)
        rows.append(idx[:, 0] + ro)
        cols.append(idx[:, 1] + co)
        vals.append(x.vals.to(dev, vdt))
        valid.append(x.valid_mask().to(dev))
    carried, n = compact_select(
        torch.cat(valid), (torch.cat(rows), torch.cat(cols), torch.cat(vals)),
        cap_out=cap)
    out = SparseCOO(indices=torch.stack(carried[:2], 1), vals=carried[2],
                    nnz=min(n, cap), shape=tuple(int(s) for s in out_shape),
                    sort_order=None)
    return out.repad()


def _check_rank2(arrays, name):
    if not arrays:
        raise SpSparseError(f"{name} requires at least one operand")
    for x in arrays:
        if x.rank != 2:
            raise SpSparseError(f"{name} requires rank-2 arrays, got "
                                f"shape {x.shape}")


def coo_hstack(*arrays: SparseCOO, cap: int | None = None) -> SparseCOO:
    """``[A B ...]``: rank-2 arrays with equal row counts side by side
    (``scipy.sparse.hstack``)."""
    _check_rank2(arrays, "coo_hstack")
    nr = arrays[0].shape[0]
    for x in arrays[1:]:
        if x.shape[0] != nr:
            raise SpSparseError(
                f"coo_hstack row mismatch: {x.shape[0]} vs {nr}")
    offs = [0]
    for x in arrays:
        offs.append(offs[-1] + int(x.shape[1]))
    return _coo_stack2d(arrays, [0] * len(arrays), offs[:-1],
                        (nr, offs[-1]), cap)


def coo_vstack(*arrays: SparseCOO, cap: int | None = None) -> SparseCOO:
    """``[A; B; ...]``: rank-2 arrays with equal column counts stacked
    (``scipy.sparse.vstack``)."""
    _check_rank2(arrays, "coo_vstack")
    nc = arrays[0].shape[1]
    for x in arrays[1:]:
        if x.shape[1] != nc:
            raise SpSparseError(
                f"coo_vstack column mismatch: {x.shape[1]} vs {nc}")
    offs = [0]
    for x in arrays:
        offs.append(offs[-1] + int(x.shape[0]))
    return _coo_stack2d(arrays, offs[:-1], [0] * len(arrays),
                        (offs[-1], nc), cap)


def coo_block_diag(*arrays: SparseCOO, cap: int | None = None) -> SparseCOO:
    """``diag(A, B, ...)``: block-diagonal composition of rank-2 arrays
    (``scipy.sparse.block_diag``)."""
    _check_rank2(arrays, "coo_block_diag")
    ro, co = [0], [0]
    for x in arrays:
        ro.append(ro[-1] + int(x.shape[0]))
        co.append(co[-1] + int(x.shape[1]))
    return _coo_stack2d(arrays, ro[:-1], co[:-1], (ro[-1], co[-1]), cap)

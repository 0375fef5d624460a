"""Consolidation: stable lexicographic sort + duplicate merge + zero drop.

PyTorch counterpart of :mod:`spsparse_tpu.core.consolidate` (the
reference's ``algorithm.hpp:237-427``):

* ``sorted_permutation`` — stable lexsort permutation; stability is what
  makes the LEAVE_ALONE=first / REPLACE=last duplicate policies
  well-defined.
* ``consolidate`` — sort by ``sort_order``, drop structural zeros (always)
  and NaNs (iff ``zero_nan``), merge duplicate index tuples per
  ``DuplicatePolicy``, mark the result sorted.

The index columns are packed into mixed-radix int64 words (each column gets
``extent + 1`` values so the sentinel survives packing) and sorted with
``torch.sort(stable=True)``, least significant word first, so the
composition is one stable lexicographic sort. Dead entries carry
all-sentinel keys and sort behind every live one. Runs of equal words are
then merged:

* ``ADD`` sums each run into its own output slot — a segmented sum. It is
  never the difference of one global prefix sum, whose cancellation error
  grows with the total instead of the run (see the JAX docstring of
  ``merge_sorted_entries``). ``method="scatter"`` sums with ``index_add_``,
  which runs left to right per cell on the CPU (bitwise the reference's
  sequential scan); ``method="compact"`` sums each run with
  ``torch.segment_reduce``, deterministic on every device (floating values;
  integer sums are exact either way and use ``index_add_``).
* ``LEAVE_ALONE`` / ``REPLACE`` pick the first / last value of each run.

The JAX package routes large streams through ``core/chunksort.py`` to bound
TPU compile time; nothing here compiles, so the port has no such route.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .coo import SparseCOO, as_tensor
from .errors import DuplicatePolicy, isnone
from ..utils.trace import traced

__all__ = [
    "consolidate",
    "sorted_permutation",
    "merge_sorted_entries",
    "sort_entry_stream",
    "fused_sort_merge",
    "filter_compact",
    "compact_select",
    "Consolidated",
]

Tensor = torch.Tensor

# Packed words are int64; keep one bit of headroom below the sign.
_WORD_LIMIT = 2 ** 62


def compact_select(select: Tensor, carried, *, cap_out: int):
    """Order-preserving compaction of the ``select``-flagged entries of
    parallel 1-D arrays to the front. Each output has length ``cap_out``
    (cut, or zero-padded at the end). Returns ``(arrays, n_selected)``."""
    pos = torch.nonzero(select).squeeze(1)
    n_sel = pos.numel()
    out = []
    for arr in carried:
        if arr.ndim != 1:
            raise ValueError(
                f"compact_select carries 1-D arrays only; got shape "
                f"{tuple(arr.shape)}")
        sel = arr[pos[:cap_out]]
        if n_sel < cap_out:
            sel = torch.cat([sel, torch.zeros(cap_out - n_sel, dtype=arr.dtype,
                                              device=arr.device)])
        out.append(sel)
    return tuple(out), n_sel


def filter_compact(a: SparseCOO, keep: Tensor, *,
                   cap: int | None = None) -> SparseCOO:
    """Keep only the live entries where ``keep`` is true, compacted to the
    front in their order (so sortedness survives)."""
    keep = as_tensor(keep, a.device) & a.valid_mask()
    cap_out = a.cap if cap is None else max(int(cap), 1)
    pos = torch.nonzero(keep).squeeze(1)[:cap_out]
    n_out = pos.numel()
    out = SparseCOO(indices=a.indices[pos], vals=a.vals[pos], nnz=n_out,
                    shape=a.shape, sort_order=a.sort_order)
    return out.with_capacity(cap_out).repad()


def _plan_packing(extents: Sequence[int],
                  limit: int = _WORD_LIMIT) -> list[list[int]]:
    """Greedily group consecutive column extents into words whose value
    range stays below ``limit``; lexicographic order over the words equals
    the column-wise lexicographic order."""
    words: list[list[int]] = []
    cur: list[int] = []
    prod = 1
    for pos, e in enumerate(extents):
        e = max(int(e), 1)
        if cur and prod * e <= limit:
            cur.append(pos)
            prod *= e
        else:
            if cur:
                words.append(cur)
            cur = [pos]
            prod = e
    if cur:
        words.append(cur)
    return words


def _pack_cols(cols, extents, plan) -> list[Tensor]:
    """Pack columns into mixed-radix int64 words per ``plan``."""
    packed = []
    for grp in plan:
        mult = 1
        word = None
        for pos in reversed(grp):
            contrib = cols[pos].long() * mult
            word = contrib if word is None else word + contrib
            mult *= max(int(extents[pos]), 1)
        packed.append(word)
    return packed


def _unpack_cols(words, extents, plan, dtype) -> list[Tensor]:
    """Inverse of :func:`_pack_cols` (div/mod per column)."""
    cols: list = [None] * len(extents)
    for word, grp in zip(words, plan):
        mult = 1
        for pos in reversed(grp):
            e = max(int(extents[pos]), 1)
            cols[pos] = torch.remainder(
                torch.div(word, mult, rounding_mode="floor"), e).to(dtype)
            mult *= e
    return cols


def _lexsort(words) -> Tensor:
    """Stable lexicographic sort permutation over int64 key words (the
    first word most significant)."""
    perm = None
    for w in reversed(words):
        key = w if perm is None else w[perm]
        order = torch.sort(key, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def _sentinel_cols(col_arrays, live, extents):
    return [torch.where(live, c.long(), int(e))
            for c, e in zip(col_arrays, extents)]


def sort_entry_stream(col_arrays, vals, live, *, extents, extra=(),
                      num_key_cols: int | None = None):
    """Stable sort of a (columns, vals) entry stream by its leading
    ``num_key_cols`` columns (all by default). Dead entries get sentinel
    columns and zero values and sort last. Returns
    ``(cols, vals, live, extras)`` sorted."""
    ncols = len(col_arrays)
    if num_key_cols is None:
        num_key_cols = ncols
    dtype = col_arrays[0].dtype
    exts = [int(e) + 1 for e in extents]
    sent = _sentinel_cols(col_arrays, live, extents)
    vals = torch.where(live, vals, torch.zeros((), dtype=vals.dtype,
                                               device=vals.device))
    plan = _plan_packing(exts[:num_key_cols])
    perm = _lexsort(_pack_cols(sent[:num_key_cols], exts[:num_key_cols],
                               plan))
    cols = [c[perm].to(dtype) for c in sent]
    return cols, vals[perm], live[perm], tuple(x[perm] for x in extra)


def sorted_permutation(a: SparseCOO, sort_order: Sequence[int]) -> Tensor:
    """Stable lexsort permutation over the live entries of ``a``: positions
    visiting the entries in ``sort_order``-lexicographic order, ties in
    insertion order. Shape ``(cap,)``; padding positions come last."""
    sort_order = tuple(sort_order)
    other = [d for d in range(a.rank) if d not in sort_order]
    dims = list(sort_order) + other
    pos = torch.arange(a.cap, device=a.device)
    _, _, _, (perm,) = sort_entry_stream(
        [a.indices[:, d] for d in dims], a.vals, a.valid_mask(),
        extents=[a.shape[d] for d in dims], extra=(pos,),
        num_key_cols=len(sort_order))
    return perm


def _segment_sum(vals: Tensor, is_new: Tensor, method: str) -> Tensor:
    """Sum of each run of a non-empty stream (see the module docstring)."""
    if method not in ("compact", "scatter"):
        raise ValueError(f"unknown merge method {method!r}")
    if method == "compact" and vals.dtype.is_floating_point:
        starts = torch.nonzero(is_new).squeeze(1)
        ends = torch.cat([starts[1:], starts.new_tensor([vals.numel()])])
        return torch.segment_reduce(vals, "sum", lengths=ends - starts)
    seg = torch.cumsum(is_new.long(), 0) - 1
    out = torch.zeros(int(seg[-1]) + 1, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg, vals)


def _merge_runs(head_cols, vals, is_new, *, shape, duplicate_policy, cap,
                sort_order, index_dtype, method) -> SparseCOO:
    """Merge the runs of a sorted, all-live stream into a padded
    :class:`SparseCOO` of capacity ``cap``. ``is_new`` marks each run's
    first entry and ``head_cols`` hold the index columns of the run heads
    in natural dimension order; runs beyond ``cap`` are dropped."""
    shape = tuple(int(s) for s in shape)
    cap = max(int(cap), 1)
    n = vals.numel()
    starts = torch.nonzero(is_new).squeeze(1)
    if duplicate_policy == DuplicatePolicy.ADD:
        out_vals = _segment_sum(vals, is_new, method) if n else vals[:0]
    elif duplicate_policy == DuplicatePolicy.LEAVE_ALONE:
        out_vals = vals[starts]
    elif duplicate_policy == DuplicatePolicy.REPLACE:
        ends = torch.cat([starts[1:], starts.new_tensor([n])]) - 1
        out_vals = vals[ends]
    else:  # pragma: no cover
        raise ValueError(f"unknown duplicate policy {duplicate_policy}")
    indices = torch.stack([c[:cap].to(index_dtype) for c in head_cols], 1)
    out = SparseCOO(indices=indices, vals=out_vals[:cap],
                    nnz=indices.shape[0], shape=shape, sort_order=sort_order)
    return out.with_capacity(cap).repad()


def _run_starts(keys) -> Tensor:
    n = keys[0].numel()
    is_new = torch.ones(n, dtype=torch.bool, device=keys[0].device)
    if n > 1:
        same = torch.ones(n - 1, dtype=torch.bool, device=keys[0].device)
        for k in keys:
            same &= k[1:] == k[:-1]
        is_new[1:] = ~same
    return is_new


def merge_sorted_entries(
    index_cols,
    vals: Tensor,
    valid: Tensor,
    *,
    shape: Sequence[int],
    duplicate_policy: DuplicatePolicy = DuplicatePolicy.ADD,
    cap: int,
    sort_order: tuple | None = None,
    index_dtype=None,
    method: str = "compact",
) -> SparseCOO:
    """Merge runs of equal index tuples in an already-sorted entry stream
    (equal tuples adjacent, insertion order kept within runs). Invalid
    entries are dropped. Returns a :class:`SparseCOO` of capacity ``cap``;
    runs beyond ``cap`` are dropped."""
    index_dtype = index_dtype or index_cols[0].dtype
    pos = torch.nonzero(valid).squeeze(1)
    cols = [c[pos] for c in index_cols]
    v = vals[pos]
    is_new = _run_starts(cols)
    heads = torch.nonzero(is_new).squeeze(1)
    return _merge_runs([c[heads] for c in cols], v, is_new, shape=shape,
                       duplicate_policy=duplicate_policy, cap=cap,
                       sort_order=sort_order, index_dtype=index_dtype,
                       method=method)


def fused_sort_merge(col_arrays, vals, live, *, extents, shape,
                     dim_order=None,
                     duplicate_policy: DuplicatePolicy = DuplicatePolicy.ADD,
                     cap: int, sort_order: tuple | None = None,
                     index_dtype=torch.int32, with_run_count: bool = False,
                     method: str = "compact"):
    """Sort + duplicate-merge of an entry stream in packed-word space: pack
    the sentinel-encoded columns, one stable lexsort over the words, run
    boundaries from word equality, one unpack of the run heads.

    ``col_arrays`` are index columns in sort-key order, ``extents`` their
    extents, and ``dim_order[pos]`` the natural dimension of position
    ``pos`` (identity when None). With ``with_run_count`` the true number of
    runs (before the ``cap`` cut) is returned as well.
    """
    ncols = len(col_arrays)
    if dim_order is None:
        dim_order = tuple(range(ncols))
    exts = [int(e) + 1 for e in extents]
    plan = _plan_packing(exts)
    words = _pack_cols(_sentinel_cols(col_arrays, live, extents), exts, plan)
    perm = _lexsort(words)[: int(live.sum())]
    swords = [w[perm] for w in words]
    svals = vals[perm]
    is_new = _run_starts(swords)
    n_runs = int(is_new.sum())
    heads = torch.nonzero(is_new).squeeze(1)
    head_cols = _unpack_cols([w[heads] for w in swords], exts, plan,
                             index_dtype)
    natural: list = [None] * ncols
    for pos, d in enumerate(dim_order):
        natural[d] = head_cols[pos]
    merged = _merge_runs(natural, svals, is_new, shape=shape,
                         duplicate_policy=duplicate_policy, cap=cap,
                         sort_order=sort_order, index_dtype=index_dtype,
                         method=method)
    return (merged, n_runs) if with_run_count else merged


@traced("spsparse.consolidate")
def consolidate(
    a: SparseCOO,
    sort_order: Sequence[int] | None = None,
    duplicate_policy: DuplicatePolicy = DuplicatePolicy.ADD,
    zero_nan: bool = False,
    *,
    cap: int | None = None,
    method: str = "compact",
) -> SparseCOO:
    """Sort ``a`` by ``sort_order``, drop zeros/NaNs, merge duplicates.

    Structural zeros in the *input* are dropped before merging (so a zero
    never overwrites under REPLACE); merged sums that equal zero are kept,
    like the reference. A partial ``sort_order`` is completed with the
    remaining dimensions ascending, so duplicate tuples always end up
    adjacent. The result is marked sorted with the full order.
    """
    if sort_order is None:
        sort_order = tuple(range(a.rank))
    sort_order = tuple(int(d) for d in sort_order)
    full_order = sort_order + tuple(
        d for d in range(a.rank) if d not in sort_order)
    cap_out = a.cap if cap is None else int(cap)
    live = a.valid_mask() & ~isnone(a.vals, zero_nan)
    return fused_sort_merge(
        [a.indices[:, d] for d in full_order], a.vals, live,
        extents=[a.shape[d] for d in full_order], shape=a.shape,
        dim_order=full_order, duplicate_policy=duplicate_policy,
        cap=cap_out, sort_order=full_order, index_dtype=a.index_dtype,
        method=method)


class Consolidated:
    """Consolidate only when needed (reference ``Consolidate`` RAII
    wrapper): if ``a.sort_order`` already matches, ``a`` is used as-is."""

    def __init__(self, a: SparseCOO, sort_order: Sequence[int],
                 duplicate_policy: DuplicatePolicy = DuplicatePolicy.ADD,
                 zero_nan: bool = False, cap: int | None = None):
        sort_order = tuple(int(d) for d in sort_order)
        if a.sort_order == sort_order:
            self._a = a if cap is None else a.with_capacity(cap)
        else:
            self._a = consolidate(a, sort_order, duplicate_policy, zero_nan,
                                  cap=cap)

    def __call__(self) -> SparseCOO:
        return self._a

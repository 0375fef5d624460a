"""Output accumulators as functional combinators.

Counterpart of :mod:`spsparse_tpu.core.accum` (the reference's accumulator
protocol, ``accum.hpp``):

* ``PermuteAccum`` → :func:`permute_output` (same rank) and
  :func:`project_output` (dimensions dropped);
* ``DenseAccum`` → :func:`scatter_to_dense` with the three duplicate
  policies. The reference's LEAVE_ALONE branch overwrites unless the dense
  value is NaN (``accum.hpp:129-130``); like the JAX package, this keeps
  the documented first-write-wins semantics instead;
* ``ScalarAccumulator`` → :func:`scalar_sum`.

Everything runs on the operand's device.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .consolidate import merge_sorted_entries, sort_entry_stream
from .coo import SparseCOO, operand_tensor
from .errors import DuplicatePolicy

__all__ = ["scatter_to_dense", "scalar_sum", "permute_output",
           "project_output"]


def scatter_to_dense(a: SparseCOO, out=None,
                     duplicate_policy: DuplicatePolicy = DuplicatePolicy.ADD):
    """Scatter the live entries into a dense array under the duplicate
    policy; ``out`` (zeros of ``a.shape`` by default) is not modified.

    ADD sums duplicates; LEAVE_ALONE keeps the first entry in stream order,
    REPLACE the last. First and last come from a stable sort on the index
    tuple followed by a run merge, so the result does not depend on the
    order in which a scatter applies duplicate writes.
    """
    if out is None:
        out = torch.zeros(a.shape, dtype=a.dtype, device=a.device)
    else:
        out = operand_tensor(out, a.device).clone()
    if duplicate_policy == DuplicatePolicy.ADD:
        live = a.indices[: a.nnz].long()
        return out.index_put_(tuple(live[:, k] for k in range(a.rank)),
                              a.vals[: a.nnz].to(out.dtype), accumulate=True)
    order = tuple(range(a.rank))
    cols, svals, slive, _ = sort_entry_stream(
        [a.indices[:, d] for d in order], a.vals, a.valid_mask(),
        extents=list(a.shape))
    merged = merge_sorted_entries(
        cols, svals, slive, shape=a.shape, duplicate_policy=duplicate_policy,
        cap=a.cap, sort_order=order, index_dtype=a.index_dtype)
    live = merged.indices[: merged.nnz].long()
    return out.index_put_(tuple(live[:, k] for k in range(a.rank)),
                          merged.vals[: merged.nnz].to(out.dtype))


def scalar_sum(a: SparseCOO) -> torch.Tensor:
    """Sum of all live values, ignoring indices (reference
    ``ScalarAccumulator``); a 0-d tensor on the operand's device."""
    return torch.sum(a.vals[: a.nnz])


def permute_output(a: SparseCOO, perm: Sequence[int]) -> SparseCOO:
    """Permute the dimensions of an output stream (reference
    ``PermuteAccum`` with ``out_rank == in_rank``)."""
    return a.transposed(perm)


def project_output(a: SparseCOO, keep_dims: Sequence[int],
                   shape: Sequence[int] | None = None) -> SparseCOO:
    """Drop dimensions (reference ``PermuteAccum`` with a smaller out-rank):
    keeps the listed dims, in the listed order. Duplicates that arise from
    the projection are not merged; consolidate afterwards if needed."""
    keep_dims = tuple(int(d) for d in keep_dims)
    new_shape = (tuple(a.shape[d] for d in keep_dims) if shape is None
                 else tuple(int(s) for s in shape))
    return SparseCOO(indices=a.indices[:, list(keep_dims)], vals=a.vals,
                     nnz=a.nnz, shape=new_shape, sort_order=None).repad()

"""Interop with ``scipy.sparse``.

Counterpart of the scipy half of :mod:`spsparse_tpu.core.interop`. The
other half converts to and from JAX's own ``BCOO`` and has no place in a
package that imports no JAX. Both functions are host steps: scipy matrices
live in host memory.
"""

from __future__ import annotations

import numpy as np
import torch

from .coo import SparseCOO, default_index_dtype, numpy_dtype
from .errors import SpSparseError

__all__ = ["from_scipy", "to_scipy"]


def from_scipy(m, *, cap: int | None = None, dtype=None,
               device=None) -> SparseCOO:
    """``scipy.sparse`` matrix → :class:`SparseCOO` on ``device`` (the card
    by default), entries in the order of ``m.tocoo()``."""
    coo = m.tocoo()
    idt = numpy_dtype(default_index_dtype(coo.shape))
    idx = np.stack([coo.row, coo.col], axis=1).astype(idt)
    vals = coo.data if dtype is None else coo.data.astype(numpy_dtype(dtype))
    return SparseCOO.from_arrays(idx, vals, coo.shape, cap=cap, check=False,
                                 device=device)


def to_scipy(a: SparseCOO):
    """:class:`SparseCOO` → ``scipy.sparse.coo_matrix`` of its live
    entries, in entry order (rank 2; copies to the host). Values come out
    as float64 (int64 for integer arrays), as in the JAX package."""
    import scipy.sparse as ss

    if a.rank != 2:
        raise SpSparseError("to_scipy requires a rank-2 array")
    idx = a.indices[: a.nnz].cpu().numpy().astype(np.int64)
    vals = a.vals[: a.nnz].cpu()
    if vals.is_floating_point():
        vals = vals.double()
    elif vals.dtype != torch.bool:
        vals = vals.long()
    return ss.coo_matrix((vals.numpy(), (idx[:, 0], idx[:, 1])),
                         shape=a.shape)

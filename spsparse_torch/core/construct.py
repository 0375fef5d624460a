"""Constructors and structural conveniences (eye/diags/random, Kronecker
products, slicing, row/col reductions and scaling, norms, filters).

Counterpart of :mod:`spsparse_tpu.core.construct`. Constructors from host
data (``coo_eye``, ``coo_diags``, ``coo_random``) build on the host and
land on ``device``, the card by default. Every function that takes a
:class:`SparseCOO` runs on that array's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from .consolidate import compact_select, filter_compact
from .coo import (CooBuilder, SparseCOO, as_tensor, default_index_dtype,
                  operand_tensor)
from .errors import SpSparseError

__all__ = ["coo_eye", "coo_diags", "coo_random", "coo_slice", "coo_kron",
           "coo_kronsum", "coo_filter", "coo_tril", "coo_triu",
           "row_sums", "col_sums", "scale_rows", "scale_cols", "coo_norm"]

Tensor = torch.Tensor


def coo_eye(n: int, m: int | None = None, k: int = 0, dtype=np.float32, *,
            device=None) -> SparseCOO:
    """Identity / shifted-identity matrix (``scipy.sparse.eye``) on
    ``device``, the card by default."""
    m = n if m is None else m
    lo, hi = max(0, -k), min(n, m - k)
    b = CooBuilder((n, m), dtype=dtype)
    if hi > lo:
        r = np.arange(lo, hi)
        b.add_many(np.stack([r, r + k], 1), np.ones(hi - lo))
    return b.build(device=device)


def coo_diags(diagonals: Sequence, offsets: Sequence[int],
              shape: tuple[int, int], dtype=np.float32, *,
              device=None) -> SparseCOO:
    """Banded matrix from per-diagonal value arrays (``scipy.sparse.diags``).

    ``diagonals[d]`` holds the values of diagonal ``offsets[d]``, as long as
    that diagonal's in-bounds extent (or a scalar to broadcast).
    """
    n, m = shape
    b = CooBuilder(shape, dtype=dtype)
    for vals, off in zip(diagonals, offsets):
        lo, hi = max(0, -off), min(n, m - off)
        if hi <= lo:
            continue
        r = np.arange(lo, hi)
        v = np.broadcast_to(np.asarray(vals, np.float64), (hi - lo,))
        b.add_many(np.stack([r, r + off], 1), v)
    return b.build(device=device)


def coo_random(shape: Sequence[int], density: float, *, seed: int = 0,
               dtype=np.float32, device=None) -> SparseCOO:
    """Uniform-random sparse array of approximate ``density``
    (``scipy.sparse.random``). The draws are the JAX package's, from
    ``np.random.default_rng(seed)``; duplicate draws merge, so the realised
    density can be marginally lower."""
    rng = np.random.default_rng(seed)
    total = int(np.prod(shape))
    nnz = int(round(density * total))
    b = CooBuilder(shape, dtype=dtype)
    if nnz:
        idx = np.stack([rng.integers(0, s, nnz) for s in shape], axis=1)
        b.add_many(idx, rng.uniform(-1, 1, nnz))
    return b.build(device=device).consolidate(tuple(range(len(shape))))


def _live_pairs(a: SparseCOO) -> tuple[Tensor, Tensor]:
    return a.indices[: a.nnz].long(), a.vals[: a.nnz]


def coo_kron(a: SparseCOO, b: SparseCOO) -> SparseCOO:
    """Kronecker product ``A (x) B`` of rank-2 arrays
    (``scipy.sparse.kron``), in ``a``-major entry order. The outer product
    of the two entry lists runs on ``a``'s device; each product is formed
    in float64 and rounded once to the result type, as in the JAX package."""
    if a.rank != 2 or b.rank != 2:
        raise SpSparseError("coo_kron requires rank-2 operands")
    ia, va = _live_pairs(a)
    ib, vb = _live_pairs(b)
    ib, vb = ib.to(a.device), vb.to(a.device)
    bn, bm = b.shape
    shape = (a.shape[0] * bn, a.shape[1] * bm)
    dt = torch.promote_types(a.dtype, b.dtype)
    rows = (ia[:, 0, None] * bn + ib[None, :, 0]).reshape(-1)
    cols = (ia[:, 1, None] * bm + ib[None, :, 1]).reshape(-1)
    vals = (va.double()[:, None] * vb.double()[None, :]).reshape(-1).to(dt)
    idx = torch.stack([rows, cols], 1).to(default_index_dtype(shape))
    return SparseCOO.from_arrays(idx, vals, shape, check=False)


def coo_kronsum(a: SparseCOO, b: SparseCOO) -> SparseCOO:
    """Kronecker sum ``kron(I_n, A) + kron(B, I_m)`` for square rank-2
    ``A (m, m)`` and ``B (n, n)`` — ``scipy.sparse.kronsum``'s convention."""
    if a.rank != 2 or a.shape[0] != a.shape[1]:
        raise SpSparseError(f"coo_kronsum needs square A, got {a.shape}")
    if b.rank != 2 or b.shape[0] != b.shape[1]:
        raise SpSparseError(f"coo_kronsum needs square B, got {b.shape}")
    from .algebra import coo_add
    dt = torch.promote_types(a.dtype, b.dtype)
    left = coo_kron(coo_eye(int(b.shape[0]), dtype=dt, device=a.device), a)
    right = coo_kron(b, coo_eye(int(a.shape[0]), dtype=dt, device=a.device))
    return coo_add(left, right)


def coo_slice(a: SparseCOO, starts: Sequence[int],
              stops: Sequence[int]) -> SparseCOO:
    """Rectangular subarray ``a[starts[0]:stops[0], ...]`` (rank-N).

    Entry order, duplicates and sortedness metadata survive (a slice of a
    sorted array is sorted); the capacity stays ``a.cap``."""
    if len(starts) != a.rank or len(stops) != a.rank:
        raise SpSparseError("coo_slice bounds must match rank")
    starts = tuple(int(s) for s in starts)
    stops = tuple(min(int(e), ext) for e, ext in zip(stops, a.shape))
    if any(s < 0 or s > e for s, e in zip(starts, stops)):
        raise SpSparseError(f"bad slice bounds {starts}..{stops}")
    new_shape = tuple(e - s for s, e in zip(starts, stops))
    lo = torch.tensor(starts, dtype=a.index_dtype, device=a.device)
    hi = torch.tensor(stops, dtype=a.index_dtype, device=a.device)
    inside = a.valid_mask() & ((a.indices >= lo) & (a.indices < hi)).all(1)
    shifted = a.indices - lo
    carried, n = compact_select(
        inside, tuple(shifted[:, d] for d in range(a.rank)) + (a.vals,),
        cap_out=a.cap)
    out = SparseCOO(indices=torch.stack(carried[:-1], 1), vals=carried[-1],
                    nnz=n, shape=new_shape, sort_order=a.sort_order)
    return out.repad()


def _axis_sums(a: SparseCOO, axis: int) -> Tensor:
    if a.rank != 2:
        raise SpSparseError("row/col sums require a rank-2 array")
    keep = 1 - axis
    idx, vals = _live_pairs(a)
    return torch.zeros(a.shape[keep], dtype=a.dtype,
                       device=a.device).index_add_(0, idx[:, keep], vals)


def row_sums(a: SparseCOO) -> Tensor:
    """Dense ``(nrows,)`` vector of row sums (= ``A @ ones``)."""
    return _axis_sums(a, axis=1)


def col_sums(a: SparseCOO) -> Tensor:
    """Dense ``(ncols,)`` vector of column sums (= ``ones @ A``)."""
    return _axis_sums(a, axis=0)


def _scale_dim(a: SparseCOO, s, dim: int, name: str) -> SparseCOO:
    if a.rank != 2:
        raise SpSparseError(f"{name} requires a rank-2 array")
    s = operand_tensor(s, a.device)
    # Padding indices equal the extent: they read the appended zero.
    ext = torch.cat([s, s.new_zeros(1)])
    g = ext[a.indices[:, dim].long().clamp_(max=s.shape[0])]
    return dataclasses.replace(a, vals=a.vals * g.to(a.dtype))


def scale_rows(a: SparseCOO, s) -> SparseCOO:
    """``diag(s) @ A`` for a dense ``s (nrows,)``: structure kept, one
    gather and one multiply on the values."""
    return _scale_dim(a, s, 0, "scale_rows")


def scale_cols(a: SparseCOO, s) -> SparseCOO:
    """``A @ diag(s)`` for a dense ``s (ncols,)``."""
    return _scale_dim(a, s, 1, "scale_cols")


def coo_norm(a: SparseCOO, ord="fro") -> Tensor:
    """Matrix/array norm over the live entries (``scipy.sparse.linalg.norm``
    naming), on the raw entry stream: opposite-sign duplicates do not
    cancel, so consolidate first for the merged matrix's norm.

    * ``"fro"`` (default): ``sqrt(sum v^2)``, any rank;
    * ``1``: largest column absolute sum (rank 2);
    * ``inf``: largest row absolute sum (rank 2);
    * ``"max"``: largest absolute entry (any rank).

    Returns a 0-d tensor."""
    idx, v = _live_pairs(a)
    if ord == "fro":
        return torch.sqrt(torch.sum(v * v))
    if ord == "max":
        return v.abs().max() if v.numel() else a.vals.new_zeros(())
    if ord in (1, math.inf):
        if a.rank != 2:
            raise SpSparseError("1/inf norms require a rank-2 array")
        # 1-norm groups by column (dim 1), inf-norm by row (dim 0).
        axis = 1 if ord == 1 else 0
        n = int(a.shape[axis])
        sums = torch.zeros(n, dtype=a.dtype, device=a.device).index_add_(
            0, idx[:, axis], v.abs())
        return sums.max() if n else a.vals.new_zeros(())
    raise SpSparseError(f"unsupported norm ord {ord!r}")


def coo_filter(a: SparseCOO, pred) -> SparseCOO:
    """Keep entries where ``pred(indices, vals) -> bool (cap,)`` is true,
    compacted to the front in their order (so sortedness survives)."""
    keep = as_tensor(pred(a.indices, a.vals), a.device).to(torch.bool)
    return filter_compact(a, keep)


def coo_tril(a: SparseCOO, k: int = 0) -> SparseCOO:
    """Lower triangle: entries with ``col - row <= k``
    (``scipy.sparse.tril``)."""
    if a.rank != 2:
        raise SpSparseError("coo_tril requires a rank-2 array")
    return coo_filter(a, lambda idx, _: idx[:, 1] - idx[:, 0] <= k)


def coo_triu(a: SparseCOO, k: int = 0) -> SparseCOO:
    """Upper triangle: entries with ``col - row >= k``
    (``scipy.sparse.triu``)."""
    if a.rank != 2:
        raise SpSparseError("coo_triu requires a rank-2 array")
    return coo_filter(a, lambda idx, _: idx[:, 1] - idx[:, 0] >= k)

"""Row partitioning of sparse matrices across a mesh.

Counterpart of :mod:`spsparse_tpu.dist.partition`. A
:class:`RowPartitionedCSR` stacks ``P`` equal-row-count local CSR blocks
along a leading partition axis — ``row_ptr (P, rows_local+1)``, ``cols
(P, cap_local)`` (global column ids), ``vals (P, cap_local)``, ``nnz
(P,)`` — so that a mesh's ``shard`` hands each partition its own block.
Capacity is the largest block's nnz, a power of two; padded rows are
empty and padded columns hold ``ncols``, as in the JAX package.

The partitioners are host numpy, the JAX package's algorithms (copied, not
imported; two counting steps use ``np.bincount`` and one sort a stable
argsort of a packed key, with the same results), and end in one transfer
to ``device``, the card unless the caller passes another.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.coo import SparseCOO, round_up_pow2
from ..core.device import resolve_device
from ..core.errors import SpSparseError
from ..core.structure import SparseCSR, to_csr
from .mesh import Owned, layout_parts

__all__ = ["RowPartitionedCSR", "RowPartitionedBucketed", "partition_rows",
           "partition_bucketed", "partition_vector"]

Tensor = torch.Tensor


def host_csr(a: SparseCOO | SparseCSR):
    """``(row_ptr, cols, vals, nnz, shape)`` of ``a``'s CSR view as host
    numpy."""
    csr = a if isinstance(a, SparseCSR) else to_csr(a)
    return (csr.row_ptr.cpu().numpy(), csr.cols.cpu().numpy(),
            csr.vals.cpu().numpy(), int(csr.nnz), tuple(csr.shape))


def to_device(device, arrays: dict) -> dict:
    """Host numpy arrays as tensors on ``device`` (one transfer each)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in arrays.items()}


def row_blocks(row_ptr, nrows: int, nnz_total: int, n_parts: int):
    """``(rows_local, [(r0, r1, s0, s1)])``: each partition's row and entry
    range under the block-row distribution."""
    rows_local = -(-nrows // n_parts)
    bounds = []
    for p in range(n_parts):
        r0 = min(p * rows_local, nrows)
        r1 = min((p + 1) * rows_local, nrows)
        s0 = min(int(row_ptr[r0]), nnz_total)
        s1 = min(int(row_ptr[r1]), nnz_total)
        bounds.append((r0, r1, s0, s1))
    return rows_local, bounds


def local_row_ptrs(row_ptr, bounds, rows_local: int) -> np.ndarray:
    """``(P, rows_local+1)`` int32 local row pointers (padded rows empty)."""
    out = np.zeros((len(bounds), rows_local + 1), np.int32)
    for p, (r0, r1, _, _) in enumerate(bounds):
        local = row_ptr[r0:r1 + 1] - row_ptr[r0]
        out[p, : r1 - r0 + 1] = local
        out[p, r1 - r0 + 1:] = local[-1]
    return out


def batched_row_ids(row_ptr: Tensor, cap: int) -> Tensor:
    """Per-entry local row ids of stacked CSR blocks: ``row_ptr (n,
    R+1)`` -> ``(n, cap)`` int64; entries past a block's last row get
    ``R``."""
    n = row_ptr.shape[0]
    slots = torch.arange(cap, dtype=row_ptr.dtype, device=row_ptr.device)
    return torch.searchsorted(row_ptr.contiguous(),
                              slots.expand(n, cap).contiguous(),
                              side="right").long() - 1


@dataclasses.dataclass(frozen=True)
class RowPartitionedCSR:
    """``P`` stacked local CSR blocks of a global ``(nrows, ncols)`` matrix.

    Row ``r`` of the global matrix lives on partition ``r // rows_local``
    as local row ``r % rows_local``. ``cols`` hold *global* column indices;
    ``nnz (P,)`` counts live entries per block. ``owner`` is set when
    ``mesh.shard_layout`` made it: the arrays then hold the mesh's own
    blocks only, partitions ``owner.parts``."""

    row_ptr: Tensor
    cols: Tensor
    vals: Tensor
    nnz: Tensor
    shape: tuple
    owner: Owned | None = None

    @property
    def n_parts(self) -> int:
        return layout_parts(self, self.row_ptr.shape[0])

    @property
    def parts(self) -> tuple:
        """The partition ids the arrays hold, in order."""
        return (tuple(range(self.n_parts)) if self.owner is None
                else self.owner.parts)

    @property
    def rows_local(self) -> int:
        return self.row_ptr.shape[1] - 1

    @property
    def cap_local(self) -> int:
        return self.cols.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def local_block(self, p: int) -> SparseCSR:
        """Partition ``p``'s local block as a :class:`SparseCSR` (local
        rows, global columns); ``p`` must be one the arrays hold."""
        b = self.parts.index(p)
        return SparseCSR(row_ptr=self.row_ptr[b], cols=self.cols[b],
                         vals=self.vals[b], nnz=int(self.nnz[b]),
                         shape=(self.rows_local, self.shape[1]))

    def to_dense(self) -> Tensor:
        """The dense ``shape`` matrix on the blocks' device (a global
        layout only)."""
        if self.owner is not None:
            raise ValueError("to_dense needs the global layout, not the "
                             "blocks a mesh owns")
        blocks = [self.local_block(p).to_dense()
                  for p in range(self.n_parts)]
        return torch.cat(blocks, dim=0)[: self.shape[0]]


def partition_rows(a: SparseCOO | SparseCSR, n_parts: int, *,
                   cap_local: int | None = None,
                   device=None) -> RowPartitionedCSR:
    """Split a matrix into ``n_parts`` equal row blocks (host-side).

    Rows are padded up so that ``nrows_padded = rows_local * n_parts``;
    trailing rows are empty. ``cap_local`` defaults to the largest block's
    nnz rounded up to a power of two."""
    row_ptr, cols, vals, nnz_total, (nrows, ncols) = host_csr(a)
    rows_local, bounds = row_blocks(row_ptr, nrows, nnz_total, n_parts)
    counts = [s1 - s0 for _, _, s0, s1 in bounds]
    if cap_local is None:
        cap_local = round_up_pow2(max(max(counts), 1))
    elif max(counts) > cap_local:
        raise SpSparseError(
            f"cap_local={cap_local} < max block nnz {max(counts)}")

    out_cols = np.full((n_parts, cap_local), ncols, np.int32)
    out_vals = np.zeros((n_parts, cap_local), vals.dtype)
    for p, (_, _, s0, s1) in enumerate(bounds):
        out_cols[p, : s1 - s0] = cols[s0:s1]
        out_vals[p, : s1 - s0] = vals[s0:s1]
    return RowPartitionedCSR(
        **to_device(device, dict(
            row_ptr=local_row_ptrs(row_ptr, bounds, rows_local),
            cols=out_cols, vals=out_vals,
            nnz=np.asarray(counts, np.int32))),
        shape=(nrows, ncols))


@dataclasses.dataclass(frozen=True)
class RowPartitionedBucketed:
    """Row-partitioned matrix with entries also bucketed by the column block
    that owns them — the layout of the ring SpMV, where step ``s`` of
    partition ``p`` multiplies only bucket ``(p + s) % P`` against the x
    block it holds (one pass over the local entries a full ring).

    ``rows/cols/vals (P, Pb, cap_bucket)`` with local row ids, *global*
    column ids, sentinel/zero padding; ``nnz (P, Pb)`` live counts.
    ``owner`` as in :class:`RowPartitionedCSR`."""

    rows: Tensor
    cols: Tensor
    vals: Tensor
    nnz: Tensor
    shape: tuple
    rows_local: int
    blk_len: int
    owner: Owned | None = None

    @property
    def n_parts(self) -> int:
        return layout_parts(self, self.rows.shape[0])

    @property
    def n_buckets(self) -> int:
        return self.rows.shape[1]

    @property
    def cap_bucket(self) -> int:
        return self.rows.shape[2]


def _bucket_order(part_of, bucket_of, rows_of, cols, n_parts: int,
                  n_buckets: int, rows_local: int, ncols: int) -> np.ndarray:
    """``np.lexsort((cols, rows_of, bucket_of, part_of))`` as one stable
    argsort of a packed key when the key fits in int64."""
    span = n_parts * n_buckets * rows_local * (ncols + 1)
    if span < 2 ** 62:
        key = ((part_of * n_buckets + bucket_of) * rows_local
               + rows_of % rows_local) * (ncols + 1) + cols
        return np.argsort(key, kind="stable")
    return np.lexsort((cols, rows_of, bucket_of, part_of))


def partition_bucketed(a: SparseCOO | SparseCSR, n_parts: int, *,
                       blk_len: int | None = None,
                       cap_bucket: int | None = None,
                       device=None) -> RowPartitionedBucketed:
    """Host-side build of the column-bucketed row partition. ``blk_len`` is
    the x-block length each partition owns (by default the block-row
    vector distribution of :func:`partition_vector`)."""
    row_ptr, cols, vals, nnz_total, (nrows, ncols) = host_csr(a)
    rows_local = -(-nrows // n_parts)
    if blk_len is None:
        blk_len = -(-ncols // n_parts)
    n_buckets = -(-ncols // blk_len)

    rows_of = np.repeat(np.arange(nrows, dtype=np.int64),
                        np.diff(row_ptr.astype(np.int64)))[:nnz_total]
    cols = cols[:nnz_total].astype(np.int64)
    part_of = rows_of // rows_local
    bucket_of = cols // blk_len
    key = part_of * n_buckets + bucket_of
    counts = np.bincount(key, minlength=n_parts * n_buckets).reshape(
        n_parts, n_buckets)
    if cap_bucket is None:
        cap_bucket = round_up_pow2(max(int(counts.max(initial=1)), 1))
    elif counts.max(initial=0) > cap_bucket:
        raise SpSparseError(
            f"cap_bucket={cap_bucket} < max bucket {counts.max()}")

    out_rows = np.full((n_parts, n_buckets, cap_bucket), rows_local,
                       np.int32)
    out_cols = np.full((n_parts, n_buckets, cap_bucket), ncols, np.int32)
    out_vals = np.zeros((n_parts, n_buckets, cap_bucket), vals.dtype)
    order = _bucket_order(part_of, bucket_of, rows_of, cols, n_parts,
                          n_buckets, rows_local, ncols)
    p_s, b_s = part_of[order], bucket_of[order]
    group_start = (np.cumsum(counts.reshape(-1)) - counts.reshape(-1))
    slot = np.arange(nnz_total) - group_start[key[order]]
    out_rows[p_s, b_s, slot] = (rows_of[order] % rows_local).astype(np.int32)
    out_cols[p_s, b_s, slot] = cols[order]
    out_vals[p_s, b_s, slot] = vals[:nnz_total][order]
    return RowPartitionedBucketed(
        **to_device(device, dict(
            rows=out_rows, cols=out_cols, vals=out_vals,
            nnz=counts.astype(np.int32))),
        shape=(nrows, ncols), rows_local=rows_local, blk_len=blk_len)


def partition_vector(x, n_parts: int, *, device=None) -> Tensor:
    """Pad and reshape a dense vector (or the rows of a dense block) to
    ``(P, len_local, ...)`` along the block-row distribution of
    :func:`partition_rows`, on ``device`` (the card by default)."""
    if isinstance(x, Tensor):
        x = x.cpu().numpy()
    x = np.asarray(x)
    n = x.shape[0]
    local = -(-n // n_parts)
    out = np.zeros((n_parts * local,) + x.shape[1:], x.dtype)
    out[:n] = x
    return to_device(device, {"x": out.reshape(
        (n_parts, local) + x.shape[1:])})["x"]

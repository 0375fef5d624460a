"""Sparsity-aware distributed SpMV: an all_to_all of x's column footprint.

Counterpart of :mod:`spsparse_tpu.dist.spmv_a2a`. The ring moves every x
block past every partition, but a partition only reads x at its block's
column set, which is fixed by the pattern. So the exchange is planned on
the host:

* prepare (:func:`partition_footprint`): for each (owner q, requester p)
  the sorted unique local x indices ``F[p, q]`` that p's entries need from
  q's block; entry columns become footprint positions ``q * fp_cap +
  rank``;
* run: each owner gathers its x values for every requester (one gather),
  one ``all_to_all`` moves the footprint slabs, and the local SpMV reads
  the received footprint.

Results are the owned blocks, as in :mod:`spsparse_torch.dist.ops`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.coo import SparseCOO, round_up_pow2
from ..core.errors import SpSparseError
from ..core.structure import SparseCSR
from .mesh import Owned, check_mesh, layout_parts
from .ops import live_slots, scatter_rows, take_rows
from .partition import (batched_row_ids, host_csr, local_row_ptrs,
                        row_blocks, to_device)

__all__ = ["RowPartitionedFootprint", "partition_footprint",
           "dist_spmv_a2a", "dist_spmm_a2a"]

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RowPartitionedFootprint:
    """Row-partitioned CSR with footprint-remapped columns and the static
    exchange table.

    ``cols_fp (P, cap_local)``: entry columns as ``q * fp_cap + rank``,
    ``rank`` indexing the sorted unique footprint ``F[p, q]``; ``req
    (P_owner, P_requester, fp_cap)``: the local x indices each owner sends
    each requester (0-padded; ``req_n`` live counts). The owner's axis
    leads, so a mesh's ``shard`` gives a partition the rows it serves.
    ``owner`` as in :class:`~.partition.RowPartitionedCSR`."""

    row_ptr: Tensor
    cols_fp: Tensor
    vals: Tensor
    nnz: Tensor
    req: Tensor
    req_n: Tensor
    shape: tuple
    blk_len: int
    owner: Owned | None = None

    @property
    def n_parts(self) -> int:
        return layout_parts(self, self.row_ptr.shape[0])

    @property
    def rows_local(self) -> int:
        return self.row_ptr.shape[1] - 1

    @property
    def fp_cap(self) -> int:
        return self.req.shape[2]

    @property
    def footprint_per_device(self) -> np.ndarray:
        """Total live footprint values each requester receives (host; a
        global layout)."""
        return self.req_n.cpu().numpy().sum(axis=0)


def partition_footprint(a: SparseCOO | SparseCSR, n_parts: int, *,
                        cap_local: int | None = None,
                        fp_cap: int | None = None,
                        device=None) -> RowPartitionedFootprint:
    """Host-side build of the footprint-exchange row partition, ending in
    one transfer to ``device`` (the card by default)."""
    row_ptr, cols, vals, nnz_total, (nrows, ncols) = host_csr(a)
    blk_len = -(-ncols // n_parts)
    rows_local, bounds = row_blocks(row_ptr, nrows, nnz_total, n_parts)
    counts = [s1 - s0 for _, _, s0, s1 in bounds]
    if cap_local is None:
        cap_local = round_up_pow2(max(max(counts), 1))
    elif max(counts) > cap_local:
        raise SpSparseError(
            f"cap_local={cap_local} < max block nnz {max(counts)}")

    # Footprints F[p][q] and the remapped columns: one sort a partition of
    # the (owner, local index) keys; a unique key's rank within its owner
    # is its footprint position.
    foots, remapped = [], []
    max_fp = 1
    for _, _, s0, s1 in bounds:
        c = cols[s0:s1].astype(np.int64)
        q = np.minimum(c // blk_len, n_parts - 1)
        key = q * (ncols + 1) + (c - q * blk_len)
        uniq, inv = np.unique(key, return_inverse=True)
        u_q = uniq // (ncols + 1)
        first = np.searchsorted(u_q, np.arange(n_parts + 1))
        rank = inv - first[q]
        row_f = [uniq[first[qq]:first[qq + 1]] % (ncols + 1)
                 for qq in range(n_parts)]
        max_fp = max([max_fp] + [f.size for f in row_f])
        foots.append(row_f)
        remapped.append((q, rank))
    if fp_cap is None:
        fp_cap = round_up_pow2(max_fp)
    elif max_fp > fp_cap:
        raise SpSparseError(f"fp_cap={fp_cap} < max footprint {max_fp}")

    Pn = n_parts
    out_cols = np.full((Pn, cap_local), Pn * fp_cap, np.int32)
    out_vals = np.zeros((Pn, cap_local), vals.dtype)
    req = np.zeros((Pn, Pn, fp_cap), np.int32)       # [owner, requester]
    req_n = np.zeros((Pn, Pn), np.int32)
    for p, (_, _, s0, s1) in enumerate(bounds):
        q, rank = remapped[p]
        out_cols[p, : s1 - s0] = (q * fp_cap + rank).astype(np.int32)
        out_vals[p, : s1 - s0] = vals[s0:s1]
        for qq in range(Pn):
            f = foots[p][qq]
            req[qq, p, : f.size] = f
            req_n[qq, p] = f.size
    return RowPartitionedFootprint(
        **to_device(device, dict(
            row_ptr=local_row_ptrs(row_ptr, bounds, rows_local),
            cols_fp=out_cols, vals=out_vals,
            nnz=np.asarray(counts, np.int32), req=req, req_n=req_n)),
        shape=(nrows, ncols), blk_len=blk_len)


def _a2a_spmv(part: RowPartitionedFootprint, x_parts, mesh, axis: str,
              what: str) -> Tensor:
    """Owner-side gather, one ``all_to_all`` of the footprint slabs, the
    local SpMV (SpMM for ``x (P, blk_len, N)``) on what arrived."""
    check_mesh(mesh, part.n_parts, axis, what, exc=SpSparseError)
    if x_parts.shape[1] != part.blk_len:
        raise SpSparseError(
            f"x block length {x_parts.shape[1]} != layout blk_len "
            f"{part.blk_len}")
    P, fp_cap = mesh.n_parts, part.fp_cap
    part = mesh.shard_layout(part)
    rp, cols_fp, vals, nnz, req = (part.row_ptr, part.cols_fp, part.vals,
                                   part.nnz, part.req)
    xl = mesh.shard(x_parts)
    n, cap = cols_fp.shape
    send = take_rows(xl, req.reshape(n, -1).long())      # (n, P*fp[, N])
    recv = mesh.all_to_all(send.reshape((n, P, fp_cap) + xl.shape[2:]))
    xg = recv.reshape((n, P * fp_cap) + xl.shape[2:])
    live = live_slots(nnz, cap)
    c = cols_fp.long().clamp(max=P * fp_cap - 1)
    g = take_rows(xg, c)
    prod = (vals if g.ndim == 2 else vals[..., None]) * g
    return scatter_rows(prod, batched_row_ids(rp, cap), live,
                        part.rows_local)


def dist_spmv_a2a(part: RowPartitionedFootprint, x_parts, mesh,
                  axis: str = "x") -> Tensor:
    """Row-partitioned SpMV with a footprint-only x exchange. ``x_parts``
    is ``(P, blk_len)`` as :func:`~.partition.partition_vector` makes it;
    returns the owned ``(n, rows_local)`` blocks of y."""
    return _a2a_spmv(part, x_parts, mesh, axis, "dist_spmv_a2a")


def dist_spmm_a2a(part: RowPartitionedFootprint, x_parts, mesh,
                  axis: str = "x") -> Tensor:
    """SpMM form: ``x_parts (P, blk_len, N)``; the slabs exchanged are
    ``fp_cap x N`` blocks. Returns owned ``(n, rows_local, N)``."""
    return _a2a_spmv(part, x_parts, mesh, axis, "dist_spmm_a2a")

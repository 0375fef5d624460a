"""Distributed sparse ops over a mesh: SpMV, SpMM, SpGEMM.

Counterpart of :mod:`spsparse_tpu.dist.ops`. Each op takes the global
row-partitioned container and the global ``(P, ...)`` operand, as the JAX
ops do, or the layout ``mesh.shard_layout`` made of it (the form to hold
across the calls of a loop: it is sharded once), runs one body batched
over the partitions the mesh owns (:mod:`spsparse_torch.dist.mesh`), and
returns the owned blocks: ``(P,
...)`` on a :class:`~spsparse_torch.dist.mesh.StackedMesh`, ``(1, ...)``
on a :class:`~spsparse_torch.dist.mesh.GroupMesh`; ``mesh.gather`` gives
the global view. That return shape is the one place where the port's
results differ from the JAX package's, whose ``shard_map`` returns the
global sharded array.

* :func:`dist_spmv` — ``y = A @ x``: ``"all_gather"`` (gather x, one local
  SpMV) or ``"ring"`` (a P-step pipeline: every partition multiplies the x
  block it holds while the next one is in flight).
* :func:`dist_spmv_bucketed`, :func:`dist_spmm_bucketed` — the ring over
  the column-bucketed layout: one pass over the local entries a ring.
* :func:`dist_spmv_halo` — banded SpMV with a neighbour-only halo exchange.
* :func:`dist_spmm` — a dense block right operand, gathered.
* :func:`dist_spgemm` — ``C = A @ B`` with B's blocks all-gathered and the
  local ESC expansion + merge.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.coo import SparseCOO, default_index_dtype
from ..core.errors import spsparse_error
from ..ops.multiply_sparse import (expand_products_raw,
                                   sort_and_merge_products)
from .mesh import check_mesh
from .partition import (RowPartitionedBucketed, RowPartitionedCSR,
                        batched_row_ids)

__all__ = ["dist_spmv", "dist_spmv_bucketed", "dist_spmv_halo", "dist_spmm",
           "dist_spmm_bucketed", "dist_spgemm", "RowPartitionedCOO"]

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RowPartitionedCOO:
    """Stacked per-partition COO blocks: ``indices (n, cap, 2)`` (local row
    ids, global columns; sentinel ``(rows_local, ncols)`` padding), ``vals
    (n, cap)``, ``nnz (n,)``, for the ``n`` partitions a mesh owns (all
    ``P`` on a stacked mesh); ``parts`` names them."""

    indices: Tensor
    vals: Tensor
    nnz: Tensor
    shape: tuple
    rows_local: int
    parts: tuple = None

    def to_coo(self) -> SparseCOO:
        """Host-side: the blocks as one global row-major COO on their
        device (the owned rows only, on a group mesh)."""
        parts = (range(self.indices.shape[0]) if self.parts is None
                 else self.parts)
        idx, vals = [], []
        for b, p in enumerate(parts):
            n = int(self.nnz[b])
            i = self.indices[b, :n].long().clone()
            i[:, 0] += p * self.rows_local
            idx.append(i)
            vals.append(self.vals[b, :n])
        idx = torch.cat(idx, dim=0).to(default_index_dtype(self.shape))
        return SparseCOO.from_arrays(idx, torch.cat(vals), self.shape,
                                     check=False, sort_order=(0, 1),
                                     device=idx.device)


# ----------------------------------------------------------------------
# Helpers of the batched bodies
# ----------------------------------------------------------------------
def live_slots(nnz: Tensor, cap: int) -> Tensor:
    """``(n, cap)`` mask of the live slots of each block."""
    return (torch.arange(cap, device=nnz.device)[None, :]
            < nnz.reshape(-1, 1))


def scatter_rows(prod: Tensor, rows: Tensor, keep: Tensor,
                 nrows: int) -> Tensor:
    """Per-block row sums: ``prod (n, E[, N])`` added into ``(n, nrows[,
    N])`` at ``rows (n, E)`` where ``keep`` (the JAX ``.at[].add`` with
    dropped targets)."""
    n, E = rows.shape
    base = torch.arange(n, device=rows.device)[:, None] * nrows
    flat = (base + rows)[keep]
    out = torch.zeros((n * nrows,) + tuple(prod.shape[2:]), dtype=prod.dtype,
                      device=prod.device)
    out.index_add_(0, flat, prod[keep])
    return out.reshape((n, nrows) + tuple(prod.shape[2:]))


def take_rows(x: Tensor, idx: Tensor) -> Tensor:
    """``x[b, idx[b, e]]`` for every block: ``x (n, L[, N])``, ``idx (n,
    E)`` in range."""
    n = x.shape[0]
    return x[torch.arange(n, device=x.device)[:, None], idx]


def csr_entries(part: RowPartitionedCSR):
    """A sharded layout's ``(rows, cols, vals, live)``: local row ids
    ``(n, cap)`` (int64), global columns, values, the live mask."""
    cap = part.cap_local
    return (batched_row_ids(part.row_ptr, cap), part.cols.long(), part.vals,
            live_slots(part.nnz, cap))


def _check_x(part_rows: int, x_parts, what: str) -> None:
    if x_parts.shape[0] != part_rows:
        raise ValueError(f"{what}: x has {x_parts.shape[0]} partitions, the "
                         f"matrix {part_rows}")


# ----------------------------------------------------------------------
# SpMV / SpMM
# ----------------------------------------------------------------------
def dist_spmv(part: RowPartitionedCSR, x_parts, mesh, axis: str = "x",
              method: str = "ring") -> Tensor:
    """Row-partitioned SpMV ``y = A @ x`` with ``x (P, blk_len)`` in the
    block-row distribution of :func:`~.partition.partition_vector`.
    Returns the owned ``(n, rows_local)`` blocks of y.

    ``method='ring'`` runs the P-step shift pipeline (the next x block is
    in flight while the current one is multiplied; O(local) memory);
    ``method='all_gather'`` gathers x first."""
    check_mesh(mesh, part.n_parts, axis, "dist_spmv")
    _check_x(part.n_parts, x_parts, "dist_spmv")
    if method not in ("ring", "all_gather"):
        raise ValueError(f"unknown method {method!r}")
    P = mesh.n_parts
    blk_len = x_parts.shape[1]
    R = part.rows_local
    rows, cols, vals, live = csr_entries(mesh.shard_layout(part))
    xl = mesh.shard(x_parts)
    if method == "all_gather":
        xg = mesh.all_gather(xl).reshape(-1)
        ok = live & (cols < xg.shape[0])
        prod = vals * xg[cols.clamp(max=xg.shape[0] - 1)]
        return scatter_rows(prod, rows, ok, R)
    me = mesh.axis_index()
    y = torch.zeros((len(mesh.owned), R), dtype=vals.dtype,
                    device=vals.device)
    x_cur = xl
    for s in range(P):
        pending = mesh.shift_start(x_cur, 1) if s + 1 < P else None
        blk = (me + s) % P
        rel = cols - (blk * blk_len)[:, None]
        in_blk = live & (rel >= 0) & (rel < blk_len)
        prod = vals * take_rows(x_cur, rel.clamp(0, blk_len - 1))
        y = y + scatter_rows(prod, rows, in_blk, R)
        if pending is not None:
            x_cur = pending.wait()
    return y


def _bucketed_ring(part: RowPartitionedBucketed, x_parts, mesh, axis: str,
                   what: str) -> Tensor:
    """The ring over the column-bucketed layout, for ``x (P, blk_len)`` or
    ``X (P, blk_len, N)``."""
    check_mesh(mesh, part.n_parts, axis, what)
    P = mesh.n_parts
    blk_len = x_parts.shape[1]
    if part.n_buckets != P or part.blk_len != blk_len:
        raise ValueError(
            "bucketed layout must match the mesh/x distribution: "
            f"n_buckets={part.n_buckets} vs P={P}, "
            f"blk_len={part.blk_len} vs {blk_len}")
    R = part.rows_local
    part = mesh.shard_layout(part)
    rows, cols, vals, nnz = part.rows, part.cols, part.vals, part.nnz
    xl = mesh.shard(x_parts)
    n = rows.shape[0]
    me = mesh.axis_index()
    at = torch.arange(n, device=rows.device)
    slot = torch.arange(rows.shape[2], device=rows.device)
    y = torch.zeros((n, R) + tuple(xl.shape[2:]), dtype=vals.dtype,
                    device=vals.device)
    x_cur = xl
    for s in range(P):
        pending = mesh.shift_start(x_cur, 1) if s + 1 < P else None
        b = (me + s) % P
        r_b, c_b, v_b = rows[at, b].long(), cols[at, b].long(), vals[at, b]
        live = slot[None, :] < nnz[at, b][:, None]
        rel = (c_b - (b * blk_len)[:, None]).clamp(0, blk_len - 1)
        g = take_rows(x_cur, rel)
        prod = (v_b if g.ndim == 2 else v_b[..., None]) * g
        y = y + scatter_rows(prod, r_b.clamp(max=R - 1), live, R)
        if pending is not None:
            x_cur = pending.wait()
    return y


def dist_spmv_bucketed(part: RowPartitionedBucketed, x_parts, mesh,
                       axis: str = "x") -> Tensor:
    """Ring SpMV over the column-bucketed layout: at step ``s`` a partition
    multiplies only the bucket of the x block it holds, so the ring makes
    one pass over the local entries. Returns owned ``(n, rows_local)``."""
    return _bucketed_ring(part, x_parts, mesh, axis, "dist_spmv_bucketed")


def dist_spmm_bucketed(part: RowPartitionedBucketed, x_parts, mesh,
                       axis: str = "x") -> Tensor:
    """Ring SpMM over the column-bucketed layout: the dense block ``X (P,
    blk_len, N)`` rotates around the ring. Returns owned ``(n,
    rows_local, N)``."""
    return _bucketed_ring(part, x_parts, mesh, axis, "dist_spmm_bucketed")


def col_span(part: RowPartitionedCSR, mesh):
    """``(P, 2)`` host table of each partition's least and greatest live
    column (``int64`` max and -1 where it has none), computed once a
    sharded layout (one reduction, one ``all_gather``, one host read) and
    kept on its :class:`~.mesh.Owned` mark."""
    if part.owner.col_span is None:
        live = live_slots(part.nnz, part.cap_local)
        c = part.cols.long()
        big = torch.iinfo(torch.int64).max
        span = torch.stack([torch.where(live, c, big).amin(dim=1),
                            torch.where(live, c, -1).amax(dim=1)], dim=1)
        part.owner.col_span = mesh.all_gather(span).cpu().numpy()
    return part.owner.col_span


def _halo_check(span, blk_len: int, halo: int) -> None:
    """Every live column of partition ``p`` lies in ``[p*blk - halo, (p+1)*
    blk + halo)`` (host arithmetic on :func:`col_span`'s table)."""
    lo = np.arange(span.shape[0]) * blk_len - halo
    bad = (span[:, 0] < lo) | (span[:, 1] >= lo + blk_len + 2 * halo)
    if bad.any():
        raise ValueError(
            f"partition {int(np.nonzero(bad)[0][0])} has columns outside "
            f"its halo-{halo} window; increase halo or use dist_spmv")


def dist_spmv_halo(part: RowPartitionedCSR, x_parts, mesh, axis: str = "x",
                   *, halo: int) -> Tensor:
    """Banded SpMV with a neighbour-only halo exchange: each partition
    receives the last ``halo`` x values of its left neighbour and the
    first ``halo`` of its right one (two shifts of ``halo`` values,
    whatever P). Raises ``ValueError`` when ``halo`` exceeds the block
    length or a live column lies outside its partition's window (checked
    on the operand before any exchange, on every rank alike; the column
    extents are read once a sharded layout)."""
    check_mesh(mesh, part.n_parts, axis, "dist_spmv_halo")
    _check_x(part.n_parts, x_parts, "dist_spmv_halo")
    P = mesh.n_parts
    blk_len = x_parts.shape[1]
    if halo > blk_len:
        raise ValueError(f"halo={halo} exceeds block length {blk_len}")
    part = mesh.shard_layout(part)
    _halo_check(col_span(part, mesh), blk_len, halo)
    R = part.rows_local
    rows, cols, vals, live = csr_entries(part)
    xl = mesh.shard(x_parts)
    me = mesh.axis_index()
    # p receives the tail of p-1's block and the head of p+1's; the
    # wrapped halos at the chain's ends are zero (no periodic boundary).
    from_left = mesh.shift(xl[:, blk_len - halo:], -1)
    from_right = mesh.shift(xl[:, :halo], 1)
    from_left = torch.where((me > 0)[:, None], from_left, 0)
    from_right = torch.where((me < P - 1)[:, None], from_right, 0)
    x_ext = torch.cat([from_left, xl, from_right], dim=1)
    width = blk_len + 2 * halo
    rel = cols - (me * blk_len - halo)[:, None]
    in_win = live & (rel >= 0) & (rel < width)
    prod = vals * take_rows(x_ext, rel.clamp(0, width - 1))
    return scatter_rows(prod, rows, in_win, R)


def dist_spmm(part: RowPartitionedCSR, x_parts, mesh,
              axis: str = "x") -> Tensor:
    """Row-partitioned SpMM: the dense block ``X (P, blk_len, N)``, split
    by rows of the inner dimension, gathered on every partition; a local
    gather + row-sum SpMM. Returns owned ``(n, rows_local, N)``."""
    check_mesh(mesh, part.n_parts, axis, "dist_spmm")
    _check_x(part.n_parts, x_parts, "dist_spmm")
    rows, cols, vals, live = csr_entries(mesh.shard_layout(part))
    xl = mesh.shard(x_parts)
    xg = mesh.all_gather(xl)
    xg = xg.reshape((-1,) + tuple(xg.shape[2:]))
    ok = live & (cols < xg.shape[0])
    prod = vals[..., None] * xg[cols.clamp(max=xg.shape[0] - 1)]
    return scatter_rows(prod, rows, ok, part.rows_local)


# ----------------------------------------------------------------------
# SpGEMM
# ----------------------------------------------------------------------
def check_inner(a_shape, b_shape) -> None:
    """Reference contract (``multiply_sparse.hpp:172-174``)."""
    if a_shape[1] != b_shape[0]:
        spsparse_error(-1,
                       "Inner dimensions for A (%d) and B (%d) must match!",
                       a_shape[1], b_shape[0])


def part_ranks(part_of: Tensor, n: int) -> tuple[Tensor, Tensor]:
    """For a stream grouped by block (``part_of`` nondecreasing): each
    element's rank within its block and the block sizes ``(n,)``."""
    counts = torch.bincount(part_of, minlength=n)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(part_of.numel(), device=part_of.device) \
        - start[part_of]
    return rank, counts


def capped_products(i_t, j_t, v_t, rows_per_part: int, n: int, cap: int):
    """The first ``cap`` products of each block of a stream grouped by
    block (composite rows ``block * rows_per_part + row``), and the count
    each block lost."""
    rank, counts = part_ranks(torch.div(i_t, rows_per_part,
                                        rounding_mode="floor"), n)
    keep = rank < cap
    return (i_t[keep], j_t[keep], v_t[keep],
            (counts - cap).clamp(min=0))


def merge_products(i_t, j_t, v_t, n: int, rows_local: int, ncols: int,
                   out_cap: int):
    """Stable (block, row, column) sort + segmented sum of a product stream
    with composite rows, cut to the first ``out_cap`` distinct cells of
    each block, zero sums dropped — ``sort_and_merge_products(merge_cap=
    out_cap)`` + ``filter_compact`` of the JAX body, a block at a time.

    Returns ``(indices (n, out_cap, 2), vals (n, out_cap), nnz (n,),
    lost (n,))``; ``lost`` counts the cells past ``out_cap``."""
    dev = v_t.device
    merged, n_runs = sort_and_merge_products(
        i_t, j_t, v_t, (n * rows_local, ncols),
        merge_cap=max(int(i_t.shape[0]), 1), with_run_count=True)
    ci = merged.indices[:n_runs, 0].long()
    cj = merged.indices[:n_runs, 1].long()
    cv = merged.vals[:n_runs]
    blk = torch.div(ci, rows_local, rounding_mode="floor")
    rank, runs = part_ranks(blk, n)
    keep = (rank < out_cap) & (cv != 0)
    slot, kept = part_ranks(blk[keep], n)
    idt = default_index_dtype((rows_local, ncols))
    indices = torch.empty((n, out_cap, 2), dtype=idt, device=dev)
    indices[..., 0] = rows_local
    indices[..., 1] = ncols
    vals = torch.zeros((n, out_cap), dtype=v_t.dtype, device=dev)
    b = blk[keep]
    indices[b, slot, 0] = (ci[keep] - b * rows_local).to(idt)
    indices[b, slot, 1] = cj[keep].to(idt)
    vals[b, slot] = cv[keep]
    return (indices, vals, kept.to(torch.int32),
            (runs - out_cap).clamp(min=0))


def expand_blocks(a_rows, a_cols, a_vals, a_live, starts, lens, b_cols,
                  b_vals):
    """ESC expansion of every owned block at once. ``a_*`` are ``(n, E)``
    with composite rows (``block * rows_local + row``); block ``b``'s
    entry ``(i, k)`` meets row ``k`` of B's table ``starts/lens (m, K)``
    into ``b_cols/b_vals (m, C)``, where ``m`` is ``n`` (a table a block)
    or 1 (one table every block shares). Returns ``(i, j, v)`` in stream
    order, grouped by block."""
    m, K = lens.shape
    C = b_cols.shape[1]
    at = torch.arange(m, device=lens.device)[:, None]
    k = torch.where(a_live, a_cols.long() + at * K, m * K)
    i_t, j_t, v_t = expand_products_raw(
        a_rows.reshape(-1), k.reshape(-1), a_vals.reshape(-1),
        a_live.reshape(-1), (starts.long() + at * C).reshape(-1),
        lens.reshape(-1), b_cols.reshape(-1), b_vals.reshape(-1))
    return i_t, j_t.long(), v_t


def dist_spgemm(a_part: RowPartitionedCSR, b_part: RowPartitionedCSR,
                mesh, axis: str = "x", *, expand_cap: int, out_cap: int,
                with_overflow: bool = False):
    """Row-partitioned SpGEMM ``C = A @ B``.

    A is split by output rows, B by inner-dimension rows. Every partition
    all-gathers B's padded blocks, addresses them through a row map
    (global row k lives at ``blk * cap_local + local_ptr``), and runs the
    ESC expansion + merge locally; ``expand_cap``/``out_cap`` bound each
    partition's product count and output nnz.

    ``with_overflow=True`` returns ``(result, overflow)``, ``overflow (n,)``
    counting per partition the products cut by ``expand_cap`` and the
    distinct output cells past ``out_cap``."""
    check_inner(a_part.shape, b_part.shape)
    check_mesh(mesh, a_part.n_parts, axis, "dist_spgemm")
    Ra, J = a_part.rows_local, b_part.shape[1]
    capB = b_part.cap_local
    a_rows, a_cols, a_vals, a_live = csr_entries(mesh.shard_layout(a_part))
    n = a_rows.shape[0]
    b_part = mesh.shard_layout(b_part)
    brp_g = mesh.all_gather(b_part.row_ptr)
    bcols_g = mesh.all_gather(b_part.cols).reshape(-1)
    bvals_g = mesh.all_gather(b_part.vals).reshape(-1)
    nblocks = brp_g.shape[0]
    starts = (brp_g[:, :-1].long() + torch.arange(
        nblocks, device=brp_g.device)[:, None] * capB).reshape(1, -1)
    lens = (brp_g[:, 1:] - brp_g[:, :-1]).reshape(1, -1)
    at = torch.arange(n, device=a_rows.device)[:, None]
    i_t, j_t, v_t = expand_blocks(a_rows + at * Ra, a_cols, a_vals, a_live,
                                  starts, lens, bcols_g[None], bvals_g[None])
    i_t, j_t, v_t, lost_e = capped_products(i_t, j_t, v_t, Ra, n,
                                            expand_cap)
    idx, vals, nnz, lost_o = merge_products(i_t, j_t, v_t, n, Ra, J,
                                            out_cap)
    out = RowPartitionedCOO(indices=idx, vals=vals, nnz=nnz,
                            shape=(a_part.shape[0], J), rows_local=Ra,
                            parts=tuple(mesh.owned))
    overflow = (lost_e + lost_o).to(torch.int32)
    return (out, overflow) if with_overflow else out

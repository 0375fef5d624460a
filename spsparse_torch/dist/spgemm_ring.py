"""Ring-pipelined distributed SpGEMM.

Counterpart of :mod:`spsparse_tpu.dist.spgemm_ring`. B's row blocks rotate
around the ring: at step ``s`` every partition multiplies the A entries
whose inner index falls in the resident B block while the next block is
in flight. Peak memory stays O(local B block); the traffic is one full
rotation of B. A's entries come bucketed by the owner of their inner
index — the :class:`~.partition.RowPartitionedBucketed` layout built with
``blk_len = B.rows_local`` — so step ``s`` touches only bucket ``(p + s)
% P``. ``expand_cap_step`` bounds a partition's products a step; one
stable sort and segmented merge at the end compress them.
"""

from __future__ import annotations

import torch

from .mesh import check_mesh
from .ops import (RowPartitionedCOO, capped_products, check_inner,
                  expand_blocks, merge_products)
from .partition import RowPartitionedBucketed, RowPartitionedCSR

__all__ = ["dist_spgemm_ring"]


def dist_spgemm_ring(a_bkt: RowPartitionedBucketed,
                     b_part: RowPartitionedCSR, mesh, axis: str = "x", *,
                     expand_cap_step: int, out_cap: int):
    """Row-partitioned ``C = A @ B`` with B rotated block by block.

    Returns ``(result, overflow)``: ``overflow (n,)`` counts per owned
    partition every product cut by ``expand_cap_step`` and every distinct
    output cell past ``out_cap``; check ``overflow.sum() == 0``."""
    check_inner(a_bkt.shape, b_part.shape)
    check_mesh(mesh, a_bkt.n_parts, axis, "dist_spgemm_ring")
    P = mesh.n_parts
    if a_bkt.n_buckets != P or a_bkt.blk_len != b_part.rows_local:
        raise ValueError(
            "A must be bucketed by B's row blocks: "
            f"n_buckets={a_bkt.n_buckets} vs P={P}, "
            f"blk_len={a_bkt.blk_len} vs rows_local={b_part.rows_local}")
    Ra, J = a_bkt.rows_local, b_part.shape[1]
    blk = b_part.rows_local
    E = int(expand_cap_step)
    a_bkt, b_part = mesh.shard_layout(a_bkt), mesh.shard_layout(b_part)
    ar, ac, av, an = a_bkt.rows, a_bkt.cols, a_bkt.vals, a_bkt.nnz
    b_state = (b_part.row_ptr, b_part.cols, b_part.vals)
    n = ar.shape[0]
    me = mesh.axis_index()
    at = torch.arange(n, device=ar.device)
    slot = torch.arange(ar.shape[2], device=ar.device)
    streams, lost = [], torch.zeros(n, dtype=torch.long, device=ar.device)
    for s in range(P):
        pending = ([mesh.shift_start(t, 1) for t in b_state]
                   if s + 1 < P else None)
        b = (me + s) % P
        rp, bcols, bvals = b_state
        live = slot[None, :] < an[at, b][:, None]
        k_local = (ac[at, b].long() - (b * blk)[:, None]).clamp(0, blk - 1)
        prods = expand_blocks(
            ar[at, b].long() + at[:, None] * Ra, k_local, av[at, b], live,
            rp[:, :-1], rp[:, 1:] - rp[:, :-1], bcols, bvals)
        *prods, lost_s = capped_products(*prods, Ra, n, E)
        streams.append(prods)
        lost += lost_s
        if pending is not None:
            b_state = tuple(p.wait() for p in pending)
    i_t, j_t, v_t = (torch.cat(t) for t in zip(*streams))
    # Steps were appended in order, so the stable merge sums a cell's
    # products step by step, as the JAX body does.
    idx, vals, nnz, lost_o = merge_products(i_t, j_t, v_t, n, Ra, J,
                                            out_cap)
    out = RowPartitionedCOO(indices=idx, vals=vals, nnz=nnz,
                            shape=(a_bkt.shape[0], J), rows_local=Ra,
                            parts=tuple(mesh.owned))
    return out, (lost + lost_o).to(torch.int32)

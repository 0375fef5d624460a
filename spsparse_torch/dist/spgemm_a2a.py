"""Distributed SpGEMM with an all_to_all exchange of the B rows needed.

Counterpart of :mod:`spsparse_tpu.dist.spgemm_a2a`. :func:`dist_spgemm`
all-gathers B; here each partition receives only the B rows its local A
columns name. The protocol, per partition (batched over the owned ones):

1. **Request build** — sort and dedupe the local A inner indices ``k``;
   bucket them by owner (``k // b_rows_local``) into a ``(P, R1)`` table.
2. **Request exchange** — ``all_to_all``: owner ``o`` receives the row ids
   every peer wants from it.
3. **Reply build** — the owner packs the columns and values of each
   requested row into a ``(P, R2)`` buffer, with each row's length.
4. **Reply exchange** — ``all_to_all``s of the lengths and the payloads.
5. **Mini-CSR** — the requester writes (start, length) per global ``k``
   into tables over its received buffers and runs the local ESC expansion
   and merge.

``req_cap`` (R1) bounds the distinct ``k`` per (partition, owner) pair,
``reply_cap`` (R2) the entries replied per pair, ``expand_cap``/
``out_cap`` the local products and output.
"""

from __future__ import annotations

import torch

from .mesh import check_mesh
from .ops import (RowPartitionedCOO, capped_products, check_inner,
                  csr_entries, expand_blocks, merge_products)
from .partition import RowPartitionedCSR

__all__ = ["dist_spgemm_a2a"]

Tensor = torch.Tensor


def _build_requests(k_cols, live, n_parts: int, rows_local: int,
                    req_cap: int, K: int):
    """Sorted-unique local k's of each block bucketed by owner: ``(n, P,
    R1)`` request tables (sentinel ``K``) and the count of uniques that did
    not fit ``(n,)``."""
    n, cap = k_cols.shape
    ks = torch.sort(torch.where(live, k_cols, K), dim=1).values
    prev = torch.cat([torch.full((n, 1), -1, dtype=ks.dtype,
                                 device=ks.device), ks[:, :-1]], dim=1)
    uniq = (ks < K) & (ks != prev)
    owner = torch.where(uniq, ks // rows_local, n_parts)
    uidx = torch.cumsum(uniq.long(), dim=1) - 1
    counts = torch.zeros((n, n_parts + 1), dtype=torch.long,
                         device=ks.device)
    counts.scatter_add_(1, owner, uniq.long())
    first = torch.cumsum(counts, dim=1) - counts
    slot = uidx - first.gather(1, owner)
    ok = uniq & (slot < req_cap)
    req = torch.full((n, n_parts + 1, req_cap), K, dtype=torch.long,
                     device=ks.device)
    b = torch.arange(n, device=ks.device)[:, None].expand(n, cap)
    req[b[ok], owner[ok], slot[ok]] = ks[ok]
    overflow = (uniq & (slot >= req_cap)).sum(dim=1)
    return req[:, :n_parts], overflow


def _build_replies(req, row_ptr, cols, vals, base_row, rows_local: int,
                   ncols_b: int, reply_cap: int):
    """Pack the requested rows' entries into reply buffers. ``req (n, P,
    R1)``: global row ids requested from each owned block; ``base_row
    (n,)`` the block's first global row. Returns ``(lens (n, P, R1),
    cols (n, P, R2), vals (n, P, R2))``."""
    n, P, R1 = req.shape
    local_r = req - base_row[:, None, None]
    in_range = (local_r >= 0) & (local_r < rows_local)
    lr = local_r.clamp(0, rows_local - 1).reshape(n, -1)
    starts = row_ptr[:, :-1].long().gather(1, lr).reshape(n, P, R1)
    ends = row_ptr[:, 1:].long().gather(1, lr).reshape(n, P, R1)
    lens = torch.where(in_range, ends - starts, 0)
    cum = torch.cumsum(lens, dim=2)
    total = cum[..., -1:]
    t = torch.arange(reply_cap, device=req.device).expand(n, P, reply_cap)
    r = torch.searchsorted(cum.contiguous(), t.contiguous(), side="right")
    r = r.clamp(max=R1 - 1)
    base = cum.gather(2, r) - lens.gather(2, r)
    src = starts.gather(2, r) + (t - base)
    ok = t < total.clamp(max=reply_cap)
    cap = cols.shape[1]
    src = src.clamp(0, cap - 1).reshape(n, -1)
    rc = torch.where(ok, cols.long().gather(1, src).reshape(n, P, -1),
                     ncols_b)
    rv = torch.where(ok, vals.gather(1, src).reshape(n, P, -1), 0)
    return lens, rc, rv


def dist_spgemm_a2a(a_part: RowPartitionedCSR, b_part: RowPartitionedCSR,
                    mesh, axis: str = "x", *, req_cap: int, reply_cap: int,
                    expand_cap: int, out_cap: int):
    """Row-partitioned ``C = A @ B`` with an all_to_all B-row exchange.

    Returns ``(result, overflow)``: ``overflow (n,)`` counts per owned
    partition every static-capacity loss there — request slots past
    ``req_cap``, reply entries past ``reply_cap`` (counted on the
    requester, whose output misses them), products past ``expand_cap`` and
    output cells past ``out_cap``. Check ``overflow.sum() == 0``: a nonzero
    count means entries are missing (never corrupted)."""
    check_inner(a_part.shape, b_part.shape)
    check_mesh(mesh, a_part.n_parts, axis, "dist_spgemm_a2a")
    P = mesh.n_parts
    Ra, J = a_part.rows_local, b_part.shape[1]
    Rb = b_part.rows_local
    K_pad = P * Rb
    a_rows, a_cols, a_vals, a_live = csr_entries(mesh.shard_layout(a_part))
    b_part = mesh.shard_layout(b_part)
    brp, bcols, bvals = b_part.row_ptr, b_part.cols, b_part.vals
    n = a_rows.shape[0]
    me = mesh.axis_index()

    # 1-2: requests out, requests in (row q of req_in: what q asked of us).
    req, ov1 = _build_requests(a_cols, a_live, P, Rb, req_cap, K_pad)
    req_in = mesh.all_to_all(req)
    # 3-4: replies out, replies in (row q: owner q's reply to req[:, q]).
    lens, rcols, rvals = _build_replies(req_in, brp, bcols, bvals, me * Rb,
                                        Rb, J, reply_cap)
    lens_in = mesh.all_to_all(lens)
    rcols_in = mesh.all_to_all(rcols)
    rvals_in = mesh.all_to_all(rvals)

    # 5: the mini-CSR over global k. Owners cut their replies at
    # reply_cap but report whole row lengths: clamp each row to what fits
    # in its owner's region, so an overflowing reply gives missing (not
    # another owner's) entries, and count the loss here.
    starts_within = torch.cumsum(lens_in, dim=2) - lens_in
    lens_eff = torch.minimum(lens_in,
                             (reply_cap - starts_within).clamp(min=0))
    ov2 = (lens_in - lens_eff).sum(dim=(1, 2))
    owner_base = (torch.arange(P, device=lens.device) * reply_cap)[:, None]
    flat_start = (starts_within + owner_base).reshape(n, -1)
    flat_k = req.reshape(n, -1)
    row_start = torch.zeros((n, K_pad + 1), dtype=torch.long,
                            device=lens.device)
    row_len = torch.zeros_like(row_start)
    row_start.scatter_(1, flat_k, flat_start)
    row_len.scatter_(1, flat_k, lens_eff.reshape(n, -1))

    at = torch.arange(n, device=a_rows.device)[:, None]
    i_t, j_t, v_t = expand_blocks(
        a_rows + at * Ra, a_cols, a_vals, a_live, row_start[:, :-1],
        row_len[:, :-1], rcols_in.reshape(n, -1), rvals_in.reshape(n, -1))
    i_t, j_t, v_t, ov3 = capped_products(i_t, j_t, v_t, Ra, n, expand_cap)
    idx, vals, nnz, ov4 = merge_products(i_t, j_t, v_t, n, Ra, J, out_cap)
    out = RowPartitionedCOO(indices=idx, vals=vals, nnz=nnz,
                            shape=(a_part.shape[0], J), rows_local=Ra,
                            parts=tuple(mesh.owned))
    return out, (ov1 + ov2 + ov3 + ov4).to(torch.int32)

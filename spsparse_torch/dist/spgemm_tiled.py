"""Distributed tiled SpGEMM: ring-rotated B blocks, batched tile matmuls.

Counterpart of :mod:`spsparse_tpu.dist.spgemm_tiled`, on the port's
:mod:`spsparse_torch.ops.spgemm_tiled` (``to_tiled``, ``densify_tiled``,
``plan_tiled_spgemm``). A and B are row-partitioned into whole 128-row
tiles; for ``C = A @ B^T`` partition ``q``'s B rows are C's column block
``q``. B's dense tiles rotate around the ring; at step ``s`` partition
``p`` multiplies its A tiles with the resident block ``q = (p + s) % P``
through the host plan for ``(p, q)`` and adds the products into its
output tiles. Communication is one rotation of B's tiles; compute is one
batched ``matmul`` of tile pairs a step, in true float32 (TF32 off while
it runs: the JAX body's ``Precision.HIGHEST``), then an ``index_add_``
into the output tiles.

Every partition's plan is padded to the global maxima: pair slots past a
step's real count add into a trash output tile (index ``Tout``), and
padding tiles are zero.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.coo import SparseCOO
from ..core.errors import SpSparseError
from ..core.tiled import TILE, to_tiled
from ..ops.spgemm_tiled import TiledBlocks, densify_tiled, plan_tiled_spgemm
from .mesh import Owned, check_mesh, layout_parts

__all__ = ["plan_dist_spgemm_tiled", "dist_spgemm_tiled",
           "DistTiledGemmPlan"]

Tensor = torch.Tensor

# Pair slots multiplied a batch: bounds a step's temporaries to
# 3 x 256 x 64 KB a partition.
_PAIR_CHUNK = 256


@dataclasses.dataclass(frozen=True)
class DistTiledGemmPlan:
    """Padded per-partition tile stacks and per-(partition, step) pair
    tables.

    ``a_blocks (P, Ta, T, T)``, ``b_blocks (P, Tb, T, T)`` float32 tensors
    on the operands' device; host numpy ``pa/pb/oid (P, S, Pmax)`` (trash
    slot ``Tout``), ``out_tile_row/col (P, Tout)`` the global coordinates
    of each partition's output tiles (sentinel-padded); ``out_shape`` the
    global extents of C. ``mesh.shard_layout`` of a plan holds the mesh's
    own rows of every table, on its device, and sets ``owner``."""

    a_blocks: Tensor
    b_blocks: Tensor
    pa: np.ndarray
    pb: np.ndarray
    oid: np.ndarray
    out_tile_row: np.ndarray
    out_tile_col: np.ndarray
    out_shape: tuple
    rows_local: int
    owner: Owned | None = None

    @property
    def n_parts(self) -> int:
        return layout_parts(self, self.a_blocks.shape[0])

    @property
    def n_out_tiles(self) -> int:
        return self.out_tile_row.shape[1]


def _part_tiled(a: SparseCOO, n_parts: int) -> list[TiledBlocks]:
    """Split rows into ``n_parts`` blocks of whole 128-row tiles and tile
    each part (host-side split, tiles on ``a``'s device)."""
    nrows = a.shape[0]
    n_block_tiles = -(-nrows // TILE)
    tiles_per_part = -(-n_block_tiles // n_parts)
    rows_local = tiles_per_part * TILE
    n = int(a.nnz)
    idx = a.indices[:n].long().cpu().numpy()
    vals = a.vals[:n]
    parts = []
    for p in range(n_parts):
        r0, r1 = p * rows_local, min((p + 1) * rows_local, nrows)
        m = (idx[:, 0] >= r0) & (idx[:, 0] < r1)
        li = np.stack([idx[m, 0] - r0, idx[m, 1]], 1).reshape(-1, 2)
        part = SparseCOO.from_arrays(
            li, vals[torch.from_numpy(m).to(vals.device)],
            (rows_local, a.shape[1]), check=False, device=a.device)
        parts.append(densify_tiled(to_tiled(part)))
    return parts


def plan_dist_spgemm_tiled(A: SparseCOO, B: SparseCOO, n_parts: int, *,
                           transpose_b: bool = True) -> DistTiledGemmPlan:
    """Host-side planning of ``C = A @ B^(T?)`` over ``n_parts``.

    Only ``transpose_b=True`` (the Gram/regridding form, where B's row
    blocks are C's column blocks) is supported; for ``A @ B`` pass B
    transposed."""
    if not transpose_b:
        raise SpSparseError(
            "dist_spgemm_tiled supports transpose_b=True; for A @ B pass "
            "B pre-transposed (its column blocks are C's column blocks)")
    if A.shape[1] != B.shape[1]:
        raise SpSparseError(
            f"inner dimension mismatch: {A.shape[1]} vs {B.shape[1]}")
    a_parts = _part_tiled(A, n_parts)
    b_parts = _part_tiled(B, n_parts)
    rows_local = a_parts[0].shape[0]
    rows_local_b = b_parts[0].shape[0]
    Ta = max(p.n_tiles for p in a_parts)
    Tb = max(p.n_tiles for p in b_parts)
    dev = A.device
    a_blocks = torch.zeros((n_parts, Ta, TILE, TILE), dtype=torch.float32,
                           device=dev)
    b_blocks = torch.zeros((n_parts, Tb, TILE, TILE), dtype=torch.float32,
                           device=dev)
    for p in range(n_parts):
        a_blocks[p, : a_parts[p].n_tiles] = a_parts[p].blocks
        b_blocks[p, : b_parts[p].n_tiles] = b_parts[p].blocks

    # Pair plans per (p, q) in local tile indices; each partition's output
    # tiles registered in first-seen order, keyed by global coordinate.
    out_shape = (A.shape[0], B.shape[0])
    nbc_out = -(-(n_parts * rows_local_b) // TILE)
    raw = {}
    out_keys = [dict() for _ in range(n_parts)]
    pmax = 1
    for p in range(n_parts):
        row_off = p * (rows_local // TILE)
        for s in range(n_parts):
            q = (p + s) % n_parts
            plan = plan_tiled_spgemm(a_parts[p], b_parts[q],
                                     transpose_b=True)
            col_off = q * (rows_local_b // TILE)
            keys = ((plan.out_tile_row[plan.oid].astype(np.int64) + row_off)
                    * nbc_out
                    + plan.out_tile_col[plan.oid].astype(np.int64) + col_off)
            reg = out_keys[p]
            slots = np.empty(keys.shape[0], np.int64)
            for k, key in enumerate(keys.tolist()):
                slots[k] = reg.setdefault(key, len(reg))
            raw[(p, s)] = (plan.pa, plan.pb, slots)
            pmax = max(pmax, keys.shape[0])
    tout = max(max((len(r) for r in out_keys), default=1), 1)

    pa = np.zeros((n_parts, n_parts, pmax), np.int32)
    pb = np.zeros((n_parts, n_parts, pmax), np.int32)
    oid = np.full((n_parts, n_parts, pmax), tout, np.int32)  # trash slot
    for (p, s), (ia, ib, io) in raw.items():
        pa[p, s, : ia.shape[0]] = ia
        pb[p, s, : ib.shape[0]] = ib
        oid[p, s, : io.shape[0]] = io
    otr = np.full((n_parts, tout), -(-out_shape[0] // TILE), np.int32)
    otc = np.full((n_parts, tout), nbc_out, np.int32)
    for p in range(n_parts):
        for key, slot in out_keys[p].items():
            otr[p, slot] = key // nbc_out
            otc[p, slot] = key % nbc_out
    return DistTiledGemmPlan(
        a_blocks=a_blocks, b_blocks=b_blocks, pa=pa, pb=pb, oid=oid,
        out_tile_row=otr, out_tile_col=otc, out_shape=out_shape,
        rows_local=rows_local)


def dist_spgemm_tiled(plan: DistTiledGemmPlan, mesh,
                      axis: str = "x") -> TiledBlocks:
    """Run a :func:`plan_dist_spgemm_tiled` plan over ``mesh``.

    Returns the owned partitions' output tiles as one
    :class:`TiledBlocks` (``n * Tout`` tiles, sentinel-padded; all of C on
    a stacked mesh, as the JAX package returns it)."""
    check_mesh(mesh, plan.n_parts, axis, "dist_spgemm_tiled",
               exc=SpSparseError)
    P, Tout = mesh.n_parts, plan.n_out_tiles
    plan = mesh.shard_layout(plan)
    a_blk, b_blk = plan.a_blocks, plan.b_blocks
    pa, pb, oid, otr, otc = (t.long() for t in (
        plan.pa, plan.pb, plan.oid, plan.out_tile_row, plan.out_tile_col))
    n = a_blk.shape[0]
    dev = a_blk.device
    at = torch.arange(n, device=dev)[:, None]
    out = torch.zeros((n * (Tout + 1), TILE, TILE), dtype=torch.float32,
                      device=dev)
    # IEEE float32 tile products (no TF32), the JAX body's HIGHEST.
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s in range(P):
            pending = mesh.shift_start(b_blk, 1) if s + 1 < P else None
            for c0 in range(0, pa.shape[2], _PAIR_CHUNK):
                c = slice(c0, c0 + _PAIR_CHUNK)
                prods = torch.matmul(a_blk[at, pa[:, s, c]],
                                     b_blk[at, pb[:, s, c]].transpose(-1, -2))
                out.index_add_(0, (at * (Tout + 1) + oid[:, s, c]).reshape(-1),
                               prods.reshape(-1, TILE, TILE))
            if pending is not None:
                b_blk = pending.wait()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out = out.reshape(n, Tout + 1, TILE, TILE)[:, :Tout]
    return TiledBlocks(tile_row=otr.reshape(-1).to(torch.int32),
                       tile_col=otc.reshape(-1).to(torch.int32),
                       blocks=out.reshape(-1, TILE, TILE),
                       shape=plan.out_shape)

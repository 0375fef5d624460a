"""Tiled COO: general sparse matrices as a sparse pattern of 128x128 tiles.

Counterpart of :mod:`spsparse_tpu.core.tiled`. Entries are grouped into
``(128, 128)`` tiles; only nonempty tiles are stored, each padded to a
per-tile entry budget ``tile_cap``. Per entry the layout keeps int8 row and
column offsets within the tile plus the value. The layout is the JAX
package's field for field, so that both packages hold the same arrays on
the same input.

The JAX package builds the layout on the host from ``a.to_lists()``. Here
it is built with tensor ops on the operand's device: a stable sort of the
entries by ``tile_row * nbc + tile_col``, ``unique_consecutive`` for the
tiles, and each entry's slot as its position minus the start of its tile's
run. :func:`pack_columns` computes the same column order as the JAX
package, ties included.
"""

from __future__ import annotations

import dataclasses

import torch

from .coo import SparseCOO, round_up_pow2
from .errors import SpSparseError

__all__ = ["SparseTiledCOO", "to_tiled", "pack_columns", "TILE"]

Tensor = torch.Tensor

TILE = 128


@dataclasses.dataclass(frozen=True)
class SparseTiledCOO:
    """Sparse pattern of dense-indexed 128x128 tiles.

    ``tile_row/tile_col (nt_cap,)`` int32 tile coordinates (row-major
    sorted, sentinel = nbrows/nbcols for padding); ``rows/cols (nt_cap,
    tile_cap)`` int8 in-tile offsets; ``vals (nt_cap, tile_cap)`` float32
    with zero padding; ``n_tiles`` the live-tile count (a Python int, as
    ``SparseCOO.nnz``).
    """

    tile_row: Tensor
    tile_col: Tensor
    rows: Tensor
    cols: Tensor
    vals: Tensor
    n_tiles: int
    shape: tuple

    @property
    def nt_cap(self) -> int:
        return self.tile_row.shape[0]

    @property
    def tile_cap(self) -> int:
        return self.rows.shape[1]

    @property
    def nbrows(self) -> int:
        return -(-self.shape[0] // TILE)

    @property
    def nbcols(self) -> int:
        return -(-self.shape[1] // TILE)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def valid_mask(self) -> Tensor:
        return torch.arange(self.nt_cap, device=self.device) < self.n_tiles

    def to_dense(self) -> Tensor:
        """Dense ``shape`` matrix; duplicate entries sum."""
        nr, nc = self.nbrows * TILE, self.nbcols * TILE
        nt = self.n_tiles
        live = self.vals[:nt] != 0
        gr = self.tile_row[:nt, None].long() * TILE + self.rows[:nt].long()
        gc = self.tile_col[:nt, None].long() * TILE + self.cols[:nt].long()
        dense = torch.zeros(nr * nc, dtype=self.vals.dtype, device=self.device)
        dense.index_add_(0, (gr * nc + gc)[live], self.vals[:nt][live])
        return dense.reshape(nr, nc)[: self.shape[0], : self.shape[1]]


def _live_entries(a: SparseCOO, what: str) -> tuple[Tensor, Tensor]:
    """``(idx (nnz, 2) int64, vals)`` of a rank-2 COO's live entries."""
    if a.rank != 2:
        raise SpSparseError(f"{what} requires a rank-2 array")
    return a.indices[: a.nnz].long(), a.vals[: a.nnz]


def _runs(key_sorted: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """``(unique keys, run starts, run lengths)`` of a sorted key tensor."""
    uniq, counts = torch.unique_consecutive(key_sorted, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    return uniq, starts, counts


def pack_columns(a: SparseCOO) -> tuple[SparseCOO, Tensor]:
    """Column-permute ``a`` so each row block's columns cluster into few
    128-wide tiles (SELL-style fill raising).

    Each column goes to the row block that references it most (its modal
    block; ties to the lowest block); a stable sort by owner block then
    packs every block's columns contiguously, and untouched columns go
    last. Returns ``(a_packed, order)`` where ``order`` (int64, on the
    operand's device) maps new column -> old column:
    ``a_packed[:, k] == a[:, order[k]]``, so that
    ``to_tiled(a_packed) @ X[order] == a @ X``.
    """
    idx, vals = _live_entries(a, "pack_columns")
    dev = idx.device
    ncols = a.shape[1]
    nbr = -(-a.shape[0] // TILE)
    owner = torch.full((ncols,), nbr, dtype=torch.int64, device=dev)
    if idx.shape[0]:
        key = idx[:, 1] * nbr + idx[:, 0] // TILE
        uk, counts = torch.unique(key, return_counts=True)
        kc, krb = uk // nbr, uk % nbr
        # The JAX package's np.lexsort((krb, -counts, kc)): uk is sorted by
        # (kc, krb), so a stable sort by -counts and then a stable sort by
        # kc give the order (kc, -counts, krb).
        sel = torch.sort(-counts, stable=True).indices
        sel = sel[torch.sort(kc[sel], stable=True).indices]
        kcs = kc[sel]
        first = torch.ones_like(kcs, dtype=torch.bool)
        first[1:] = kcs[1:] != kcs[:-1]
        owner[kcs[first]] = krb[sel][first]
    order = torch.sort(owner, stable=True).indices
    inv = torch.empty_like(order)
    inv[order] = torch.arange(ncols, device=dev)
    new_idx = torch.stack([idx[:, 0], inv[idx[:, 1]]], 1).to(a.index_dtype)
    packed = SparseCOO.from_arrays(new_idx, vals, a.shape, cap=a.cap,
                                   check=False)
    return packed, order


def to_tiled(a: SparseCOO, *, tile_cap: int | None = None,
             nt_cap: int | None = None) -> SparseTiledCOO:
    """COO -> tiled COO on the operand's device. Duplicates are kept (they
    sum in products, as under COO ADD semantics). ``tile_cap`` and
    ``nt_cap`` default to the powers of two above the largest tile and the
    tile count."""
    idx, vals = _live_entries(a, "to_tiled")
    dev = idx.device
    nbr = -(-a.shape[0] // TILE)
    nbc = -(-a.shape[1] // TILE)
    key = (idx[:, 0] // TILE) * nbc + idx[:, 1] // TILE
    order = torch.sort(key, stable=True).indices
    uniq, starts, counts = _runs(key[order])
    nt = uniq.shape[0]
    most = int(counts.max()) if nt else 0
    if tile_cap is None:
        tile_cap = round_up_pow2(max(most, 1))
    elif most > tile_cap:
        raise SpSparseError(
            f"tile_cap={tile_cap} < max tile occupancy {most}")
    if nt_cap is None:
        nt_cap = round_up_pow2(max(nt, 1))
    elif nt > nt_cap:
        raise SpSparseError(f"nt_cap={nt_cap} < {nt}")

    tile_row = torch.full((nt_cap,), nbr, dtype=torch.int32, device=dev)
    tile_col = torch.full((nt_cap,), nbc, dtype=torch.int32, device=dev)
    rows = torch.zeros((nt_cap, tile_cap), dtype=torch.int8, device=dev)
    cols = torch.zeros((nt_cap, tile_cap), dtype=torch.int8, device=dev)
    v = torch.zeros((nt_cap, tile_cap), dtype=torch.float32, device=dev)
    tile_row[:nt] = (uniq // nbc).to(torch.int32)
    tile_col[:nt] = (uniq % nbc).to(torch.int32)
    tile_of = torch.repeat_interleave(torch.arange(nt, device=dev), counts)
    slot = torch.arange(order.shape[0], device=dev) - starts[tile_of]
    src = idx[order]
    rows[tile_of, slot] = (src[:, 0] % TILE).to(torch.int8)
    cols[tile_of, slot] = (src[:, 1] % TILE).to(torch.int8)
    v[tile_of, slot] = vals[order].to(torch.float32)
    return SparseTiledCOO(tile_row=tile_row, tile_col=tile_col, rows=rows,
                          cols=cols, vals=v, n_tiles=int(nt),
                          shape=tuple(a.shape))

"""Tiled general SpMM: the one-hot entry kernel K7 and the dense-block
kernel K6.

Counterpart of :mod:`spsparse_tpu.ops.pallas_tiled` (``spmm_tiled_pallas``
with the Pallas kernel ``_tiled_kernel``, and ``spmm_tiled_dense_pallas``
with ``_tiled_dense_kernel``). Both take a :class:`SparseTiledCOO` grouped
by block row:

* :class:`PreparedTiledRows` (:func:`prepare_tiled_rows`): per block row
  ``Rt`` tile slots, ``tcols (nbr, Rt)`` int32 tile columns (sentinel
  ``nbc``), ``rows/cols (nbr, Rt, cap)`` int32 in-tile offsets and ``vals``
  float32. :func:`spmm_tiled_onehot` (K7) computes
  ``Y[b*128 + rows[b,t,e]] += vals[b,t,e] * X[tcols[b,t]*128 + cols[b,t,e]]``.
* :class:`PreparedTiledDense` (:func:`prepare_tiled_dense`): the same slots
  as dense ``(128, 128)`` blocks, float32 or bfloat16.
  :func:`spmm_tiled_dense` (K6) computes
  ``Y_b = sum_t blocks[b,t] @ X[tcols[b,t]*128 : +128]``.

Both give a float32 ``(shape[0], N)`` result. On CUDA tensors the wrappers
launch the Hopper kernels ``sps_tiled_onehot`` and ``sps_tiled_dense``
(``spsparse_torch/csrc/tiled.cu``; K6's body, a ``cp.async`` ring with
bfloat16 on ``mma.sync`` tensor cores, is ``csrc/tiled_dense.cuh``; K7
stages the X rows its entries name in shared memory and keeps Y in
registers, or, for tiles of at most 256 entries, gives a warp each block
row); on
CPU tensors they run the plain
versions :func:`spmm_tiled_onehot_reference` and
:func:`spmm_tiled_dense_reference`, which are blocked over block rows so
that no intermediate exceeds about 128 MB. K6 casts ``X`` to the blocks'
type first, as the JAX package does.

The layouts are built with tensor ops on the operand's device and equal the
JAX package's array for array. Autograd follows the JAX custom VJPs
(``_spmm_tiled_ad_bwd`` and ``_spmm_tiled_dense_ad_bwd``), which are XLA
code, so the backwards here are plain PyTorch: gradients reach
``prep.vals`` / ``prep.blocks`` and ``X``.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import backend
from ..core.errors import SpSparseError
from ..core.tiled import TILE, SparseTiledCOO
from .spmm import _gather_rows
from .tiled_ops import chunks

__all__ = ["DENSE_FILL_THRESHOLD", "PreparedTiledRows", "prepare_tiled_rows",
           "PreparedTiledDense", "prepare_tiled_dense", "spmm_tiled_onehot",
           "spmm_tiled_onehot_reference", "spmm_tiled_dense",
           "spmm_tiled_dense_reference", "TiledOnehotFunction",
           "TiledDenseFunction", "dense_vjp"]

Tensor = torch.Tensor

# Entries per occupied tile above which prepare_general takes the dense
# blocks rather than the one-hot kernel. TPU-derived (the v5e crossover of
# the two Pallas kernels); kept so that both packages route a matrix alike.
# Re-deriving it on the H100 is ROADMAP item 14.
DENSE_FILL_THRESHOLD = 64

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class PreparedTiledRows:
    """Row-grouped entry layout: ``tcols (nbr, Rt)`` int32 block-column ids
    (sentinel nbc), ``rows/cols (nbr, Rt, cap)`` int32 in-tile offsets,
    ``vals (nbr, Rt, cap)`` float32."""

    tcols: Tensor
    rows: Tensor
    cols: Tensor
    vals: Tensor
    shape: tuple

    @property
    def nbr(self) -> int:
        return self.tcols.shape[0]

    @property
    def tiles_per_row(self) -> int:
        return self.tcols.shape[1]

    @property
    def tile_cap(self) -> int:
        return self.rows.shape[2]

    @property
    def nbc(self) -> int:
        return -(-self.shape[1] // TILE)

    @property
    def device(self) -> torch.device:
        return self.vals.device


@dataclasses.dataclass(frozen=True)
class PreparedTiledDense:
    """Row-grouped dense-block layout: ``tcols (nbr, Rt)`` int32
    block-column ids (sentinel nbc), ``blocks (nbr, Rt, 128, 128)`` float32
    or bfloat16 (zero where no entry)."""

    tcols: Tensor
    blocks: Tensor
    shape: tuple

    @property
    def nbr(self) -> int:
        return self.tcols.shape[0]

    @property
    def tiles_per_row(self) -> int:
        return self.tcols.shape[1]

    @property
    def nbc(self) -> int:
        return -(-self.shape[1] // TILE)

    @property
    def device(self) -> torch.device:
        return self.blocks.device


def _row_slots(tl: SparseTiledCOO):
    """``(tile rows (nt,), slot within the block row (nt,), Rt)`` of the
    live tiles (row-major sorted, so a slot is the index minus the start of
    the tile's block-row run)."""
    nt = tl.n_tiles
    tr = tl.tile_row[:nt].long()
    counts = torch.bincount(tr, minlength=tl.nbrows)
    Rt = max(int(counts.max()) if counts.numel() else 1, 1)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(nt, device=tr.device) - starts[tr]
    return tr, slot, Rt


def prepare_tiled_rows(tl: SparseTiledCOO) -> PreparedTiledRows:
    """Group a :class:`SparseTiledCOO` by block row (on its device)."""
    nt = tl.n_tiles
    tr, slot, Rt = _row_slots(tl)
    nbr, cap, dev = tl.nbrows, tl.tile_cap, tl.device
    tcols = torch.full((nbr, Rt), tl.nbcols, dtype=torch.int32, device=dev)
    rows = torch.zeros((nbr, Rt, cap), dtype=torch.int32, device=dev)
    cols = torch.zeros((nbr, Rt, cap), dtype=torch.int32, device=dev)
    vals = torch.zeros((nbr, Rt, cap), dtype=torch.float32, device=dev)
    tcols[tr, slot] = tl.tile_col[:nt]
    rows[tr, slot] = tl.rows[:nt].to(torch.int32)
    cols[tr, slot] = tl.cols[:nt].to(torch.int32)
    vals[tr, slot] = tl.vals[:nt]
    return PreparedTiledRows(tcols=tcols, rows=rows, cols=cols, vals=vals,
                             shape=tl.shape)


def prepare_tiled_dense(tl: SparseTiledCOO, dtype=torch.float32, *,
                        host_limit_bytes: int = 8 << 30
                        ) -> PreparedTiledDense:
    """Densify a :class:`SparseTiledCOO` into per-block-row dense tiles (on
    its device), summed in float32 and then cast to ``dtype`` (float32 or
    bfloat16: bfloat16 halves the block and X traffic, accumulation stays
    float32).

    ``host_limit_bytes`` bounds the float32 staging of the blocks, the
    guard against feeding a truly sparse matrix to the dense layout."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"prepare_tiled_dense: dtype must be float32 or "
                         f"bfloat16, got {dtype}")
    nt = tl.n_tiles
    tr, slot, Rt = _row_slots(tl)
    nbr, dev = tl.nbrows, tl.device
    est = nbr * Rt * TILE * TILE * 4
    if est > host_limit_bytes:
        raise SpSparseError(
            f"prepare_tiled_dense would materialize {est >> 30} GiB of dense "
            f"blocks (nbr x Rt = {nbr} x {Rt}); this matrix belongs on the "
            "one-hot kernel (prepare_tiled_rows / prepare_general picks it "
            "automatically at low fill)")
    tcols = torch.full((nbr, Rt), tl.nbcols, dtype=torch.int32, device=dev)
    tcols[tr, slot] = tl.tile_col[:nt]
    blocks = torch.zeros(nbr * Rt * TILE * TILE, dtype=torch.float32,
                         device=dev)
    # One scatter-add of every live entry: padding slots hold 0 and add
    # nothing; duplicate offsets sum, as under consolidate(ADD).
    vals = tl.vals[:nt]
    live = vals != 0
    flat = (((tr * Rt + slot)[:, None] * TILE + tl.rows[:nt].long()) * TILE
            + tl.cols[:nt].long())
    blocks.index_add_(0, flat[live], vals[live])
    return PreparedTiledDense(
        tcols=tcols, blocks=blocks.reshape(nbr, Rt, TILE, TILE).to(dtype),
        shape=tl.shape)


# --- shared checks ----------------------------------------------------------
def check_rhs(prep, X: Tensor) -> Tensor:
    """Validate ``X (K, N)`` against a prepared operand; return it
    contiguous (no device move, no cast)."""
    if not isinstance(X, Tensor) or X.ndim != 2:
        raise ValueError("X must be a 2-D tensor (K, N)")
    if X.shape[0] != prep.shape[1]:
        raise ValueError(f"X has {X.shape[0]} rows; the operand has "
                         f"{prep.shape[1]} columns")
    if not X.dtype.is_floating_point:
        raise TypeError(f"X must be floating point, got {X.dtype}")
    if X.device != prep.device:
        raise ValueError(f"X is on {X.device} but the operand is on "
                         f"{prep.device}")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {X.device}")
    return X.contiguous()


def needs_grad(*tensors: Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def tile_rows(tcols: Tensor, nbc: int, sentinel: int) -> Tensor:
    """Global X rows ``(c, Rt, 128)`` of each slot's tile; padding slots
    get ``sentinel`` (a row that reads zero)."""
    tc = tcols.long()
    rows = tc[:, :, None] * TILE + torch.arange(TILE, device=tc.device)
    return torch.where((tc < nbc)[:, :, None], rows, sentinel)


def pad_rows(G: Tensor, n: int) -> Tensor:
    """``G`` as float32 with zero rows appended up to ``n`` rows."""
    G = G.to(torch.float32)
    if G.shape[0] == n:
        return G
    return torch.cat([G, G.new_zeros((n - G.shape[0],) + G.shape[1:])])


# --- K7: one-hot (entry) kernel --------------------------------------------
def spmm_tiled_onehot_reference(prep: PreparedTiledRows, X: Tensor) -> Tensor:
    """Plain PyTorch K7: per block-row chunk, gather the X row of every
    slot, scale by its value and ``index_add_`` into Y (float32)."""
    K, N = X.shape
    nbr, Rt, cap = prep.nbr, prep.tiles_per_row, prep.tile_cap
    Xf = X.to(torch.float32)
    Y = torch.zeros((nbr * TILE, N), dtype=torch.float32, device=X.device)
    for sl in chunks(nbr, 3 * Rt * cap * N * 4):
        tc = prep.tcols[sl].long()
        gcol = torch.where((tc < prep.nbc)[:, :, None],
                           tc[:, :, None] * TILE + prep.cols[sl].long(), K)
        brow = torch.arange(sl.start, sl.stop, device=X.device)
        grow = (brow[:, None, None] * TILE + prep.rows[sl].long())
        prod = prep.vals[sl].reshape(-1, 1) * _gather_rows(
            Xf, gcol.reshape(-1))
        Y.index_add_(0, grow.reshape(-1), prod)
    return Y[: prep.shape[0]]


def _onehot(prep: PreparedTiledRows, X: Tensor) -> Tensor:
    """K7 on a CUDA ``X``, its plain version on a CPU ``X``."""
    if X.device.type == "cpu":
        return spmm_tiled_onehot_reference(prep, X)
    M = prep.shape[0]
    K, N = X.shape
    Y = torch.empty((M, N), dtype=torch.float32, device=X.device)
    if M == 0 or N == 0:
        return Y
    for name in ("tcols", "rows", "cols"):
        t = getattr(prep, name)
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"PreparedTiledRows.{name} must be contiguous "
                             "int32")
    if prep.vals.dtype != torch.float32 or not prep.vals.is_contiguous():
        raise ValueError("PreparedTiledRows.vals must be contiguous float32")
    lib = backend.load_kernels()
    err = lib.sps_tiled_onehot(
        prep.tcols.data_ptr(), prep.rows.data_ptr(), prep.cols.data_ptr(),
        prep.vals.data_ptr(), -(-M // TILE), prep.tiles_per_row,
        prep.tile_cap, prep.nbc, X.data_ptr(), K, N, Y.data_ptr(), M,
        backend.current_stream(X.device))
    backend.check(err, "sps_tiled_onehot")
    spmm_tiled_onehot.launches += 1
    return Y


class TiledOnehotFunction(torch.autograd.Function):
    """``Y = A X`` through K7 (or its plain version), differentiable in
    ``vals`` and ``X`` (the JAX ``_spmm_tiled_ad_bwd``)."""

    @staticmethod
    def forward(ctx, vals, X, prep):
        ctx.save_for_backward(vals, X)
        ctx.prep = prep
        return _onehot(prep, X)

    @staticmethod
    def backward(ctx, G):
        vals, X = ctx.saved_tensors
        prep = ctx.prep
        K, N = X.shape
        nbr, Rt, cap, nbc = prep.nbr, prep.tiles_per_row, prep.tile_cap, \
            prep.nbc
        Gp = pad_rows(G, nbr * TILE)
        Xf = X.to(torch.float32)
        d_vals = torch.zeros(vals.shape, dtype=torch.float32,
                             device=X.device)
        d_Xp = torch.zeros((nbc * TILE + 1, N), dtype=torch.float32,
                           device=X.device)
        for sl in chunks(nbr, 4 * Rt * cap * N * 4):
            tc = prep.tcols[sl].long()
            valid = (tc < nbc)[:, :, None]
            gcol = tc.clamp(max=nbc - 1)[:, :, None] * TILE \
                + prep.cols[sl].long()
            brow = torch.arange(sl.start, sl.stop, device=X.device)
            grow = brow[:, None, None] * TILE + prep.rows[sl].long()
            gr = Gp[grow.reshape(-1)]
            xc = _gather_rows(Xf, gcol.reshape(-1))
            d_vals[sl] = (gr * xc).sum(-1).reshape(tc.shape + (cap,)) * valid
            w = (vals[sl].to(torch.float32) * valid).reshape(-1, 1)
            d_Xp.index_add_(0, gcol.reshape(-1), w * gr)
        return (d_vals.to(vals.dtype) if ctx.needs_input_grad[0] else None,
                d_Xp[:K].to(X.dtype) if ctx.needs_input_grad[1] else None,
                None)


def spmm_tiled_onehot(prep: PreparedTiledRows | SparseTiledCOO,
                      X: Tensor) -> Tensor:
    """``Y = A @ X`` (float32, ``(shape[0], N)``) through the entry layout;
    a :class:`SparseTiledCOO` is prepared on the fly. Differentiable in
    ``prep.vals`` and ``X``.

    CUDA tensors launch kernel K7 (``spmm_tiled_onehot.launches`` counts
    the launches); CPU tensors take :func:`spmm_tiled_onehot_reference`."""
    if isinstance(prep, SparseTiledCOO):
        prep = prepare_tiled_rows(prep)
    X = check_rhs(prep, X).to(torch.float32)
    if needs_grad(prep.vals, X):
        return TiledOnehotFunction.apply(prep.vals, X, prep)
    return _onehot(prep, X)


spmm_tiled_onehot.launches = 0


# --- K6: dense-block kernel -------------------------------------------------
def spmm_tiled_dense_reference(prep: PreparedTiledDense, X: Tensor) -> Tensor:
    """Plain PyTorch K6: per block-row chunk, gather each slot's X tile
    (zero for padding slots) and contract ``blocks @ X_tile`` over slots,
    in float32, with ``X`` rounded to the blocks' type first as the kernel
    takes it."""
    K, N = X.shape
    nbr, Rt = prep.nbr, prep.tiles_per_row
    Xf = X.to(prep.blocks.dtype).to(torch.float32)
    Y = torch.empty((nbr * TILE, N), dtype=torch.float32, device=X.device)
    for sl in chunks(nbr, Rt * TILE * (TILE + N) * 4 * 2):
        rows = tile_rows(prep.tcols[sl], prep.nbc, K)
        Xt = _gather_rows(Xf, rows.reshape(-1)).reshape(rows.shape + (N,))
        Y[sl.start * TILE: sl.stop * TILE] = torch.einsum(
            "btij,btjn->bin", prep.blocks[sl].to(torch.float32),
            Xt).reshape(-1, N)
    return Y[: prep.shape[0]]


def dense_vjp(tcols: Tensor, blocks: Tensor, X: Tensor, G: Tensor, nbc: int):
    """Cotangents ``(d_blocks, d_X)`` (float32) of
    ``Y_b = sum_t blocks[b,t] @ X_tile(tcols[b,t])`` for ``G (M, N)``: two
    batched tile products per block-row chunk and a tile-granular
    ``index_add_`` (the JAX ``_spmm_tiled_dense_ad_bwd``)."""
    K, N = X.shape
    nbr, Rt = tcols.shape
    g3 = pad_rows(G, nbr * TILE).reshape(nbr, TILE, N)
    Xf = X.to(torch.float32)
    d_blocks = torch.zeros(blocks.shape, dtype=torch.float32,
                           device=X.device)
    d_Xp = torch.zeros((nbc * TILE + 1, N), dtype=torch.float32,
                       device=X.device)
    for sl in chunks(nbr, 3 * Rt * TILE * (TILE + N) * 4):
        rows = tile_rows(tcols[sl], nbc, K)
        valid = (tcols[sl] < nbc)[:, :, None, None]
        Xt = _gather_rows(Xf, rows.reshape(-1)).reshape(rows.shape + (N,))
        d_blocks[sl] = torch.einsum("bin,btjn->btij", g3[sl], Xt) * valid
        bl = blocks[sl].to(torch.float32) * valid
        d_Xt = torch.einsum("btij,bin->btjn", bl, g3[sl])
        seg = torch.where(rows < K, rows, nbc * TILE)
        d_Xp.index_add_(0, seg.reshape(-1), d_Xt.reshape(-1, N))
    return d_blocks, d_Xp[:K]


class TiledDenseFunction(torch.autograd.Function):
    """``Y = A X`` over a dense-block layout through ``forward(prep, X)``
    (K6 or K5, or their plain versions), differentiable in ``blocks`` and
    ``X`` (``X`` in the blocks' type). The backward is :func:`dense_vjp` on
    ``prep.tcols``, which a window layout reconstructs from its table."""

    @staticmethod
    def forward(ctx, blocks, X, prep, forward):
        ctx.save_for_backward(blocks, X)
        ctx.prep = prep
        return forward(prep, X)

    @staticmethod
    def backward(ctx, G):
        blocks, X = ctx.saved_tensors
        d_blocks, d_X = dense_vjp(ctx.prep.tcols, blocks, X, G, ctx.prep.nbc)
        return (d_blocks.to(blocks.dtype) if ctx.needs_input_grad[0]
                else None,
                d_X.to(X.dtype) if ctx.needs_input_grad[1] else None, None,
                None)


def check_blocks(blocks: Tensor, what: str) -> int:
    """The kernel dtype code of contiguous float32/bfloat16 blocks."""
    if blocks.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} blocks must be float32 or bfloat16, got "
                        f"{blocks.dtype}")
    if blocks.ndim != 4 or tuple(blocks.shape[2:]) != (TILE, TILE) \
            or not blocks.is_contiguous():
        raise ValueError(f"{what} blocks must be contiguous (nbr, Rt, "
                         f"{TILE}, {TILE})")
    return _DTYPE_CODE[blocks.dtype]


def _dense(prep: PreparedTiledDense, X: Tensor) -> Tensor:
    """K6 on a CUDA ``X``, its plain version on a CPU ``X``."""
    if X.device.type == "cpu":
        return spmm_tiled_dense_reference(prep, X)
    M = prep.shape[0]
    K, N = X.shape
    Y = torch.empty((M, N), dtype=torch.float32, device=X.device)
    if M == 0 or N == 0:
        return Y
    code = check_blocks(prep.blocks, "PreparedTiledDense")
    if prep.tcols.dtype != torch.int32 or not prep.tcols.is_contiguous():
        raise ValueError("PreparedTiledDense.tcols must be contiguous int32")
    if prep.blocks.data_ptr() % 16:
        raise ValueError("PreparedTiledDense.blocks must be 16-byte aligned")
    lib = backend.load_kernels()
    err = lib.sps_tiled_dense(
        code, prep.tcols.data_ptr(), prep.blocks.data_ptr(), -(-M // TILE),
        prep.tiles_per_row, prep.nbc, X.data_ptr(), K, N, Y.data_ptr(), M,
        backend.current_stream(X.device))
    backend.check(err, "sps_tiled_dense")
    spmm_tiled_dense.launches += 1
    return Y


def spmm_tiled_dense(prep: PreparedTiledDense | SparseTiledCOO,
                     X: Tensor) -> Tensor:
    """``Y = A @ X`` (float32, ``(shape[0], N)``) through the dense-block
    layout; a :class:`SparseTiledCOO` is prepared on the fly in float32.
    ``X`` is cast to the blocks' type. Differentiable in ``prep.blocks`` and
    ``X``.

    CUDA tensors launch kernel K6 (``spmm_tiled_dense.launches`` counts
    the launches); CPU tensors take :func:`spmm_tiled_dense_reference`."""
    if isinstance(prep, SparseTiledCOO):
        prep = prepare_tiled_dense(prep)
    X = check_rhs(prep, X).to(prep.blocks.dtype)
    if needs_grad(prep.blocks, X):
        return TiledDenseFunction.apply(prep.blocks, X, prep, _dense)
    return _dense(prep, X)


spmm_tiled_dense.launches = 0

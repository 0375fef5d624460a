"""Tiled SpGEMM: sparse x sparse as products of dense 128x128 tiles, with
the pair kernels K9 and K13.

Counterpart of :mod:`spsparse_tpu.ops.spgemm_tiled`. Operand tiles are
matched on the contraction block index (host-side, pattern only), the
matching tile products are computed on the device and summed into the
sparse set of occupied output tiles:

    C = A @ B     pairs (ta, tb) with A.tile_col[ta] == B.tile_row[tb]
    C = A @ B^T   pairs (ta, tb) with A.tile_col[ta] == B.tile_col[tb]
    out tile of a pair: (A.tile_row, B.tile_col or B.tile_row)

* :class:`TiledBlocks` — a sparse pattern of dense blocks (flat layout);
  :func:`densify_tiled` builds it from a :class:`SparseTiledCOO` on the
  operand's device.
* :class:`TiledGemmPlan` / :func:`plan_tiled_spgemm` — the pair plan, host
  numpy, array for array the JAX package's (sentinel masking and the
  serpentine pair order included; the order also fixes the order in which
  each output tile sums its pairs). :func:`plan_pstart` gives each output
  tile's pair range.
* :func:`spgemm_tiled_pairs` (K9, ``sps_spgemm_pairs``) and
  :func:`spgemm_tiled_stream` (K13, ``sps_spgemm_pairs_stream``) compute
  the planned products on CUDA tensors (``spsparse_torch/csrc/spgemm.cu``:
  one ``cp.async`` ring, K9 one output tile a CTA, K13 persistent CTAs
  over pair-balanced tile ranges; each warp skips the chunks in which its
  share of a tile product is exactly zero); on CPU tensors both run the
  plain version :func:`spgemm_tiled_reference`
  (gathered pair tiles, a batched float32 product and an ``index_add_``
  into the output tiles, blocked to about 128 MB).
* :func:`tiled_blocks_to_coo` extracts the nonzero entries on the device.
* :func:`spgemm_tiled` — the eager ``A @ B^(T?)``: ``A @ B^T`` products
  whose pair structure is block-banded go through the band kernel K8
  (:mod:`.spgemm_window`), the rest through K9.

f32 tiles multiply in true float32 (the JAX package's ``HIGHEST``
precision), and K8, K9 and K13 sum each f32 output element in one order
(pairs in plan order, k ascending), so K9 and K13 agree bit for bit; bf16
tiles multiply on the tensor cores, exact products summed in float32. The
operand's device decides between kernel and plain version, as everywhere in
the port, so there is no ``use_pallas`` or ``interpret``; ``use_window``
stays, since it chooses between two kernels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import backend
from ..core.coo import SparseCOO, default_index_dtype, round_up_pow2
from ..core.errors import SpSparseError
from ..core.tiled import TILE, SparseTiledCOO, to_tiled
from ..utils.trace import trace_scope
from .tiled_ops import chunks
from .tiled_spmm import (PreparedTiledDense, _DTYPE_CODE,
                         prepare_tiled_dense)

__all__ = ["TiledBlocks", "densify_tiled", "TiledGemmPlan",
           "plan_tiled_spgemm", "plan_pstart", "spgemm_tiled_reference",
           "spgemm_tiled_pairs", "spgemm_tiled_stream", "spgemm_tiled",
           "tiled_blocks_to_coo"]

Tensor = torch.Tensor

_TILE_ELEMS = TILE * TILE


@dataclasses.dataclass(frozen=True)
class TiledBlocks:
    """Sparse pattern of dense 128x128 blocks (flat layout).

    ``tile_row/tile_col (T,)`` int32 block coordinates; ``blocks (T, 128,
    128)`` float32 or bfloat16 (zero outside the stored entries and outside
    ``shape``). All ``T`` blocks are live, except that an EMPTY input is one
    zero block at sentinel coordinates (the block extents), which every
    consumer drops."""

    tile_row: Tensor
    tile_col: Tensor
    blocks: Tensor
    shape: tuple

    @property
    def n_tiles(self) -> int:
        return self.blocks.shape[0]

    @property
    def nbrows(self) -> int:
        return -(-self.shape[0] // TILE)

    @property
    def nbcols(self) -> int:
        return -(-self.shape[1] // TILE)

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def to_dense(self) -> Tensor:
        """The dense ``shape`` matrix (float32); blocks at sentinel
        coordinates are dropped, blocks at one coordinate sum."""
        nbr, nbc = self.nbrows, self.nbcols
        tr, tc = self.tile_row.long(), self.tile_col.long()
        live = (tr < nbr) & (tc < nbc)
        dense = torch.zeros((nbr, nbc, TILE, TILE), dtype=torch.float32,
                            device=self.device)
        dense.index_put_((tr[live], tc[live]),
                         self.blocks[live].to(torch.float32), accumulate=True)
        dense = dense.transpose(1, 2).reshape(nbr * TILE, nbc * TILE)
        return dense[: self.shape[0], : self.shape[1]]

    def to_prepared_dense(self, dtype=None) -> PreparedTiledDense:
        """Row-grouped layout for the dense-block SpMM kernel K6 (on the
        blocks' device), so that a SpGEMM result feeds ``Y = C @ X``
        without a COO round trip. ``dtype`` casts the blocks."""
        nbr, nbc = self.nbrows, self.nbcols
        dev = self.device
        tr = self.tile_row.long()
        live = tr < nbr
        counts = torch.bincount(tr[live], minlength=nbr)
        Rt = max(int(counts.max()) if counts.numel() else 1, 1)
        est = nbr * Rt * _TILE_ELEMS * self.blocks.element_size()
        if est > 8 << 30:
            raise SpSparseError(
                f"to_prepared_dense would materialize {est >> 30} GiB of "
                f"row-grouped blocks (nbr x Rt = {nbr} x {Rt}); extract "
                "to COO and use the one-hot kernel for such layouts")
        # Group live tiles by block row with one stable sort; a tile's slot
        # is its position minus the start of its block row's run.
        order = torch.sort(torch.where(live, tr, nbr), stable=True).indices
        order = order[: int(live.sum())]
        trs = tr[order]
        slot = torch.arange(trs.numel(), device=dev) \
            - (torch.cumsum(counts, 0) - counts)[trs]
        tcols = torch.full((nbr, Rt), nbc, dtype=torch.int32, device=dev)
        tcols[trs, slot] = self.tile_col[order].to(torch.int32)
        out = torch.zeros((nbr, Rt, TILE, TILE), dtype=self.blocks.dtype,
                          device=dev)
        out[trs, slot] = self.blocks[order]
        if dtype is not None:
            out = out.to(dtype)
        return PreparedTiledDense(tcols=tcols, blocks=out, shape=self.shape)


def densify_tiled(tl: SparseTiledCOO, *, dtype=torch.float32) -> TiledBlocks:
    """``SparseTiledCOO`` -> flat dense blocks on its device: one float32
    ``index_add_`` of the entries (duplicate offsets sum, as under
    consolidate(ADD)), then a cast to ``dtype``. An empty input gives one
    zero block at sentinel coordinates."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"densify_tiled: dtype must be float32 or bfloat16, "
                         f"got {dtype}")
    nt = tl.n_tiles
    dev = tl.device
    blocks = torch.zeros(max(nt, 1) * _TILE_ELEMS, dtype=torch.float32,
                         device=dev)
    vals = tl.vals[:nt]
    live = vals != 0
    flat = ((torch.arange(nt, device=dev)[:, None] * TILE
             + tl.rows[:nt].long()) * TILE + tl.cols[:nt].long())
    blocks.index_add_(0, flat[live], vals[live])
    if nt:
        tr, tc = tl.tile_row[:nt], tl.tile_col[:nt]
    else:
        tr = torch.tensor([tl.nbrows], dtype=torch.int32, device=dev)
        tc = torch.tensor([tl.nbcols], dtype=torch.int32, device=dev)
    return TiledBlocks(tile_row=tr.to(torch.int32), tile_col=tc.to(torch.int32),
                       blocks=blocks.reshape(-1, TILE, TILE).to(dtype),
                       shape=tl.shape)


@dataclasses.dataclass(frozen=True)
class TiledGemmPlan:
    """Pair plan of a tiled SpGEMM (host numpy, pattern only).

    ``pa/pb (P,)`` int32 operand block indices, ``oid (P,)`` int32 output
    block of each pair (pairs grouped by ``oid``, serpentine order within a
    group), ``out_tile_row/out_tile_col (T_out,)`` int32 output block
    coordinates (row-major sorted), ``transpose_b`` the contraction mode,
    ``out_shape`` the result extents. :meth:`tensors` caches the arrays on
    a device for the kernels."""

    pa: np.ndarray
    pb: np.ndarray
    oid: np.ndarray
    out_tile_row: np.ndarray
    out_tile_col: np.ndarray
    transpose_b: bool
    out_shape: tuple
    _tensors: dict = dataclasses.field(default_factory=dict, init=False,
                                       repr=False, compare=False)

    @property
    def n_pairs(self) -> int:
        return self.pa.shape[0]

    @property
    def n_out_tiles(self) -> int:
        return self.out_tile_row.shape[0]

    def tensors(self, device) -> dict:
        """``pa``, ``pb``, ``oid``, ``pstart``, ``out_tile_row`` and
        ``out_tile_col`` as int32 tensors on ``device``, copied once."""
        key = str(torch.device(device))
        if key not in self._tensors:
            arrays = {k: getattr(self, k) for k in (
                "pa", "pb", "oid", "out_tile_row", "out_tile_col")}
            arrays["pstart"] = plan_pstart(self)
            self._tensors[key] = {
                k: torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(
                    device) for k, v in arrays.items()}
        return self._tensors[key]


def plan_tiled_spgemm(A: TiledBlocks, B: TiledBlocks, *,
                      transpose_b: bool = False) -> TiledGemmPlan:
    """Host-side pair matching on the tile pattern (one plan serves any
    number of value updates). Raises :class:`SpSparseError` on an inner
    dimension mismatch."""
    atr = A.tile_row.cpu().numpy().astype(np.int64)
    atc = A.tile_col.cpu().numpy().astype(np.int64)
    btr = B.tile_row.cpu().numpy().astype(np.int64)
    btc = B.tile_col.cpu().numpy().astype(np.int64)
    if transpose_b:
        k_b, j_b = btc, btr
        inner_a, inner_b = A.shape[1], B.shape[1]
        out_shape = (A.shape[0], B.shape[0])
    else:
        k_b, j_b = btr, btc
        inner_a, inner_b = A.shape[1], B.shape[0]
        out_shape = (A.shape[0], B.shape[1])
    if inner_a != inner_b:
        raise SpSparseError(
            f"inner dimension mismatch: {inner_a} vs {inner_b} "
            "(reference raises via spsparse_error, "
            "multiply_sparse.hpp:172-174)")

    # Match A.tile_col == k_b by sort + searchsorted. Sentinel-coordinate
    # tiles (densify_tiled's empty filler) never pair, not even with each
    # other: they get distinct out-of-range keys on the two sides.
    nb_inner = -(-inner_a // TILE)
    atc = np.where(atc < nb_inner, atc, nb_inner + 1)
    k_b = np.where(k_b < nb_inner, k_b, nb_inner + 2)
    order_b = np.argsort(k_b, kind="stable")
    kb_s = k_b[order_b]
    lo = np.searchsorted(kb_s, atc, side="left")
    hi = np.searchsorted(kb_s, atc, side="right")
    cnt = hi - lo
    pa = np.repeat(np.arange(atr.shape[0]), cnt)
    if pa.size:
        within = np.arange(pa.size) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        pb = order_b[np.repeat(lo, cnt) + within]
    else:
        pb = np.zeros(0, np.int64)

    nbc_out = -(-out_shape[1] // TILE)
    out_key = atr[pa] * nbc_out + j_b[pb]
    order = np.argsort(out_key, kind="stable")
    pa, pb, out_key = pa[order], pb[order], out_key[order]
    uniq, oid = np.unique(out_key, return_inverse=True)
    # Serpentine order within each output tile's group (even groups ascend
    # by pa, odd groups descend), as the JAX package plans it: the boundary
    # pair of two groups often shares its A tile.
    if pa.size:
        pa_max = int(pa.max(initial=0)) + 1
        within = np.where(oid % 2 == 1, pa_max - 1 - pa, pa)
        sorder = np.lexsort((within, oid))
        pa, pb, oid = pa[sorder], pb[sorder], oid[sorder]
    return TiledGemmPlan(
        pa=pa.astype(np.int32), pb=pb.astype(np.int32),
        oid=oid.astype(np.int32),
        out_tile_row=(uniq // nbc_out).astype(np.int32),
        out_tile_col=(uniq % nbc_out).astype(np.int32),
        transpose_b=transpose_b, out_shape=out_shape)


def plan_pstart(plan: TiledGemmPlan) -> np.ndarray:
    """Per-output-tile pair ranges: ``pstart[t] .. pstart[t+1]`` are the
    pairs of output tile ``t`` (int32, ``T_out + 1``)."""
    return np.searchsorted(plan.oid,
                           np.arange(plan.n_out_tiles + 1)).astype(np.int32)


def _empty_result(plan: TiledGemmPlan, device) -> TiledBlocks:
    """No pairs: one zero block at sentinel coordinates."""
    return TiledBlocks(
        tile_row=torch.tensor([-(-plan.out_shape[0] // TILE)],
                              dtype=torch.int32, device=device),
        tile_col=torch.tensor([-(-plan.out_shape[1] // TILE)],
                              dtype=torch.int32, device=device),
        blocks=torch.zeros((1, TILE, TILE), dtype=torch.float32,
                           device=device),
        shape=plan.out_shape)


def _result(plan: TiledGemmPlan, out: Tensor) -> TiledBlocks:
    t = plan.tensors(out.device)
    return TiledBlocks(tile_row=t["out_tile_row"], tile_col=t["out_tile_col"],
                       blocks=out, shape=plan.out_shape)


def spgemm_tiled_reference(A: TiledBlocks, B: TiledBlocks,
                           plan: TiledGemmPlan) -> TiledBlocks:
    """Plain PyTorch K9/K13: per chunk of pairs, gather the pair tiles, one
    batched float32 product, ``index_add_`` into the output tiles."""
    dev = A.device
    if plan.n_pairs == 0:
        return _empty_result(plan, dev)
    t = plan.tensors(dev)
    pa, pb, oid = t["pa"].long(), t["pb"].long(), t["oid"].long()
    out = torch.zeros((plan.n_out_tiles, TILE, TILE), dtype=torch.float32,
                      device=dev)
    for sl in chunks(plan.n_pairs, 3 * _TILE_ELEMS * 4):
        a = A.blocks[pa[sl]].to(torch.float32)
        b = B.blocks[pb[sl]].to(torch.float32)
        out.index_add_(0, oid[sl],
                       a @ (b.transpose(1, 2) if plan.transpose_b else b))
    return _result(plan, out)


def _launch(name: str, A: TiledBlocks, B: TiledBlocks,
            plan: TiledGemmPlan) -> Tensor:
    """The planned products by kernel ``name`` (CUDA operands)."""
    if A.device != B.device:
        raise ValueError(f"operands on {A.device} and {B.device}")
    for what, blocks in (("A", A.blocks), ("B", B.blocks)):
        if blocks.dtype not in _DTYPE_CODE:
            raise TypeError(f"{what} blocks must be float32 or bfloat16, got "
                            f"{blocks.dtype}")
        if blocks.ndim != 3 or tuple(blocks.shape[1:]) != (TILE, TILE) \
                or not blocks.is_contiguous() or blocks.data_ptr() % 16:
            raise ValueError(f"{what} blocks must be contiguous, 16-byte "
                             f"aligned (T, {TILE}, {TILE})")
    if A.blocks.dtype != B.blocks.dtype:
        raise TypeError(f"operand blocks differ in type: {A.blocks.dtype} "
                        f"and {B.blocks.dtype}")
    t = plan.tensors(A.device)
    out = torch.empty((plan.n_out_tiles, TILE, TILE), dtype=torch.float32,
                      device=A.device)
    err = getattr(backend.load_kernels(), name)(
        _DTYPE_CODE[A.blocks.dtype], int(plan.transpose_b),
        A.blocks.data_ptr(), B.blocks.data_ptr(), t["pa"].data_ptr(),
        t["pb"].data_ptr(), t["pstart"].data_ptr(), plan.n_out_tiles,
        out.data_ptr(), backend.current_stream(A.device))
    backend.check(err, name)
    return out


def spgemm_tiled_pairs(A: TiledBlocks, B: TiledBlocks,
                       plan: TiledGemmPlan) -> TiledBlocks:
    """The planned products, one output tile per CTA, its pairs streamed
    through a ``cp.async`` ring and the tile written once (float32
    :class:`TiledBlocks` over the plan's output tiles).

    CUDA tensors launch kernel K9 (``spgemm_tiled_pairs.launches`` counts
    the launches); CPU tensors take :func:`spgemm_tiled_reference`. An
    empty plan launches nothing and gives the sentinel filler block."""
    if plan.n_pairs == 0:
        return _empty_result(plan, A.device)
    if A.device.type == "cpu":
        return spgemm_tiled_reference(A, B, plan)
    out = _launch("sps_spgemm_pairs", A, B, plan)
    spgemm_tiled_pairs.launches += 1
    return _result(plan, out)


spgemm_tiled_pairs.launches = 0


def spgemm_tiled_stream(A: TiledBlocks, B: TiledBlocks,
                        plan: TiledGemmPlan) -> TiledBlocks:
    """:func:`spgemm_tiled_pairs`'s function through kernel K13: persistent
    CTAs, each over a range of output tiles balanced by pair count, stream
    the pairs through a ``cp.async`` ring across tile boundaries; bf16 runs
    on the tensor cores (``spgemm_tiled_stream.launches`` counts its
    launches). CPU tensors take :func:`spgemm_tiled_reference`. Nothing routes to it: like the JAX
    ``_spgemm_tiled_pallas_v2``, it is kept to be measured against K9."""
    if plan.n_pairs == 0:
        return _empty_result(plan, A.device)
    if A.device.type == "cpu":
        return spgemm_tiled_reference(A, B, plan)
    out = _launch("sps_spgemm_pairs_stream", A, B, plan)
    spgemm_tiled_stream.launches += 1
    return _result(plan, out)


spgemm_tiled_stream.launches = 0


def tiled_blocks_to_coo(tb: TiledBlocks, *,
                        cap: int | None = None) -> SparseCOO:
    """Nonzero entries of a block-tiled result as an (unsorted) COO on the
    blocks' device, in ascending flat position (block, row, column).

    Exact zeros are dropped (the reference does not emit zero products,
    ``multiply_sparse.hpp:238-243``). ``cap`` is the output capacity, by
    default the power of two above the nonzero count; ``nnz`` is clamped to
    it and the rest is sentinel padding."""
    flat = tb.blocks.to(torch.float32).reshape(-1)
    pos = torch.nonzero(flat).squeeze(1)
    if cap is None:
        cap = round_up_pow2(max(pos.numel(), 1))
    nnz = min(pos.numel(), int(cap))
    pos = pos[:nnz]
    t = pos // _TILE_ELEMS
    rc = pos % _TILE_ELEMS
    idx_dtype = default_index_dtype(tb.shape)
    indices = torch.tensor([int(s) for s in tb.shape], dtype=idx_dtype,
                           device=tb.device).repeat(cap, 1)
    indices[:nnz, 0] = (tb.tile_row.long()[t] * TILE + rc // TILE).to(
        idx_dtype)
    indices[:nnz, 1] = (tb.tile_col.long()[t] * TILE + rc % TILE).to(
        idx_dtype)
    vals = torch.zeros(cap, dtype=torch.float32, device=tb.device)
    vals[:nnz] = flat[pos]
    return SparseCOO(indices=indices, vals=vals, nnz=nnz, shape=tb.shape)


def spgemm_tiled(A: SparseCOO, B: SparseCOO, *, transpose_b: bool = False,
                 dtype=torch.float32, cap: int | None = None,
                 use_window: bool | None = None) -> SparseCOO:
    """``C = A @ B^(T?)`` through the tiled kernels (eager): tiling,
    densification and planning on the host and the operands' device, the
    tile products in K8 or K9 (their plain versions on CPU tensors). The
    result is an unsorted COO with zeros dropped; ``.consolidate()`` sorts
    it.

    ``A @ B^T`` products whose pair structure is block-banded go through
    the band kernel K8 (:func:`spsparse_torch.ops.spgemm_window.
    spgemm_window`); a plan that is not banded (``plan_window_spgemm``
    raises :class:`SpSparseError`) takes K9. ``use_window`` defaults to
    ``transpose_b``, the JAX package's route on its kernel path;
    ``use_window=False`` takes K9. The route is chosen before any launch,
    and an error of a launch raises. With the host event log on
    (:func:`spsparse_torch.utils.trace.enable_event_log`) each call records
    its route, ``"window"`` or ``"pairs"``."""
    from .spgemm_window import (band_to_tiled_blocks, plan_window_spgemm,
                                spgemm_window)

    if use_window is None:
        use_window = transpose_b
    plan = None
    if use_window and transpose_b:
        try:
            pa_ = prepare_tiled_dense(to_tiled(A), dtype=dtype)
            pb_ = pa_ if B is A else prepare_tiled_dense(to_tiled(B),
                                                         dtype=dtype)
            plan = plan_window_spgemm(
                pa_.tcols, pb_.tcols, nbc=pa_.nbc,
                out_shape=(A.shape[0], B.shape[0]), dtype=dtype,
                shared=pa_ is pb_)
        except SpSparseError:
            plan = None     # not banded (or over the layout guard): K9
    if plan is not None:
        with trace_scope("spsparse.spgemm_tiled", route="window"):
            band = spgemm_window(plan, pa_.blocks,
                                 None if plan.shared else pb_.blocks)
            return tiled_blocks_to_coo(band_to_tiled_blocks(band, plan),
                                       cap=cap)
    with trace_scope("spsparse.spgemm_tiled", route="pairs"):
        ta = densify_tiled(to_tiled(A), dtype=dtype)
        tbk = densify_tiled(to_tiled(B), dtype=dtype)
        pplan = plan_tiled_spgemm(ta, tbk, transpose_b=transpose_b)
        return tiled_blocks_to_coo(spgemm_tiled_pairs(ta, tbk, pplan),
                                   cap=cap)

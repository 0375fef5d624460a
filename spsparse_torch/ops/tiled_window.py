"""Dense-block tiled SpMM with super-row X windows: kernel K5.

Counterpart of :mod:`spsparse_tpu.ops.pallas_tiled_window`
(``spmm_tiled_window_pallas``, the Pallas kernel ``_window_kernel``). The
layout is the dense-block layout of :mod:`spsparse_torch.ops.tiled_spmm`
plus a window table: ``group`` consecutive block rows form a super-row
that shares one X column window ``[wstart, wstart + ws)`` (in 128-column
blocks), and each slot stores its tile's offset in the window (-1 =
padding). On the TPU the window is copied once per super-row into VMEM.
On Hopper a window (about 2.2 MB at bench config 3) does not fit shared
memory; the kernel ``sps_tiled_window`` (``spsparse_torch/csrc/
tiled_window.cu``) runs the block rows of a super-row together so that
the window's X tiles are read from the L2 cache, and reads the table as it
is.

On CUDA tensors :func:`spmm_tiled_window` launches K5; on CPU tensors it
runs the plain version :func:`spmm_tiled_window_reference`. Unlike the JAX
package it never delegates to the per-tile kernel at call time: the port's
K5 has no scratch budget and runs at every RHS width. The prepare-time
span check (:data:`_WINDOW_VMEM_BUDGET`) stays, so that
:func:`spsparse_torch.ops.prepare_general` picks the same layout as the JAX
package. Autograd is K6's :class:`TiledDenseFunction` on the tile columns
reconstructed from the window table (:attr:`PreparedTiledWindow.tcols`),
as the JAX ``_window_ad_bwd`` does.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import backend
from ..core.errors import SpSparseError
from ..core.tiled import TILE, SparseTiledCOO
from .tiled_spmm import (PreparedTiledDense, TiledDenseFunction,
                         check_blocks, check_rhs, needs_grad,
                         prepare_tiled_dense, spmm_tiled_dense_reference)

__all__ = ["PreparedTiledWindow", "prepare_tiled_window", "to_tiled_dense",
           "spmm_tiled_window", "spmm_tiled_window_reference"]

Tensor = torch.Tensor

# Double-buffered X-window budget of the TPU kernel's VMEM scratch. It is a
# TPU limit, kept only as the span check that decides window against dense
# blocks in prepare_general, so that both packages route a matrix alike.
# Re-deriving the choice on the H100 is ROADMAP item 14.
_WINDOW_VMEM_BUDGET = 8 << 20


@dataclasses.dataclass(frozen=True)
class PreparedTiledWindow:
    """Row-grouped dense blocks plus a per-super-row window table.

    ``offs (nbr_pad*Rt,)`` int32: a slot's column-block offset within its
    super-row window (-1 = padding); ``wstart (nsuper,)`` int32 window
    starts in column blocks; ``blocks (nbr_pad, Rt, 128, 128)`` with
    ``nbr_pad`` a whole number of super-rows."""

    wstart: Tensor
    offs: Tensor
    blocks: Tensor
    shape: tuple
    group: int
    ws: int

    @property
    def nbr(self) -> int:
        return self.blocks.shape[0]

    @property
    def tiles_per_row(self) -> int:
        return self.blocks.shape[1]

    @property
    def nbc(self) -> int:
        return -(-self.shape[1] // TILE)

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @property
    def tcols(self) -> Tensor:
        """Global tile columns ``(nbr_pad, Rt)`` int32 (sentinel nbc on
        padding slots), reconstructed from the window table."""
        nbr, Rt = self.nbr, self.tiles_per_row
        o2 = self.offs.reshape(nbr, Rt)
        base = self.wstart[torch.arange(nbr, device=o2.device) // self.group]
        return torch.where(o2 >= 0, o2 + base[:, None],
                           self.nbc).to(torch.int32)


def prepare_tiled_window(tl: SparseTiledCOO, *, group: int = 16,
                         dtype=torch.bfloat16, n_cols_rhs: int = TILE,
                         host_limit_bytes: int = 8 << 30
                         ) -> PreparedTiledWindow:
    """Build the window layout (on the operand's device). Raises
    :class:`SpSparseError` when a super-row's column span times the RHS
    width ``n_cols_rhs`` exceeds the window budget; callers then take the
    per-tile dense layout (:func:`prepare_tiled_dense`)."""
    base = prepare_tiled_dense(tl, dtype=dtype,
                               host_limit_bytes=host_limit_bytes)
    nbr, Rt = base.tcols.shape
    nbc = base.nbc
    dev = base.device
    nsuper = -(-nbr // group)
    pad_rows = nsuper * group - nbr
    tcols = torch.cat([base.tcols, torch.full((pad_rows, Rt), nbc,
                                              dtype=torch.int32,
                                              device=dev)])
    g = tcols.reshape(nsuper, group * Rt).long()
    live = g < nbc
    any_live = live.any(dim=1)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    lo = torch.where(any_live, torch.where(live, g, nbc).amin(dim=1), zero)
    hi = torch.where(any_live, torch.where(live, g, -1).amax(dim=1), zero)
    span = torch.where(any_live, hi - lo + 1, 1)
    ws = max(int(span.max()) if span.numel() else 1, 1)
    esize = torch.empty((), dtype=dtype).element_size()
    np_rhs = -(-int(n_cols_rhs) // TILE) * TILE
    if 2 * ws * TILE * np_rhs * esize > _WINDOW_VMEM_BUDGET:
        raise SpSparseError(
            f"prepare_tiled_window: window span {ws} column blocks x RHS "
            f"width {np_rhs} exceeds the window budget; use the per-tile "
            "dense kernel")
    # Clamp window starts so that the whole window stays inside X; a
    # slot's offset is its tile column minus its super-row's start.
    wstart = torch.clamp(lo, max=max(nbc - ws, 0))
    super_of = torch.arange(nsuper * group, device=dev) // group
    offs = torch.where(tcols < nbc, tcols - wstart[super_of][:, None], -1)
    blocks = base.blocks
    if pad_rows:
        blocks = torch.cat([blocks, blocks.new_zeros(
            (pad_rows,) + tuple(blocks.shape[1:]))])
    return PreparedTiledWindow(
        wstart=wstart.to(torch.int32), offs=offs.to(torch.int32).reshape(-1),
        blocks=blocks, shape=tl.shape, group=group, ws=ws)


def to_tiled_dense(prep: PreparedTiledWindow) -> PreparedTiledDense:
    """The per-tile dense layout of a window layout (the same blocks; the
    tile columns reconstructed from the window table)."""
    return PreparedTiledDense(tcols=prep.tcols, blocks=prep.blocks,
                              shape=prep.shape)


def spmm_tiled_window_reference(prep: PreparedTiledWindow,
                                X: Tensor) -> Tensor:
    """Plain PyTorch K5: K6's plain version on the reconstructed tile
    columns (the same sum over the same slots)."""
    return spmm_tiled_dense_reference(to_tiled_dense(prep), X)


def _window(prep: PreparedTiledWindow, X: Tensor) -> Tensor:
    """K5 on a CUDA ``X``, its plain version on a CPU ``X``."""
    if X.device.type == "cpu":
        return spmm_tiled_window_reference(prep, X)
    M = prep.shape[0]
    K, N = X.shape
    Y = torch.empty((M, N), dtype=torch.float32, device=X.device)
    if M == 0 or N == 0:
        return Y
    code = check_blocks(prep.blocks, "PreparedTiledWindow")
    for name in ("wstart", "offs"):
        t = getattr(prep, name)
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"PreparedTiledWindow.{name} must be "
                             "contiguous int32")
    lib = backend.load_kernels()
    err = lib.sps_tiled_window(
        code, prep.wstart.data_ptr(), prep.offs.data_ptr(),
        prep.blocks.data_ptr(), -(-M // TILE), prep.tiles_per_row,
        prep.group, X.data_ptr(), K, N, Y.data_ptr(), M,
        backend.current_stream(X.device))
    backend.check(err, "sps_tiled_window")
    spmm_tiled_window.launches += 1
    return Y


def spmm_tiled_window(prep: PreparedTiledWindow, X: Tensor) -> Tensor:
    """``Y = A @ X`` (float32, ``(shape[0], N)``) through the window
    layout; ``X`` is cast to the blocks' type. Differentiable in
    ``prep.blocks`` and ``X``.

    CUDA tensors launch kernel K5 (``spmm_tiled_window.launches`` counts
    the launches); CPU tensors take :func:`spmm_tiled_window_reference`."""
    X = check_rhs(prep, X).to(prep.blocks.dtype)
    if needs_grad(prep.blocks, X):
        return TiledDenseFunction.apply(prep.blocks, X, prep, _window)
    return _window(prep, X)


spmm_tiled_window.launches = 0

"""Hand state between the JAX package and the port as numpy arrays.

The parity tests feed the same arrays to both packages through these
functions; they also move saved state across. Nothing here imports JAX:
the JAX side is plain numpy (``np.asarray`` of a JAX array).

* :func:`coo_from_numpy` / :func:`coo_to_numpy` — the padded
  ``SparseCOO`` container, field for field (padding and capacity kept).
* :func:`dia_from_numpy` / :func:`dia_to_numpy` — ``SparseDIA``.
* :func:`prepared_dia_from_jax` — un-blocks either kernel layout of the JAX
  ``PreparedDIA.data3`` (packed f32 ``(nblocks, K*block)`` or padded bf16
  ``(nblocks, K_pad, block)``) into the port's ``(K, n)`` layout.
* :func:`tiled_from_jax`, :func:`bsr_from_jax`,
  :func:`prepared_tiled_rows_from_jax`, :func:`prepared_tiled_dense_from_jax`,
  :func:`prepared_tiled_window_from_jax` and
  :func:`prepared_general_from_jax` — the tiled and general layouts. The
  port keeps the JAX package's arrays as they are, so these copy field for
  field (the live counts become Python ints); they take the JAX objects
  and read each field with ``np.asarray``.
* :func:`prepared_shuffle_from_jax` — the unstructured SpMV's shuffle
  layout, field for field (the port's arrays are the JAX package's), plus
  the slot-order arrays kernel K11 reads, rebuilt from the gather batches.
* :func:`tiled_blocks_from_jax`, :func:`tiled_gemm_plan_from_jax`,
  :func:`window_gemm_plan_from_jax` and :func:`esc_plan_from_jax` — the
  SpGEMM blocks and plans, field for field (the tiled and window plans are
  host numpy in both packages).

Host arrays go to ``device``, the card by default
(:func:`spsparse_torch.default_device`); the CPU tests pass
``device="cpu"``.

bfloat16 arrays from JAX are numpy arrays of the ``ml_dtypes`` bfloat16
type; they are moved bit for bit. On the way back bfloat16 tensors become
float32 numpy arrays, which hold every bfloat16 value exactly.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .core.bsr import SparseBSR
from .core.coo import SparseCOO
from .core.device import resolve_device
from .core.dia import SparseDIA
from .core.tiled import SparseTiledCOO
from .ops.dia_stream import PreparedDIA
from .ops.general import PreparedGather, PreparedGatherEll, PreparedGeneral
from .ops.spgemm_planned import EscPlan
from .ops.spgemm_tiled import TiledBlocks, TiledGemmPlan
from .ops.spgemm_window import WindowGemmPlan
from .ops.spmv_shuffle import PreparedShuffleSpMV, slot_order_of_batches
from .ops.tiled_spmm import PreparedTiledDense, PreparedTiledRows
from .ops.tiled_window import PreparedTiledWindow

__all__ = ["coo_from_numpy", "coo_to_numpy", "dia_from_numpy",
           "dia_to_numpy", "prepared_dia_from_jax", "tensor_from_numpy",
           "tensor_to_numpy", "tiled_from_jax", "bsr_from_jax",
           "prepared_tiled_rows_from_jax", "prepared_tiled_dense_from_jax",
           "prepared_tiled_window_from_jax", "prepared_general_from_jax",
           "tiled_blocks_from_jax", "tiled_gemm_plan_from_jax",
           "window_gemm_plan_from_jax", "esc_plan_from_jax",
           "prepared_shuffle_from_jax"]

Tensor = torch.Tensor


def tensor_from_numpy(a, device=None) -> Tensor:
    """numpy → tensor on ``device`` (the card by default), bfloat16 kept
    bit for bit."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:        # e.g. a view of a JAX array
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def tensor_to_numpy(t: Tensor) -> np.ndarray:
    """tensor → host numpy (bfloat16 widened to float32)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def coo_from_numpy(indices, vals, nnz: int, shape: Sequence[int],
                   sort_order: Sequence[int] | None = None, *,
                   device=None) -> SparseCOO:
    """A :class:`SparseCOO` holding exactly these buffers."""
    return SparseCOO(
        indices=tensor_from_numpy(indices, device),
        vals=tensor_from_numpy(vals, device), nnz=int(nnz),
        shape=tuple(int(s) for s in shape),
        sort_order=(tuple(int(d) for d in sort_order)
                    if sort_order is not None else None))


def coo_to_numpy(a: SparseCOO) -> tuple:
    """``(indices, vals, nnz, shape, sort_order)`` with numpy buffers."""
    return (tensor_to_numpy(a.indices), tensor_to_numpy(a.vals), int(a.nnz),
            tuple(a.shape), a.sort_order)


def dia_from_numpy(data, offsets: Sequence[int], shape: Sequence[int], *,
                   device=None) -> SparseDIA:
    return SparseDIA(data=tensor_from_numpy(data, device),
                     offsets=tuple(int(o) for o in offsets),
                     shape=tuple(int(s) for s in shape))


def dia_to_numpy(dia) -> tuple:
    """``(data, offsets, shape)`` of a :class:`SparseDIA` or
    :class:`PreparedDIA`."""
    return tensor_to_numpy(dia.data), tuple(dia.offsets), tuple(dia.shape)


def prepared_dia_from_jax(data3, offsets: Sequence[int],
                          shape: Sequence[int], block: int, *,
                          device=None) -> PreparedDIA:
    """The port's :class:`PreparedDIA` from a JAX ``PreparedDIA.data3``
    (the inverse of the JAX ``prepare_dia`` re-blocking). Padding diagonals
    and padding rows are dropped; the dtype is kept."""
    data3 = np.asarray(data3)
    n = int(shape[0])
    K = len(offsets)
    nblocks = data3.shape[0]
    if data3.ndim == 2:                      # packed f32: (nblocks, K*block)
        d3 = data3.reshape(nblocks, data3.shape[1] // block, block)
    else:                                    # padded: (nblocks, K_pad, block)
        d3 = data3
    data = d3.swapaxes(0, 1).reshape(d3.shape[1], nblocks * block)[:K, :n]
    return PreparedDIA(data=tensor_from_numpy(data, device),
                       offsets=tuple(int(o) for o in offsets),
                       shape=tuple(int(s) for s in shape))


def _fields(obj, names, device) -> dict:
    return {k: tensor_from_numpy(np.asarray(getattr(obj, k)), device)
            for k in names}


def _shape(obj) -> tuple:
    return tuple(int(s) for s in obj.shape)


def tiled_from_jax(tl, *, device=None) -> SparseTiledCOO:
    """The port's :class:`SparseTiledCOO` holding a JAX ``SparseTiledCOO``'s
    arrays."""
    return SparseTiledCOO(
        **_fields(tl, ("tile_row", "tile_col", "rows", "cols", "vals"),
                  device),
        n_tiles=int(np.asarray(tl.n_tiles)), shape=_shape(tl))


def bsr_from_jax(bsr, *, device=None) -> SparseBSR:
    """The port's :class:`SparseBSR` holding a JAX ``SparseBSR``'s arrays."""
    return SparseBSR(**_fields(bsr, ("row_ptr", "bcols", "blocks"), device),
                     nnz_blocks=int(np.asarray(bsr.nnz_blocks)),
                     shape=_shape(bsr))


def prepared_tiled_rows_from_jax(prep, *, device=None) -> PreparedTiledRows:
    return PreparedTiledRows(
        **_fields(prep, ("tcols", "rows", "cols", "vals"), device),
        shape=_shape(prep))


def prepared_tiled_dense_from_jax(prep, *, device=None) -> PreparedTiledDense:
    return PreparedTiledDense(**_fields(prep, ("tcols", "blocks"), device),
                              shape=_shape(prep))


def prepared_tiled_window_from_jax(prep, *,
                                   device=None) -> PreparedTiledWindow:
    return PreparedTiledWindow(
        **_fields(prep, ("wstart", "offs", "blocks"), device),
        shape=_shape(prep), group=int(prep.group), ws=int(prep.ws))


def prepared_general_from_jax(pg, *, device=None) -> PreparedGeneral:
    """The port's :class:`PreparedGeneral` from a JAX one: the layout by
    its type name, ``order`` as an int64 tensor (or None)."""
    inner = pg.prep
    kind = type(inner).__name__
    if kind == "PreparedTiledWindow":
        prep = prepared_tiled_window_from_jax(inner, device=device)
    elif kind == "PreparedTiledDense":
        prep = prepared_tiled_dense_from_jax(inner, device=device)
    elif kind == "PreparedTiledRows":
        prep = prepared_tiled_rows_from_jax(inner, device=device)
    elif kind == "PreparedGatherEll":
        prep = PreparedGatherEll(**_fields(inner, ("cols", "vals"), device),
                                 shape=_shape(inner))
    elif kind == "PreparedGather":
        prep = PreparedGather(**_fields(inner, ("rows", "cols", "vals"),
                                        device), shape=_shape(inner))
    else:
        raise TypeError(f"prepared_general_from_jax: unknown layout {kind}")
    order = (None if pg.order is None else tensor_from_numpy(
        np.asarray(pg.order).astype(np.int64), device))
    return PreparedGeneral(order=order, prep=prep)


def tiled_blocks_from_jax(tb, *, device=None) -> TiledBlocks:
    return TiledBlocks(**_fields(tb, ("tile_row", "tile_col", "blocks"),
                                 device), shape=_shape(tb))


def _numpy_fields(obj, names) -> dict:
    return {k: np.array(getattr(obj, k)) for k in names}


def tiled_gemm_plan_from_jax(plan) -> TiledGemmPlan:
    return TiledGemmPlan(
        **_numpy_fields(plan, ("pa", "pb", "oid", "out_tile_row",
                               "out_tile_col")),
        transpose_b=bool(plan.transpose_b),
        out_shape=tuple(int(s) for s in plan.out_shape))


def window_gemm_plan_from_jax(plan) -> WindowGemmPlan:
    return WindowGemmPlan(
        **_numpy_fields(plan, ("cnt", "pt", "pu", "row_lo")),
        **{k: int(getattr(plan, k)) for k in ("W", "G", "wrows", "nbr",
                                              "nbr_pad", "rt_a", "rt_b")},
        out_shape=tuple(int(s) for s in plan.out_shape),
        shared=bool(plan.shared),
        pmax_band=tuple(int(p) for p in plan.pmax_band))


def esc_plan_from_jax(plan, *, device=None) -> EscPlan:
    return EscPlan(**_fields(plan, ("ea", "eb", "seg", "out_indices"),
                             device), n_out=int(plan.n_out),
                   out_shape=tuple(int(s) for s in plan.out_shape))


def prepared_shuffle_from_jax(prep, *, device=None) -> PreparedShuffleSpMV:
    """The port's :class:`PreparedShuffleSpMV` holding a JAX
    ``PreparedShuffleSpMV``'s arrays."""
    arrays = _fields(prep, ("octet", "idx", "vals", "dest", "filler_dest",
                            "extra_rows", "extra_vrows"), device)
    n_slots = int(prep.n_vrows) * int(prep.ell_k)
    ell_cols, ell_vals = slot_order_of_batches(
        arrays["octet"], arrays["idx"], arrays["vals"], arrays["dest"],
        n_slots, _shape(prep)[1])
    return PreparedShuffleSpMV(
        **arrays, ell_cols=ell_cols, ell_vals=ell_vals,
        n_vrows=int(prep.n_vrows), ell_k=int(prep.ell_k), shape=_shape(prep))

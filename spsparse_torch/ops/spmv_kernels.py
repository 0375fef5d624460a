"""Format-dispatched SpMV/SpMM.

Counterpart of :mod:`spsparse_tpu.ops.spmv_kernels`:

* :func:`spmv_dia` — plain per-diagonal shifted multiply-add in the dtype
  promoted from the operands (the JAX package's XLA lowering).
* :func:`spmv_ell` — gather + row reduce over the ELL layout.
* :func:`best_spmv` — routes each operand format to its fastest path:
  a float64 :class:`SparseDIA` to :func:`spmv_dia` (K1 never took
  float64); other :class:`SparseDIA` / :class:`PreparedDIA` to kernel K1
  (:func:`spmv_dia_stream`), which launches the CUDA kernel for CUDA
  tensors and runs its plain version for CPU tensors; a
  :class:`PreparedShuffleSpMV` goes to kernel K11 (:func:`spmv_shuffle`).
* :func:`best_spmm` — the same dispatch for a dense block ``X``: the
  prepared general and tiled layouts go to kernels K5
  (:func:`spmm_tiled_window`), K6 (:func:`spmm_tiled_dense`) and K7
  (:func:`spmm_tiled_onehot`), BSR to :func:`spmm_bsr`.
"""

from __future__ import annotations

import torch

from ..core.bsr import SparseBSR
from ..core.coo import operand_tensor
from ..core.dia import SparseDIA
from ..core.structure import SparseELL
from ..core.tiled import SparseTiledCOO
from .dia_stream import PreparedDIA, spmv_dia_stream
from .general import PreparedGeneral, spmm_general, spmv_general
from .spmm import (_gather_rows, spmm as _spmm_generic, spmm_bsr,
                   spmv as _spmv_generic)
from .spmv_shuffle import PreparedShuffleSpMV, spmv_shuffle
from .tiled_ops import spmm_tiled
from .tiled_spmm import (PreparedTiledDense, PreparedTiledRows,
                         spmm_tiled_dense, spmm_tiled_onehot)
from .tiled_window import PreparedTiledWindow, spmm_tiled_window

__all__ = ["spmv_dia", "spmv_ell", "best_spmv", "best_spmm"]

Tensor = torch.Tensor

def spmv_dia(dia: SparseDIA, x: Tensor) -> Tensor:
    """``y = A @ x`` for diagonal storage: ``y[i] += data[d,i] * x[i+off]``
    over the in-range rows of each diagonal."""
    n, m = dia.shape
    x = operand_tensor(x, dia.device)
    y = torch.zeros(n, dtype=torch.promote_types(dia.data.dtype, x.dtype),
                    device=dia.device)
    for d, off in enumerate(dia.offsets):
        lo, hi = max(0, -off), min(n, m - off)
        if hi > lo:
            y[lo:hi] += dia.data[d, lo:hi] * x[lo + off:hi + off]
    return y


def spmv_ell(ell: SparseELL, x: Tensor) -> Tensor:
    """Gather + row-reduce over the regular ELL layout."""
    xg = _gather_rows(operand_tensor(x, ell.vals.device),
                      ell.cols.reshape(-1))
    return (ell.vals * xg.reshape(ell.cols.shape)).sum(dim=1)


def best_spmv(a, x: Tensor) -> Tensor:
    """Format-dispatched SpMV. A float64 :class:`SparseDIA` goes to
    :func:`spmv_dia` (float64 result, the JAX package's route for it off
    the TPU: K1 takes float32 and bfloat16 diagonals only); other DIA
    operands to kernel K1 (float32 result); a :class:`PreparedShuffleSpMV`
    to :func:`spmv_shuffle` (K11, float32); a :class:`PreparedGeneral` to
    :func:`spmv_general`; ELL to :func:`spmv_ell`; CSR/COO to the generic
    CSR path."""
    if isinstance(a, SparseDIA) and a.data.dtype == torch.float64:
        return spmv_dia(a, x)
    if isinstance(a, (SparseDIA, PreparedDIA)):
        return spmv_dia_stream(a, x)
    if isinstance(a, PreparedShuffleSpMV):
        return spmv_shuffle(a, x)
    if isinstance(a, PreparedGeneral):
        return spmv_general(a, x)
    if isinstance(a, SparseELL):
        return spmv_ell(a, x)
    return _spmv_generic(a, x)


def best_spmm(a, X: Tensor) -> Tensor:
    """Format-dispatched SpMM ``Y = A @ X`` for a dense ``X (K, N)``.
    Prepared general and tiled layouts run kernels K5-K7 (float32 result),
    a :class:`SparseTiledCOO` the plain tiled product, BSR the batched tile
    product; DIA operands run :func:`spmv_dia` per column (the JAX
    package's XLA path); CSR/COO/ELL the generic gather path."""
    if isinstance(a, PreparedTiledWindow):
        return spmm_tiled_window(a, operand_tensor(X, a.device))
    if isinstance(a, PreparedGeneral):
        return spmm_general(a, X)
    if isinstance(a, PreparedTiledDense):
        return spmm_tiled_dense(a, operand_tensor(X, a.device))
    if isinstance(a, PreparedTiledRows):
        return spmm_tiled_onehot(a, operand_tensor(X, a.device))
    if isinstance(a, SparseTiledCOO):
        return spmm_tiled(a, X)
    if isinstance(a, SparseBSR):
        return spmm_bsr(a, X)
    X = operand_tensor(X, a.vals.device if isinstance(a, SparseELL)
                       else a.device)
    if isinstance(a, SparseDIA):
        return torch.stack([spmv_dia(a, X[:, c]) for c in range(X.shape[1])],
                           dim=1)
    return _spmm_generic(a, X)

"""Multi-RHS banded (DIA) SpMM, up to 8 right-hand sides a pass: kernel K3.

Counterpart of :mod:`spsparse_tpu.ops.pallas_dia_mrhs`
(``spmm_dia_mrhs_pallas``, the Pallas kernel ``_mrhs_kernel``). For ``X`` of
shape ``(R, m)``, ``R <= RHS_BLOCK = 8``, it computes

    Y[r, i] = sum_k data[k, i] * X[r, i + off_k]     (Y = (A @ X.T).T)

reading the diagonals once for all right-hand sides: that sharing is what
the kernel is for, and what :func:`spsparse_torch.solvers.cg_solve_mrhs`
amortises. On a CUDA tensor :func:`spmm_dia_mrhs` launches the Hopper
kernel ``sps_dia_mrhs`` (``spsparse_torch/csrc/dia_mrhs.cu``); on a CPU
tensor it runs the plain version :func:`spmm_dia_mrhs_reference`.

The JAX package has two entries, the padded ``_spmm_mrhs_ad`` and the
zero-copy ``_spmm_mrhs_fast`` for an ``X`` already in the kernel's layout.
On Hopper the kernel bounds-checks columns, so there is no padded copy to
avoid and one entry serves both. Autograd is the custom VJP of both JAX
entries, through :class:`spsparse_torch.ops.dia_stream.DiaSpmmFunction`:
``d_X = (A^T G^T)^T`` and ``d_data[k, i] = sum_r G[r, i] X[r, i + off_k]``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import backend
from .dia_stream import (DiaSpmmFunction, PreparedDIA, check_operands,
                         launch_args, needs_grad, prepare_dia)

__all__ = ["spmm_dia_mrhs", "spmm_dia_mrhs_reference", "RHS_BLOCK"]

Tensor = torch.Tensor

RHS_BLOCK = 8


def spmm_dia_mrhs_reference(prep: PreparedDIA, X: Tensor) -> Tensor:
    """Plain PyTorch K3: one shifted multiply-add per diagonal over all
    rows of ``X (R, m)``, in f32."""
    n, m = prep.shape
    Xf = X.to(torch.float32)
    Y = torch.zeros((X.shape[0], n), dtype=torch.float32, device=X.device)
    for k, off in enumerate(prep.offsets):
        lo, hi = max(0, -off), min(n, m - off)
        if hi > lo:
            Y[:, lo:hi] += prep.data[k, lo:hi].float() * Xf[:, lo + off:
                                                             hi + off]
    return Y


def _spmm(prep: PreparedDIA, X: Tensor) -> Tensor:
    """K3 on a CUDA ``X``, its plain version on a CPU ``X``."""
    if X.device.type == "cpu":
        return spmm_dia_mrhs_reference(prep, X)
    n, m = prep.shape
    R = X.shape[0]
    Y = torch.empty((R, n), dtype=torch.float32, device=X.device)
    if n == 0 or R == 0:
        return Y
    lib = backend.load_kernels()
    code, offs = launch_args(prep)
    err = lib.sps_dia_mrhs(
        code, prep.data.data_ptr(), prep.data.stride(0), n, m,
        len(prep.offsets), ctypes.cast(offs, ctypes.c_void_p), R,
        X.data_ptr(), X.stride(0), Y.data_ptr(), Y.stride(0),
        backend.current_stream(X.device))
    backend.check(err, "sps_dia_mrhs")
    spmm_dia_mrhs.launches += 1
    return Y


def spmm_dia_mrhs(dia, X: Tensor) -> Tensor:
    """``Y = (A @ X.T).T`` (float32, shape ``(R, n)``) for a
    :class:`SparseDIA` (prepared on the fly in float32) or a
    :class:`PreparedDIA` (float32 or bfloat16 data) and ``X (R, m)`` with
    ``R <= 8``; a 1-D ``X`` gives a 1-D ``Y``. Differentiable in the
    diagonals and in ``X``.

    CUDA tensors launch kernel K3 (``spmm_dia_mrhs.launches`` counts the
    launches); CPU tensors take :func:`spmm_dia_mrhs_reference`.
    """
    prep = dia if isinstance(dia, PreparedDIA) else prepare_dia(dia)
    if not isinstance(X, Tensor) or X.ndim not in (1, 2):
        raise ValueError("X must be a 1-D or 2-D tensor (R, m)")
    squeeze = X.ndim == 1
    X2 = X[None, :] if squeeze else X
    R = X2.shape[0]
    if R > RHS_BLOCK:
        raise ValueError(f"at most {RHS_BLOCK} right-hand sides per call, "
                         f"got {R}")
    # check_operands validates the operand and one row of X; all rows
    # share its length, device and dtype.
    check_operands(prep, X2[0] if R else X2.new_zeros(prep.shape[1]))
    X2 = X2.to(torch.float32).contiguous()
    if needs_grad(prep, X2):
        Y = DiaSpmmFunction.apply(prep.data, X2, prep, _spmm)
    else:
        Y = _spmm(prep, X2)
    return Y[0] if squeeze else Y


spmm_dia_mrhs.launches = 0

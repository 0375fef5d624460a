"""Banded (DIA) SpMV in one streaming pass: kernel K1.

Counterpart of :mod:`spsparse_tpu.ops.pallas_dia` (``spmv_dia_pallas``, the
Pallas kernel ``_dia_stream_kernel``). On a CUDA tensor
:func:`spmv_dia_stream` launches the hand-written Hopper kernel
``sps_dia_spmv`` (``spsparse_torch/csrc/dia.cu``); on a CPU tensor it runs
the plain PyTorch version :func:`spmv_dia_stream_reference`, which the tests
hold against the JAX package. It computes

    y[i] = sum_k data[k, i] * x[i + off_k]     (columns outside [0, m) add 0)

with f32 or bf16 data, f32 ``x`` and ``y``, and f32 accumulation.

Prepared layout: row-per-diagonal ``data (K, n)``, contiguous. On Hopper it
is the coalesced layout (each warp reads 32 neighbouring rows of one
diagonal). The JAX package re-blocks the data into ``(nblocks, K*block)``
(f32) or ``(nblocks, K_pad, block)`` (bf16) for the TPU's DMA engine;
:func:`spsparse_torch.convert.prepared_dia_from_jax` un-blocks either.

Autograd. The JAX package gives the kernel a custom VJP
(``pallas_dia.py:127-196``) whose backward is XLA code, not a Pallas kernel;
its port is :class:`DiaSpmmFunction`, whose backward is plain PyTorch, the
faithful counterpart. For ``y = A x`` and a cotangent ``g``:

    d_x[i + off_k]  += data[k, i] * g[i]          (A^T g)
    d_data[k, i]     = g[i] * x[i + off_k]        (0 where the column is out
                                                   of range)

The same Function serves K3 (:mod:`spsparse_torch.ops.dia_mrhs`), with one
row of ``X`` per right-hand side and ``d_data`` summed over them. Gradients
reach the ``SparseDIA.data`` that :func:`prepare_dia` was given.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import backend
from ..core.dia import SparseDIA

__all__ = ["PreparedDIA", "prepare_dia", "spmv_dia_stream",
           "spmv_dia_stream_reference", "DiaSpmmFunction", "MAX_DIAGS"]

Tensor = torch.Tensor

# Must equal SPS_MAX_DIAGS in csrc/dia.cu (the kernel-parameter struct).
MAX_DIAGS = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class PreparedDIA:
    """Kernel-ready DIA operand: ``data (K, n)`` in float32 or bfloat16,
    contiguous, one row per diagonal. Build once with :func:`prepare_dia`
    and reuse across SpMV calls."""

    data: Tensor
    offsets: tuple
    shape: tuple

    @property
    def device(self) -> torch.device:
        return self.data.device


def prepare_dia(dia: SparseDIA, *, dtype=torch.float32) -> PreparedDIA:
    """Cast the diagonals to ``dtype`` (float32 or bfloat16). bfloat16
    halves the dominant memory stream; accumulation stays float32."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"prepare_dia: dtype must be float32 or bfloat16, "
                         f"got {dtype}")
    return PreparedDIA(data=dia.data.to(dtype).contiguous(),
                       offsets=tuple(int(o) for o in dia.offsets),
                       shape=tuple(dia.shape))


def check_operands(prep: PreparedDIA, x: Tensor) -> Tensor:
    """Validate a prepared operand and ``x``; return ``x`` as contiguous
    float32 on the operand's device (no device move)."""
    n, m = prep.shape
    K = len(prep.offsets)
    data = prep.data
    if data.dtype not in _DTYPE_CODE:
        raise TypeError(f"DIA data must be float32 or bfloat16, got "
                        f"{data.dtype}")
    if tuple(data.shape) != (K, n):
        raise ValueError(f"DIA data must have shape {(K, n)}, got "
                         f"{tuple(data.shape)}")
    if not data.is_contiguous():
        raise ValueError("DIA data must be contiguous")
    if K > MAX_DIAGS:
        raise ValueError(f"DIA kernels take at most {MAX_DIAGS} diagonals, "
                         f"got {K}")
    if not isinstance(x, Tensor) or x.ndim != 1 or x.shape[0] != m:
        raise ValueError(f"x must be a 1-D tensor of length {m}")
    if not x.dtype.is_floating_point:
        raise TypeError(f"x must be floating point, got {x.dtype}")
    if x.device != data.device:
        raise ValueError(f"x is on {x.device} but the operand is on "
                         f"{data.device}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")
    return x.to(torch.float32).contiguous()


def spmv_dia_stream_reference(prep: PreparedDIA, x: Tensor) -> Tensor:
    """Plain PyTorch K1: one shifted multiply-add per diagonal, in f32."""
    n, m = prep.shape
    xf = x.to(torch.float32)
    y = torch.zeros(n, dtype=torch.float32, device=x.device)
    for k, off in enumerate(prep.offsets):
        lo, hi = max(0, -off), min(n, m - off)
        if hi > lo:
            y[lo:hi] += prep.data[k, lo:hi].float() * xf[lo + off:hi + off]
    return y


def launch_args(prep: PreparedDIA):
    """``(dtype code, offsets as a C int array)`` for the C entry points."""
    offs = (ctypes.c_int * max(len(prep.offsets), 1))(*prep.offsets)
    return _DTYPE_CODE[prep.data.dtype], offs


def _spmv(prep: PreparedDIA, x: Tensor) -> Tensor:
    """K1 on a CUDA ``x``, its plain version on a CPU ``x``."""
    if x.device.type == "cpu":
        return spmv_dia_stream_reference(prep, x)
    n, m = prep.shape
    y = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return y
    lib = backend.load_kernels()
    code, offs = launch_args(prep)
    err = lib.sps_dia_spmv(
        code, prep.data.data_ptr(), prep.data.stride(0), n, m,
        len(prep.offsets), ctypes.cast(offs, ctypes.c_void_p),
        x.data_ptr(), y.data_ptr(), 1.0, backend.current_stream(x.device))
    backend.check(err, "sps_dia_spmv")
    spmv_dia_stream.launches += 1
    return y


def dia_vjp(prep: PreparedDIA, X: Tensor, G: Tensor):
    """Cotangents of ``Y = (A X^T)^T`` for ``X (R, m)`` and ``G (R, n)``:
    ``(d_data (K, n), d_X (R, m))`` in float32 (plain PyTorch, as the JAX
    package's backward is XLA code)."""
    n, m = prep.shape
    G = G.to(torch.float32)
    d_x = torch.zeros(X.shape, dtype=torch.float32, device=X.device)
    d_data = torch.zeros(prep.data.shape, dtype=torch.float32,
                         device=X.device)
    for k, off in enumerate(prep.offsets):
        lo, hi = max(0, -off), min(n, m - off)
        if hi > lo:
            d_x[:, lo + off:hi + off] += prep.data[k, lo:hi].float() * G[
                :, lo:hi]
            d_data[k, lo:hi] = (G[:, lo:hi] * X[:, lo + off:hi + off]).sum(0)
    return d_data, d_x


class DiaSpmmFunction(torch.autograd.Function):
    """``Y (R, n) = (A X^T)^T`` through ``fwd`` (kernel K1 or K3, or a
    plain version on the CPU), differentiable in ``data`` and ``X``."""

    @staticmethod
    def forward(ctx, data, X, prep, fwd):
        ctx.save_for_backward(data, X)
        ctx.prep = prep
        return fwd(prep, X)

    @staticmethod
    def backward(ctx, G):
        data, X = ctx.saved_tensors
        d_data, d_x = dia_vjp(ctx.prep, X, G)
        return (d_data.to(data.dtype) if ctx.needs_input_grad[0] else None,
                d_x.to(X.dtype) if ctx.needs_input_grad[1] else None,
                None, None)


def needs_grad(prep: PreparedDIA, x: Tensor) -> bool:
    return torch.is_grad_enabled() and (prep.data.requires_grad
                                        or x.requires_grad)


def spmv_dia_stream(dia, x: Tensor) -> Tensor:
    """``y = A @ x`` (float32) for a :class:`SparseDIA` (prepared on the
    fly in float32) or a :class:`PreparedDIA`; differentiable in the
    diagonals and in ``x``.

    CUDA tensors launch kernel K1 (``spmv_dia_stream.launches`` counts the
    launches); CPU tensors take :func:`spmv_dia_stream_reference`.
    """
    prep = dia if isinstance(dia, PreparedDIA) else prepare_dia(dia)
    x = check_operands(prep, x)
    if not needs_grad(prep, x):
        return _spmv(prep, x)
    return DiaSpmmFunction.apply(prep.data, x[None, :], prep,
                                 lambda p, X: _spmv(p, X[0])[None, :])[0]


spmv_dia_stream.launches = 0

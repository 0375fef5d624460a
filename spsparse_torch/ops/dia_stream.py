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
import functools
from typing import NamedTuple

import torch

from .. import backend
from ..core.dia import SparseDIA

__all__ = ["PreparedDIA", "prepare_dia", "spmv_dia_stream",
           "spmv_dia_stream_reference", "DiaSpmmFunction", "MAX_DIAGS",
           "dia_spmv_geometry", "DiaSpmvGeometry"]

Tensor = torch.Tensor

# Must equal SPS_MAX_DIAGS in csrc/dia.cu (the kernel-parameter struct).
MAX_DIAGS = 128
# Must equal kThreads and Rows<T>::V in csrc/dia.cu.
_THREADS = 256
_ROWS_PER_THREAD = {torch.float32: 4, torch.bfloat16: 8}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class _Launch(NamedTuple):
    """What a K1, K2, K3 or K4 launch needs of a checked operand and never
    changes: the dtype code, the offsets as a C array (and its address),
    the shape, the row stride of ``data``, and the device."""

    code: int
    offsets: ctypes.Array
    offsets_ptr: int
    K: int
    n: int
    m: int
    ld: int
    device: torch.device
    is_cuda: bool
    device_index: int


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

    @functools.cached_property
    def launch(self) -> _Launch:
        """The operand checked once and its launch arguments (raises on an
        operand the kernels do not take)."""
        n, m = self.shape
        K = len(self.offsets)
        data = self.data
        if data.dtype not in _DTYPE_CODE:
            raise TypeError(f"DIA data must be float32 or bfloat16, got "
                            f"{data.dtype}")
        if tuple(data.shape) != (K, n):
            raise ValueError(f"DIA data must have shape {(K, n)}, got "
                             f"{tuple(data.shape)}")
        if not data.is_contiguous():
            raise ValueError("DIA data must be contiguous")
        if K > MAX_DIAGS:
            raise ValueError(f"DIA kernels take at most {MAX_DIAGS} "
                             f"diagonals, got {K}")
        if data.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {data.device}")
        offs = (ctypes.c_int * max(K, 1))(*self.offsets)
        return _Launch(_DTYPE_CODE[data.dtype], offs, ctypes.addressof(offs),
                       K, n, m, data.stride(0), data.device, data.is_cuda,
                       data.get_device())


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
    """Validate a prepared operand (once: :attr:`PreparedDIA.launch`) and
    ``x``; return ``x`` as contiguous float32 on the operand's device (no
    device move; no copy when it is one already)."""
    op = prep.launch
    if not isinstance(x, Tensor) or x.ndim != 1 or x.shape[0] != op.m:
        raise ValueError(f"x must be a 1-D tensor of length {op.m}")
    if x.is_cuda != op.is_cuda or x.get_device() != op.device_index:
        raise ValueError(f"x is on {x.device} but the operand is on "
                         f"{op.device}")
    if x.dtype is not torch.float32:
        if not x.dtype.is_floating_point:
            raise TypeError(f"x must be floating point, got {x.dtype}")
        x = x.to(torch.float32)
    return x if x.is_contiguous() else x.contiguous()


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
    """``(dtype code, offsets as a C int array)`` for the C entry points
    (made once per operand)."""
    op = prep.launch
    return op.code, op.offsets


class DiaSpmvGeometry(NamedTuple):
    """K1's launch (``sps_dia_spmv_geometry``): rows a thread, threads a
    CTA, CTAs, 16-byte loads (or one load an element)."""

    rows: int
    threads: int
    ctas: int
    vector: bool


def dia_spmv_geometry(dtype, ld: int, n: int, data_ptr: int,
                      y_ptr: int) -> DiaSpmvGeometry:
    """Host replay of ``sps_dia_spmv_geometry`` (csrc/dia.cu) for ``data``
    of ``dtype`` (float32 or bfloat16) with row stride ``ld`` and ``n``
    rows, at the addresses ``data_ptr`` and ``y_ptr``: V rows a thread, 4
    (f32) or 8 (bf16), 16 bytes of a diagonal; 256 threads, 256 V rows a
    CTA; the 16-byte path when ``ld`` and ``n`` are multiples of V and data
    and y are 16-byte aligned."""
    V = _ROWS_PER_THREAD[dtype]
    vector = (ld % V == 0 and n % V == 0 and data_ptr % 16 == 0
              and y_ptr % 16 == 0)
    return DiaSpmvGeometry(V, _THREADS, -(-n // (_THREADS * V)), vector)


def _spmv(prep: PreparedDIA, x: Tensor) -> Tensor:
    """K1 on a CUDA ``x``, its plain version on a CPU ``x``."""
    op = prep.launch
    if not op.is_cuda:
        return spmv_dia_stream_reference(prep, x)
    y = torch.empty(op.n, dtype=torch.float32, device=op.device)
    if op.n == 0:
        return y
    err = backend.load_kernels().sps_dia_spmv(
        op.code, prep.data.data_ptr(), op.ld, op.n, op.m, op.K,
        op.offsets_ptr, x.data_ptr(), y.data_ptr(), 1.0,
        backend.current_stream_of(op.device_index))
    if err:
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

"""Chained DIA SpMV iterations on the device: kernel K2.

Counterpart of :mod:`spsparse_tpu.ops.pallas_dia_chain`
(``spmv_dia_chain_pallas``, the Pallas kernel ``_chain_kernel``):

    y = (scale * A)^iters @ x

for a square DIA operator, the steady-state workload of the repository's
banded benchmark (and of power-method-style iterations). On a CUDA tensor
:func:`spmv_dia_chain` makes one call into ``sps_dia_chain``
(``spsparse_torch/csrc/dia.cu``), which issues the ``iters`` scaled SpMV
launches on PyTorch's current stream, ping-ponging two buffers allocated
here, with no host synchronisation inside the chain. On a CPU tensor it runs
:func:`spmv_dia_chain_reference`.

The JAX kernel's ``|offset| <= 128`` limit came from its fixed VMEM halo;
the Hopper kernel bounds-checks columns, so the limit is lifted.
"""

from __future__ import annotations

import torch

from .. import backend
from .dia_stream import (PreparedDIA, check_operands, prepare_dia,
                         spmv_dia_stream_reference)

__all__ = ["spmv_dia_chain", "spmv_dia_chain_reference"]

Tensor = torch.Tensor


def spmv_dia_chain_reference(prep: PreparedDIA, x: Tensor, iters: int,
                             scale: float = 1.0) -> Tensor:
    """Plain PyTorch K2: ``iters`` scaled plain SpMVs, in f32."""
    y = x.to(torch.float32)
    for _ in range(int(iters)):
        y = spmv_dia_stream_reference(prep, y) * scale
    return y


def spmv_dia_chain(dia, x: Tensor, iters: int, scale: float = 1.0) -> Tensor:
    """``y = (scale * A)^iters @ x`` (float32) for a square DIA operand.

    CUDA tensors launch kernel K2 — one counted launch
    (``spmv_dia_chain.launches``) per chain of ``iters`` SpMVs; CPU tensors
    take :func:`spmv_dia_chain_reference`.
    """
    prep = dia if isinstance(dia, PreparedDIA) else prepare_dia(dia)
    n, m = prep.shape
    if n != m:
        raise ValueError(f"the chain needs a square operator, got {(n, m)}")
    iters = int(iters)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    x = check_operands(prep, x)
    if x.device.type == "cpu":
        return spmv_dia_chain_reference(prep, x, iters, scale)
    buf_a = x.clone()
    buf_b = torch.empty_like(buf_a)
    if iters == 0 or n == 0:
        return buf_a
    op = prep.launch
    err = backend.load_kernels().sps_dia_chain(
        op.code, prep.data.data_ptr(), op.ld, n, op.K, op.offsets_ptr,
        buf_a.data_ptr(), buf_b.data_ptr(), iters, float(scale),
        backend.current_stream_of(op.device_index))
    backend.check(err, "sps_dia_chain")
    spmv_dia_chain.launches += 1
    return buf_a if iters % 2 == 0 else buf_b


spmv_dia_chain.launches = 0

"""Conjugate gradients on a banded (DIA) operator: kernel K4.

Counterpart of :mod:`spsparse_tpu.ops.pallas_cg` (``cg_solve_dia_pallas``,
the Pallas kernel ``_cg_kernel``). :func:`cg_solve_dia` runs ``iters`` CG
iterations on ``(A + shift I) x = b`` for a square DIA operator and returns
``(x, final_rs)``, by exactly the JAX kernel's iteration:

    x = 0, r = p = b, rs = b.b, beta = 0; then, each iteration,
    p = r + beta p;  Ap = (A + shift I) p;  pap = p.Ap;
    alpha = rs / (pap == 0 ? 1 : pap);  x += alpha p;  r -= alpha Ap;
    rsnew = r.r;  beta = rsnew / (rs == 0 ? 1 : rs);  rs = rsnew

Both guards are kept, so ``b = 0`` gives ``x = 0`` and ``rs = 0``, no NaN.
``final_rs`` is a 0-d float32 tensor on the operand's device; nothing in
the solve synchronises with the host.

On a CUDA tensor one C call (``sps_dia_cg``, ``spsparse_torch/csrc/
dia_cg.cu``) issues the whole solve on PyTorch's current stream, two
launches an iteration with the scalars on the device, and counts one launch
per solve (``cg_solve_dia.launches``). The wrapper allocates every buffer
the kernels use (``r``, two ``p`` buffers, ``Ap``, the per-block partials,
the arrival counter and the scalars). On a CPU tensor it runs the plain
version :func:`cg_solve_dia_reference`.

Two limits of the JAX kernel were limits of the TPU's VMEM and are dropped:
the ``VMEM_BUDGET`` guard (``p``, ``r`` and ``Ap`` lived in VMEM) and the
``|offset| <= 128`` limit (its fixed halo). The Hopper kernels keep the
vectors in device memory and bounds-check columns.
"""

from __future__ import annotations

import ctypes

import torch

from .. import backend
from .dia_stream import (PreparedDIA, check_operands, launch_args,
                         prepare_dia, spmv_dia_stream_reference)

__all__ = ["cg_solve_dia", "cg_solve_dia_reference"]

Tensor = torch.Tensor

# Threads per block of the CG kernels (kThreads in csrc/dia_common.cuh):
# one partial sum per block.
_THREADS = 256


def _guard(d: Tensor) -> Tensor:
    return torch.where(d == 0, torch.ones_like(d), d)


def cg_solve_dia_reference(prep: PreparedDIA, b: Tensor, *, iters: int,
                           shift: float = 0.0) -> tuple[Tensor, Tensor]:
    """Plain PyTorch K4 in float32: the same iteration, with the SpMV of
    :func:`spmv_dia_stream_reference`."""
    b = b.to(torch.float32)
    x = torch.zeros_like(b)
    r = b.clone()
    p = torch.zeros_like(b)
    rs = torch.dot(b, b)
    beta = torch.zeros_like(rs)
    for _ in range(int(iters)):
        p = r + beta * p
        Ap = spmv_dia_stream_reference(prep, p) + shift * p
        alpha = rs / _guard(torch.dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        rsnew = torch.dot(r, r)
        beta = rsnew / _guard(rs)
        rs = rsnew
    return x, rs


def cg_solve_dia(dia, b: Tensor, *, iters: int,
                 shift: float = 0.0) -> tuple[Tensor, Tensor]:
    """Solve ``(A + shift I) x = b`` by ``iters`` CG iterations for a
    square :class:`SparseDIA` (prepared on the fly in float32) or
    :class:`PreparedDIA` (float32 or bfloat16 data); ``A + shift I`` must
    be SPD for CG to apply. Returns ``(x, final_rs)`` in float32.

    CUDA tensors run kernel K4, one counted launch per solve; CPU tensors
    take :func:`cg_solve_dia_reference`.
    """
    prep = dia if isinstance(dia, PreparedDIA) else prepare_dia(dia)
    n, m = prep.shape
    if n != m:
        raise ValueError(f"CG needs a square operator, got {(n, m)}")
    iters = int(iters)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    b = check_operands(prep, b)
    if b.device.type == "cpu":
        return cg_solve_dia_reference(prep, b, iters=iters, shift=shift)
    dev = b.device
    if n == 0:
        return torch.empty(0, device=dev), torch.zeros((), device=dev)
    nparts = -(-n // _THREADS)
    x = torch.empty(n, dtype=torch.float32, device=dev)
    r, p_a, p_b, ap = torch.empty((4, n), dtype=torch.float32,
                                  device=dev).unbind(0)
    partial = torch.empty(nparts, dtype=torch.float32, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    scal = torch.empty(3, dtype=torch.float32, device=dev)
    lib = backend.load_kernels()
    code, offs = launch_args(prep)
    err = lib.sps_dia_cg(
        code, prep.data.data_ptr(), prep.data.stride(0), n,
        len(prep.offsets), ctypes.cast(offs, ctypes.c_void_p), float(shift),
        b.data_ptr(), x.data_ptr(), r.data_ptr(), p_a.data_ptr(),
        p_b.data_ptr(), ap.data_ptr(), partial.data_ptr(), nparts,
        counter.data_ptr(), scal.data_ptr(), iters,
        backend.current_stream(dev))
    backend.check(err, "sps_dia_cg")
    cg_solve_dia.launches += 1
    return x, scal[0]


cg_solve_dia.launches = 0

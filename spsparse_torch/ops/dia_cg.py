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
dia_cg.cu``) runs the whole solve as one cooperative launch on PyTorch's
current stream, the scalars on the device, and counts one launch per solve
(``cg_solve_dia.launches``). A persistent grid of :func:`cg_geometry`'s
shape owns the rows in contiguous ranges; in the resident mode each CTA
keeps its rows of ``p``, ``r``, ``x`` and ``Ap`` in shared memory for the
whole solve, in the device-memory mode (rows that do not fit) in a scratch
buffer. Two grid-wide exchanges of partial sums an iteration, each also a
barrier; rows that other CTAs read are published to device memory before
the second. The wrapper allocates ``x``, ``rs`` and one scratch buffer
(published rows, the slots of the partial sums and, in the device-memory
mode, ``p``, ``r`` and ``Ap``).
A launch the card refuses raises; nothing else is tried. On a CPU tensor
it runs the plain version :func:`cg_solve_dia_reference`.

Two limits of the JAX kernel were limits of the TPU's VMEM and are dropped:
the ``VMEM_BUDGET`` guard (``p``, ``r`` and ``Ap`` lived in VMEM) and the
``|offset| <= 128`` limit (its fixed halo). The Hopper kernel chooses its
mode by the rows a CTA owns and reads a tap of any offset, from its own
rows or from the published ones.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import backend
from .dia_stream import (_DTYPE_CODE, PreparedDIA, check_operands,
                         launch_args, prepare_dia, spmv_dia_stream_reference)

__all__ = ["cg_solve_dia", "cg_solve_dia_reference", "cg_geometry",
           "cg_kernel_geometry", "CgGeometry"]

Tensor = torch.Tensor

# The kernel's constants (csrc/dia_cg.cu): threads a CTA (one CTA an SM),
# rows a lane takes in a chunk (32 apart), the alignment of a CTA's row
# count, the reduction scratch ahead of the vectors, and the shared memory
# a resident row takes (p, r, x, Ap).
CG_THREADS = 512
CG_LANE_ROWS = 4
CG_ROW_ALIGN = 32
CG_SCRATCH_BYTES = 256
CG_VEC_BYTES_PER_ROW = 16
# Shared memory the card reserves for each CTA on sm_90.
CG_RESERVED_SMEM = 1024


class CgGeometry(NamedTuple):
    """K4's launch: ``grid`` CTAs, ``ctas_per_sm`` of them on each SM,
    ``rows_per_cta`` rows each (CTA c owns ``[c R, (c + 1) R) & [0, n)``),
    the mode (``resident``: vectors in shared memory), the dynamic shared
    memory of a CTA and the floats of the wrapper's scratch buffer."""

    grid: int
    ctas_per_sm: int
    rows_per_cta: int
    resident: bool
    smem_bytes: int
    scratch_floats: int


def _rows_for(n: int, grid: int) -> int:
    rows = -(-n // grid)
    return -(-rows // CG_ROW_ALIGN) * CG_ROW_ALIGN


def cg_geometry(n: int, *, sms: int, smem_per_sm: int,
                smem_per_block: int) -> CgGeometry:
    """The geometry ``sps_dia_cg_geometry`` picks for ``n`` rows on a card
    with ``sms`` SMs, ``smem_per_sm`` bytes of shared memory an SM and
    ``smem_per_block`` a CTA (the opt-in limit), replayed on the host.

    One CTA an SM (the kernel's launch bounds give a thread up to 128
    registers, so two CTAs of 512 threads do not fit), ``R = ceil(n / sms)``
    rows each rounded up to 32. The resident mode when the CTA's vectors,
    16 bytes a row after 256 bytes of scratch, fit beside the 1 KB the card
    reserves for each CTA; else the device-memory mode. The scratch holds
    the published ``p`` and ``r`` (n floats each), two arrays of one 64-bit
    slot a CTA and, in the device-memory mode, ``p``, ``r`` and ``Ap``."""
    if n <= 0:
        raise ValueError(f"cg_geometry needs n >= 1, got {n}")
    rows = _rows_for(n, sms)
    smem = CG_SCRATCH_BYTES + CG_VEC_BYTES_PER_ROW * rows
    if smem <= smem_per_block and smem + CG_RESERVED_SMEM <= smem_per_sm:
        return CgGeometry(sms, 1, rows, True, smem, 2 * n + 4 * sms)
    return CgGeometry(sms, 1, rows, False, CG_SCRATCH_BYTES,
                      5 * n + 4 * sms)


@functools.lru_cache(maxsize=64)
def _kernel_geometry(device_index: int, code: int, n: int) -> CgGeometry:
    out = (ctypes.c_longlong * 6)()
    with torch.cuda.device(device_index):
        err = backend.load_kernels().sps_dia_cg_geometry(
            code, n, ctypes.cast(out, ctypes.c_void_p))
    backend.check(err, "sps_dia_cg_geometry")
    g = list(out)
    return CgGeometry(g[0], g[1], g[2], bool(g[3]), g[4], g[5])


def cg_kernel_geometry(n: int, dtype=torch.float32,
                       device=None) -> CgGeometry:
    """The geometry K4 launches with for ``n`` rows of ``dtype`` (float32
    or bfloat16) diagonals on a CUDA ``device``, as the kernel's own
    occupancy queries give it (``sps_dia_cg_geometry``)."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"K4 data must be float32 or bfloat16, got {dtype}")
    if n <= 0:
        raise ValueError(f"cg_kernel_geometry needs n >= 1, got {n}")
    index = torch.device("cuda" if device is None else device).index
    if index is None:
        index = torch.cuda.current_device()
    return _kernel_geometry(index, _DTYPE_CODE[dtype], int(n))


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

    CUDA tensors run kernel K4, one counted cooperative launch per solve;
    CPU tensors take :func:`cg_solve_dia_reference`.
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
    code, offs = launch_args(prep)
    geo = cg_kernel_geometry(n, prep.data.dtype, dev)
    x = torch.empty(n, dtype=torch.float32, device=dev)
    rs = torch.empty((), dtype=torch.float32, device=dev)
    scratch = torch.empty(geo.scratch_floats, dtype=torch.float32,
                          device=dev)
    err = backend.load_kernels().sps_dia_cg(
        code, prep.data.data_ptr(), prep.data.stride(0), n,
        len(prep.offsets), ctypes.cast(offs, ctypes.c_void_p), float(shift),
        b.data_ptr(), x.data_ptr(), scratch.data_ptr(), scratch.numel(),
        rs.data_ptr(), iters, backend.current_stream(dev))
    backend.check(err, "sps_dia_cg")
    cg_solve_dia.launches += 1
    return x, rs


cg_solve_dia.launches = 0

"""Roofline accounting: bytes/FLOP models per op + speed-of-light targets.

Counterpart of :mod:`spsparse_tpu.utils.roofline`. The traffic models are
the JAX package's, integer for integer; the memory-rate table is the
port's own: the data-sheet rate of the card the port runs on, keyed by
``torch.cuda.get_device_name``.

Model conventions (all sizes in bytes):

* SpMV-DIA: diagonal data streamed once; x counted once (cached on chip
  for moderate n); y written.
* SpMV-ELL: cols+vals streamed once; x counted once; y once.
* SpMV-CSR: cols+vals+rowptr streamed; x gathered (counted once per nnz in
  the pessimistic model — CSR gathers are irregular); y once.
* SpMM-ELL: cols+vals once; each nnz gathers one N-wide X row (the dominant
  term); Y written once.
* SpGEMM-ESC: expansion read+write (sort is multi-pass: ~log passes over
  the expansion buffer — we charge ``sort_passes`` passes).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["OpStats", "roofline", "device_hbm_bandwidth", "SOL_BW",
           "spmv_dia_stats", "spmv_ell_stats", "spmv_csr_stats",
           "spmm_ell_stats", "spgemm_esc_stats"]

# Speed-of-light device-memory rate per card (bytes/s), NVIDIA's data-sheet
# figure, keyed by ``torch.cuda.get_device_name``. A card runs at it only
# at its full power limit (700 W for the H100 SXM); one set below it runs
# slower under load, so state the limit (``nvidia-smi
# --query-gpu=name,power.limit``) beside a share.
SOL_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,   # H100 SXM
}


def _device_name(device) -> str:
    if device is None:
        if not torch.cuda.is_available():
            raise ValueError("no CUDA device is present: pass device= (and "
                             "bw= for a device the table does not name)")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def device_hbm_bandwidth(device=None) -> tuple[str, float]:
    """``(name, bytes/s)`` of ``device`` (a ``torch.device``; ``None`` is
    the current CUDA device) from :data:`SOL_BW`. A device the table does
    not name, the CPU among them, raises ``ValueError``: its caller states
    the rate (``roofline(..., bw=)``)."""
    name = _device_name(device)
    if name not in SOL_BW:
        raise ValueError(f"no memory rate is known for device {name!r}: "
                         f"pass bw= (the table names {sorted(SOL_BW)})")
    return name, SOL_BW[name]


@dataclasses.dataclass(frozen=True)
class OpStats:
    """Static traffic/FLOP model of one op invocation."""

    name: str
    nnz: int
    bytes_moved: int
    flops: int

    def sol_time(self, bw: float) -> float:
        return self.bytes_moved / bw

    def sol_nnz_per_s(self, bw: float) -> float:
        return self.nnz / self.sol_time(bw)


def roofline(stats: OpStats, time_s: float, device=None, *,
             bw: float | None = None) -> dict:
    """Measured time → achieved vs speed-of-light summary dict. ``bw``
    (bytes/s) overrides the table, and is required for a device it does
    not name."""
    if bw is None:
        kind, bw = device_hbm_bandwidth(device)
    else:
        kind = _device_name(device)
    achieved = stats.nnz / time_s
    sol = stats.sol_nnz_per_s(bw)
    return {
        "op": stats.name,
        "device": kind,
        "nnz": stats.nnz,
        "time_s": time_s,
        "nnz_per_s": achieved,
        "bytes_moved": stats.bytes_moved,
        "gbytes_per_s": stats.bytes_moved / time_s / 1e9,
        "sol_nnz_per_s": sol,
        "pct_of_roofline": 100.0 * achieved / sol,
    }


def _isize(dtype) -> int:
    return np.dtype(dtype).itemsize


def spmv_dia_stats(ndiag: int, nrows: int, dtype="float32") -> OpStats:
    s = _isize(dtype)
    nnz = ndiag * nrows
    return OpStats("spmv_dia", nnz,
                   nnz * s + nrows * 2 * s, 2 * nnz)


def spmv_ell_stats(nrows: int, k: int, dtype="float32",
                   index_size: int = 4) -> OpStats:
    nnz = nrows * k
    s = _isize(dtype)
    return OpStats("spmv_ell", nnz,
                   nnz * (index_size + s) + nrows * 2 * s, 2 * nnz)


def spmv_csr_stats(nnz: int, nrows: int, dtype="float32",
                   index_size: int = 4) -> OpStats:
    s = _isize(dtype)
    return OpStats("spmv_csr", nnz,
                   nnz * (index_size + 2 * s) + nrows * (4 + s), 2 * nnz)


def spmm_ell_stats(nrows: int, k: int, n_block: int, dtype="float32",
                   index_size: int = 4, x_dtype=None) -> OpStats:
    nnz = nrows * k
    s = _isize(dtype)
    xs = _isize(x_dtype or dtype)
    bytes_moved = (nnz * (index_size + s)        # cols + vals
                   + nnz * n_block * xs          # gathered X rows
                   + nrows * n_block * s)        # Y
    return OpStats("spmm_ell", nnz, bytes_moved, 2 * nnz * n_block)


def spgemm_esc_stats(nnz_a: int, nnz_b: int, expansion: int, nnz_out: int,
                     dtype="float32", index_size: int = 4,
                     sort_passes: int = 4) -> OpStats:
    s = _isize(dtype)
    entry = 2 * index_size + s
    bytes_moved = ((nnz_a + nnz_b) * (2 * index_size + s)  # operand reads
                   + expansion * entry * (1 + 2 * sort_passes)  # build+sort
                   + nnz_out * entry)                      # output
    return OpStats("spgemm_esc", expansion, bytes_moved, 2 * expansion)

"""Analytical performance model of the distributed ops (weak scaling).

Counterpart of :mod:`spsparse_tpu.dist.model`, with the same formulas. One
card cannot time the distributed ops at scale (a stacked mesh's
collectives are copies on one device, and a world of NCCL ranks needs a
card a rank), so the model states the scaling in full:

* ring SpMV/SpMM (``dist_spmv_bucketed`` / ``dist_spmm_bucketed``): P ring
  steps; step ``s`` overlaps the compute on bucket ``s`` (streaming the
  local entries once a full rotation) with the shift of one x/X block to
  the ring neighbour. Per-device step time = max(compute_step,
  comm_step); single-device time = the same total compute, no comm.
* weak scaling: per-device work (nnz_local, rows_local) held constant as
  P grows, so efficiency = t(1 device) / t(P devices).

The default bandwidths are the NVIDIA H100 SXM's datasheet figures, not
measurements: HBM3 at 3.35 TB/s (``hbm_gbs=3350``) and NVLink at 450 GB/s
in each direction (``ici_gbs=450``; the parameter keeps the JAX package's
name for the link between devices). Pass measured numbers where there
are any.
"""

from __future__ import annotations

import dataclasses

__all__ = ["RingModel", "ring_weak_scaling_efficiency",
           "halo_weak_scaling_efficiency", "a2a_weak_scaling_efficiency",
           "a2a_footprint_for_target", "uniform_footprint"]


@dataclasses.dataclass(frozen=True)
class RingModel:
    """Inputs: per-device workload + hardware bandwidths (GB/s; the
    defaults are H100 SXM datasheet figures)."""

    nnz_local: int            # entries per device
    rows_local: int           # rows per device (= x block length)
    n_rhs: int = 1            # dense RHS columns (1 = SpMV)
    bytes_per_entry: float = 8.0   # cols + vals streamed per entry
    dtype_bytes: float = 4.0
    hbm_gbs: float = 3350.0
    ici_gbs: float = 450.0

    def compute_time(self) -> float:
        """One full pass over the local entries + x/y traffic (seconds)."""
        bytes_local = (self.nnz_local * self.bytes_per_entry
                       + 2 * self.rows_local * self.n_rhs * self.dtype_bytes)
        return bytes_local / (self.hbm_gbs * 1e9)

    def step_comm_time(self) -> float:
        """One shift of an x/X block to the ring neighbour."""
        blk_bytes = self.rows_local * self.n_rhs * self.dtype_bytes
        return blk_bytes / (self.ici_gbs * 1e9)

    def time(self, n_devices: int) -> float:
        """Per-device wall time for the P-step overlapped ring."""
        if n_devices <= 1:
            return self.compute_time()
        step_compute = self.compute_time() / n_devices
        step = max(step_compute, self.step_comm_time())
        # P-1 overlapped steps + the final compute-only step.
        return (n_devices - 1) * step + step_compute


def ring_weak_scaling_efficiency(nnz_local: int, rows_local: int,
                                 n_devices: int, *, n_rhs: int = 1,
                                 **kw) -> float:
    """Weak-scaling efficiency of the overlapped ring at P devices:
    ``t(1) / t(P)`` with per-device workload held constant. 1.0 = perfect;
    degrades only when a block's transfer outruns one step's compute."""
    m = RingModel(nnz_local=nnz_local, rows_local=rows_local, n_rhs=n_rhs,
                  **kw)
    return m.time(1) / m.time(n_devices)


def halo_weak_scaling_efficiency(nnz_local: int, rows_local: int,
                                 halo: int, n_devices: int, *,
                                 n_rhs: int = 1, bytes_per_entry: float = 8.0,
                                 dtype_bytes: float = 4.0,
                                 hbm_gbs: float = 3350.0,
                                 ici_gbs: float = 450.0) -> float:
    """Weak-scaling efficiency of :func:`~spsparse_torch.dist.dist_spmv_halo`.

    Comm is two ``halo``-element neighbour transfers regardless of P, so
    banded matrices stay compute-bound at any device count — this is the
    model that meets the BASELINE >=80% target for the config-2 family
    (the all-pairs ring provably cannot: its per-device comm grows as
    ``(P-1) * rows_local``). Conservatively treats halo comm as serial
    (not overlapped) with compute.
    """
    if n_devices <= 1:
        return 1.0
    bytes_local = (nnz_local * bytes_per_entry
                   + 2 * rows_local * n_rhs * dtype_bytes)
    t_compute = bytes_local / (hbm_gbs * 1e9)
    t_halo = 2 * halo * n_rhs * dtype_bytes / (ici_gbs * 1e9)
    return t_compute / (t_compute + t_halo)


def a2a_weak_scaling_efficiency(nnz_local: int, rows_local: int,
                                footprint_local: int, n_devices: int, *,
                                n_rhs: int = 1,
                                bytes_per_entry: float = 8.0,
                                dtype_bytes: float = 4.0,
                                hbm_gbs: float = 3350.0,
                                ici_gbs: float = 450.0) -> float:
    """Weak-scaling efficiency of
    :func:`~spsparse_torch.dist.spmv_a2a.dist_spmv_a2a`.

    Per-device comm is the device's column FOOTPRINT (the x values its
    entries actually read) — independent of P once the footprint is, vs
    the ring's ``(P-1) * rows_local``. Owner-side gather traffic
    (``footprint * (4 + dtype)`` through HBM, symmetric send≈receive) is
    charged to compute; the all_to_all itself is conservatively serial
    with compute. Meets >=80% iff
    ``footprint <= 0.25 * t_compute * ici_bw / (n_rhs * dtype)`` — for
    the config-2 workload (11 nnz/row, 1M rows/device) and the default
    bandwidths that is a footprint of ~0.67M values/device.
    Footprint-bounded operators (regridding: footprint ~ local coupling
    width) qualify at any P; a UNIFORM-random matrix's footprint is
    ``~min(nnz_local, ncols)`` (:func:`uniform_footprint`), which cannot
    meet the target — ~0.20 at P=64 for config 2c's 2^18 rows and 10
    entries a row per device — though it still beats the ring ~4x there
    (ring: 0.047)."""
    if n_devices <= 1:
        return 1.0
    bytes_local = (nnz_local * bytes_per_entry
                   + 2 * rows_local * n_rhs * dtype_bytes)
    t_compute = bytes_local / (hbm_gbs * 1e9)
    # owner-side gather of the outgoing footprint (index + value reads)
    t_gather = footprint_local * (4.0 + dtype_bytes) * n_rhs / (hbm_gbs * 1e9)
    t_comm = footprint_local * n_rhs * dtype_bytes / (ici_gbs * 1e9)
    return t_compute / (t_compute + t_gather + t_comm)


def a2a_footprint_for_target(nnz_local: int, rows_local: int, *,
                             target: float = 0.8, n_rhs: int = 1,
                             bytes_per_entry: float = 8.0,
                             dtype_bytes: float = 4.0,
                             hbm_gbs: float = 3350.0,
                             ici_gbs: float = 450.0) -> int:
    """Largest per-device footprint that still meets ``target`` weak
    scaling under :func:`a2a_weak_scaling_efficiency` (binary search on
    the closed-form denominator)."""
    bytes_local = (nnz_local * bytes_per_entry
                   + 2 * rows_local * n_rhs * dtype_bytes)
    t_compute = bytes_local / (hbm_gbs * 1e9)
    slack = t_compute * (1.0 / target - 1.0)
    per_val = (n_rhs * ((4.0 + dtype_bytes) / (hbm_gbs * 1e9)
                        + dtype_bytes / (ici_gbs * 1e9)))
    return int(slack / per_val)


def uniform_footprint(nnz_local: int, ncols_global: int) -> int:
    """Expected distinct columns touched by ``nnz_local`` uniform-random
    draws over ``ncols_global`` columns (the a2a worst case)."""
    import math
    lam = nnz_local / max(ncols_global, 1)
    return int(ncols_global * (1.0 - math.exp(-lam)))

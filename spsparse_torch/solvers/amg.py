"""Smoothed-aggregation algebraic multigrid (AMG), the scalable
preconditioner tier, assembled from the port's own ops.

PyTorch counterpart of :mod:`spsparse_tpu.solvers.amg`. Setup is eager:
strength-of-connection filtering and greedy aggregation on the host in
numpy (the JAX package's loops, so the aggregate ids are the same element
for element), then the smoothed prolongator ``P = (I - w D^-1 A) P_t`` and
the Galerkin coarse operator ``P^T A P``, three SpGEMMs through
:func:`spsparse_torch.ops.multiply` on the operator's device, and CSR
views. Application (the V-cycle) is device code: damped-Jacobi sweeps,
``P^T r`` restriction, recursion to a dense coarsest solve with
``torch.linalg.solve``. The aggregation is three Python loops over the
rows, the setup's host cost at large n.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.algebra import coo_concat
from ..core.coo import CooBuilder, SparseCOO, numpy_dtype
from ..core.errors import SpSparseError
from ..core.structure import SparseCSR, to_csr
from ..ops.multiply_sparse import multiply
from ..ops.spmm import spmv

Tensor = torch.Tensor

__all__ = ["amg_setup", "amg_vcycle", "AmgLevel", "AmgHierarchy"]


@dataclasses.dataclass(frozen=True)
class AmgLevel:
    """One AMG level: the operator, its inverse diagonal (damped-Jacobi
    smoother), and the prolongator/restrictor pair down to the next level
    (None on the coarsest level)."""
    a: SparseCSR                  # level operator (n, n)
    dinv: Tensor                  # (n,) inverse diagonal
    p: SparseCSR | None           # prolongator (n, n_coarse)
    pt: SparseCSR | None          # restrictor P^T (n_coarse, n)


@dataclasses.dataclass(frozen=True)
class AmgHierarchy:
    """The level stack, fine to coarse, and the dense coarsest operator;
    calling it applies one V-cycle (pass it as ``minv`` to ``pcg_solve``)."""
    levels: tuple                  # tuple[AmgLevel, ...]
    coarse_dense: Tensor           # (nc, nc)
    omega: float
    pre_sweeps: int
    post_sweeps: int

    def __call__(self, r: Tensor) -> Tensor:
        return amg_vcycle(self, r)


def _strength_graph(rows, cols, vals, diag, n, theta):
    """Symmetric strength of connection: keep off-diagonal (i, j) with
    ``|a_ij| >= theta * sqrt(|a_ii a_jj|)``."""
    dd = np.sqrt(np.abs(diag[rows] * diag[cols]))
    keep = (rows != cols) & (np.abs(vals) >= theta * np.maximum(dd, 1e-300))
    return rows[keep], cols[keep]


def _greedy_aggregate(n, s_rows, s_cols):
    """Standard greedy aggregation over the strength graph. Returns
    ``(agg (n,) int64, n_agg)``, every node assigned."""
    order = np.argsort(s_rows, kind="stable")
    sr, sc = s_rows[order], s_cols[order]
    ptr = np.searchsorted(sr, np.arange(n + 1))
    agg = np.full(n, -1, dtype=np.int64)
    n_agg = 0
    # Pass 1: a node with no aggregated strong neighbour seeds an aggregate
    # of itself and all its strong neighbours.
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbr = sc[ptr[i]:ptr[i + 1]]
        if (agg[nbr] >= 0).any():
            continue
        agg[i] = n_agg
        agg[nbr] = n_agg
        n_agg += 1
    # Pass 2: an unaggregated node joins its first aggregated strong
    # neighbour's aggregate.
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbr = sc[ptr[i]:ptr[i + 1]]
        hit = nbr[agg[nbr] >= 0]
        if hit.size:
            agg[i] = agg[hit[0]]
    # Pass 3: isolated leftovers become singletons.
    for i in range(n):
        if agg[i] < 0:
            agg[i] = n_agg
            n_agg += 1
    return agg, n_agg


def _coo_from_arrays(rows, cols, vals, shape, dtype, device):
    b = CooBuilder(shape, dtype=dtype)
    b.add_many(np.stack([rows, cols], axis=1), vals)
    return b.build(device=device)


def amg_setup(a: SparseCOO, *, theta: float = 0.08, omega: float = 2 / 3,
              max_levels: int = 10, coarse_size: int = 64,
              pre_sweeps: int = 1, post_sweeps: int = 1) -> AmgHierarchy:
    """Build a smoothed-aggregation AMG hierarchy for a symmetric
    positive-definite ``a`` on its device.

    Per level: strength filter (``theta``), greedy aggregation, tentative
    piecewise-constant prolongator (columns normalized), Jacobi smoothing
    ``P = (I - omega D^-1 A) P_t`` (one SpGEMM), Galerkin ``A_c = P^T A P``
    (two more). Coarsening stops at ``coarse_size`` rows (dense-solved) or
    when aggregation stalls; a stall far above the dense-solve scale
    raises."""
    if a.rank != 2 or a.shape[0] != a.shape[1]:
        raise SpSparseError("amg_setup requires a square rank-2 operator")
    dev = a.device
    cur = a.consolidate((0, 1))
    dtype = numpy_dtype(cur.vals.dtype)
    levels = []
    for _ in range(max_levels):
        n = int(cur.shape[0])
        idx = cur.indices[:cur.nnz].cpu().numpy()
        rows = idx[:, 0].astype(np.int64)
        cols = idx[:, 1].astype(np.int64)
        vals = cur.vals[:cur.nnz].cpu().numpy().astype(dtype)
        diag = np.zeros(n, dtype)
        on_d = rows == cols
        np.add.at(diag, rows[on_d], vals[on_d])
        dinv = np.where(np.abs(diag) > 1e-300, 1.0 / diag, 1.0)

        if n <= coarse_size:
            break
        s_rows, s_cols = _strength_graph(rows, cols, vals, diag, n, theta)
        agg, n_agg = _greedy_aggregate(n, s_rows, s_cols)
        if n_agg >= n or n_agg == 0:
            break                       # aggregation stalled; stop here

        # Tentative prolongator: P_t[i, agg[i]] = 1/sqrt(|aggregate|).
        sizes = np.bincount(agg, minlength=n_agg).astype(dtype)
        pt_vals = 1.0 / np.sqrt(sizes[agg])
        p_t = _coo_from_arrays(np.arange(n), agg, pt_vals, (n, n_agg),
                               dtype, dev)
        # Smoothed prolongator (I - omega D^-1 A) P_t: S = -omega D^-1 A
        # overlaid with +1 on the diagonal, one SpGEMM.
        s_off = _coo_from_arrays(rows, cols, -omega * dinv[rows] * vals,
                                 (n, n), dtype, dev)
        eye = _coo_from_arrays(np.arange(n), np.arange(n),
                               np.ones(n, dtype), (n, n), dtype, dev)
        smoother = coo_concat(s_off, eye).consolidate((0, 1))
        p = multiply(1.0, smoother, p_t).consolidate((0, 1))
        # Galerkin coarse operator A_c = P^T A P (two SpGEMMs).
        ap = multiply(1.0, cur, p)
        a_c = multiply(1.0, p, ap, transpose_a=True).consolidate((0, 1))
        pt = p.transposed((1, 0)).consolidate((0, 1))
        levels.append(AmgLevel(a=to_csr(cur),
                               dinv=torch.from_numpy(dinv).to(dev),
                               p=to_csr(p), pt=to_csr(pt)))
        cur = a_c

    # Coarsest level: the operator for the smoother's bookkeeping, dense
    # for the direct solve.
    n = int(cur.shape[0])
    limit = max(int(coarse_size) * 8, 4096)
    if n > limit:
        raise SpSparseError(
            f"AMG coarsening stalled at {n} rows (> dense-solve limit "
            f"{limit}); lower theta, raise max_levels/coarse_size, or use a "
            f"Jacobi/block-Jacobi preconditioner for this operator")
    idxc = cur.indices[:cur.nnz].cpu().numpy()
    dense = np.zeros((n, n), dtype)
    np.add.at(dense, (idxc[:, 0], idxc[:, 1]),
              cur.vals[:cur.nnz].cpu().numpy())
    diag_c = np.diag(dense).copy()
    dinv_c = np.where(np.abs(diag_c) > 1e-300, 1.0 / diag_c, 1.0)
    levels.append(AmgLevel(a=to_csr(cur),
                           dinv=torch.from_numpy(dinv_c).to(dev),
                           p=None, pt=None))
    return AmgHierarchy(levels=tuple(levels),
                        coarse_dense=torch.from_numpy(dense).to(dev),
                        omega=float(omega), pre_sweeps=int(pre_sweeps),
                        post_sweeps=int(post_sweeps))


def _smooth(level: AmgLevel, omega, x, b, sweeps: int):
    for _ in range(sweeps):
        x = x + omega * level.dinv * (b - spmv(level.a, x))
    return x


def amg_vcycle(h: AmgHierarchy, r: Tensor) -> Tensor:
    """One V(pre,post)-cycle of the hierarchy applied to ``r`` (an
    approximation of ``A^{-1} r``). With symmetric damped-Jacobi smoothing
    and equal pre/post sweeps the cycle is a symmetric positive operator:
    safe as a CG preconditioner."""
    def cycle(k: int, b: Tensor) -> Tensor:
        lvl: AmgLevel = h.levels[k]
        if lvl.p is None:                       # coarsest: direct solve
            return torch.linalg.solve(
                h.coarse_dense, b.to(h.coarse_dense.dtype)).to(b.dtype)
        x = _smooth(lvl, h.omega, torch.zeros_like(b), b, h.pre_sweeps)
        resid = b - spmv(lvl.a, x)
        e_c = cycle(k + 1, spmv(lvl.pt, resid))
        x = x + spmv(lvl.p, e_c)
        return _smooth(lvl, h.omega, x, b, h.post_sweeps)

    return cycle(0, r)

"""Direct sparse solvers: ``splu`` / ``spilu`` / ``spsolve`` / ``factorized``
/ ``spsolve_triangular`` (the scipy.sparse.linalg surface, SuperLU
contract).

PyTorch counterpart of :mod:`spsparse_tpu.solvers.direct`. The
factorization is sequential pointer chasing and runs on the host in the
native C++ runtime (:mod:`spsparse_torch.native`: Gilbert-Peierls
left-looking LU with threshold partial pivoting, numpy fallback). A
triangular solve runs either on the host (sequential substitution,
``trisolve_host``) or on the operand's device as level sweeps: a factor
with ``nlev`` dependency levels satisfies ``(D^-1 N)^nlev = 0`` (N its
strict part), so

    x_{k+1} = D^-1 (b - N x_k)

is exact after ``nlev - 1`` sweeps. The strict part is laid out once
(``_strict_parts``): as DIA for banded factors, whose sweep is one SpMV
through :func:`spsparse_torch.ops.best_spmv` (kernel K1 for a float32
right-hand side on the card: the payload is cast to float32 for it; a
float64 one takes the plain float64 DIA product, the JAX package's route
off the TPU), as an ELL gather table, or as padded COO for skewed rows.

``method="auto"`` takes the sweeps when ``nlev <= max(64, n // 64)``, the
JAX package's rule off the TPU; its TPU branch (v5e rates) is not the
port's spec, and re-deriving the crossover on the card is ROADMAP item 14.
The JAX package's ``jax.pure_callback`` for traced callers has no
counterpart: the host solve is called directly.

Divergences from scipy (the JAX package's, kept): entries outside the
stated triangle are ignored by ``spsolve_triangular``; singular or
zero-diagonal input raises :class:`SpSparseError`; ``permc_spec`` takes
``'NATURAL'`` and ``'RCM'``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..core.coo import SparseCOO, operand_tensor
from ..core.dia import SparseDIA
from ..core.errors import SpSparseError

Tensor = torch.Tensor

__all__ = ["SparseLU", "splu", "spilu", "spsolve", "factorized",
           "spsolve_triangular"]


# ----------------------------------------------------------------------
# Host-side plumbing
# ----------------------------------------------------------------------

def _coo_to_csc_host(a: SparseCOO):
    """Host CSC triplets ``(colptr, rowind, val)`` of the live entries,
    duplicates summed in float64."""
    k = a.nnz
    idx = a.indices[:k].cpu().numpy().astype(np.int64)
    r, c = idx[:, 0], idx[:, 1]
    v = a.vals[:k].cpu().to(torch.float64).numpy()
    m = int(a.shape[1])
    order = np.lexsort((r, c))
    r, c, v = r[order], c[order], v[order]
    if r.size:
        same = (r[1:] == r[:-1]) & (c[1:] == c[:-1])
        starts = np.concatenate([[True], ~same])
        seg = np.cumsum(starts) - 1
        vv = np.zeros(int(seg[-1]) + 1, np.float64)
        np.add.at(vv, seg, v)
        r, c, v = r[starts], c[starts], vv
    colptr = np.searchsorted(c, np.arange(m + 1)).astype(np.int64)
    return colptr, r, v


def _levels_from_csc(n, colptr, rowind, *, lower: bool):
    """Dependency level of each row of a triangular CSC factor: the longest
    chain of strict-part dependencies feeding it, by a column sweep in
    elimination order."""
    lev = np.zeros(n, np.int64)
    cols = range(n) if lower else range(n - 1, -1, -1)
    for j in cols:
        lj = lev[j] + 1
        sl = rowind[colptr[j]:colptr[j + 1]]
        dep = sl[sl > j] if lower else sl[sl < j]
        np.maximum.at(lev, dep, lj)
    return lev


#: widest ELL row accepted before the sweep falls back to padded COO
_ELL_MAX_WIDTH = 128

#: most distinct diagonals accepted for the DIA sweep layout
_DIA_MAX_OFFSETS = 256


def _strict_parts(n, colptr, rowind, val, *, lower: bool):
    """The strict triangle of a CSC factor laid out for the sweeps, plus
    the diagonal (1.0 where absent; callers validate). Returns ``(kind,
    payload, diag)`` in host numpy:

    * ``'dia'``: ``(offsets, data (ndiag, n) float64)`` for banded factors
      (at most ``_DIA_MAX_OFFSETS`` diagonals, the table at most 4x the
      strict entries or 2^20 slots);
    * ``'ell'``: ``(C (n, K) int32 columns, W (n, K) weights)``, padding
      slots read ``x[0]`` with weight 0;
    * ``'coo'``: ``(rows, cols, w)`` padded to a power of two with the
      sentinel row ``n``, when a row is wider than ``_ELL_MAX_WIDTH``.
    """
    m = rowind.size
    c = (np.repeat(np.arange(n, dtype=np.int64),
                   np.diff(colptr).astype(np.int64)) if m
         else np.zeros(0, np.int64))
    r = rowind
    diag = np.ones(n, np.float64)
    on_diag = r == c
    diag[c[on_diag]] = val[on_diag]
    strict = (r > c) if lower else (r < c)
    rs, cs, vs = r[strict], c[strict], val[strict]
    counts = (np.bincount(rs, minlength=n) if rs.size
              else np.zeros(n, np.int64))
    K = int(counts.max()) if rs.size else 0
    if rs.size:
        offs = np.unique(cs - rs)
        if offs.size <= _DIA_MAX_OFFSETS and \
                offs.size * n <= max(4 * rs.size, 1 << 20):
            data = np.zeros((offs.size, n), np.float64)
            data[np.searchsorted(offs, cs - rs), rs] = vs
            return "dia", (tuple(int(o) for o in offs), data), diag
    if 0 < K <= _ELL_MAX_WIDTH:
        order = np.lexsort((cs, rs))
        rs, cs, vs = rs[order], cs[order], vs[order]
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(rs.size) - starts[rs]
        C = np.zeros((n, K), np.int32)
        W = np.zeros((n, K), np.float64)
        C[rs, slot] = cs
        W[rs, slot] = vs
        return "ell", (C, W), diag
    cap = max(1, 1 << int(np.ceil(np.log2(max(1, rs.size)))))
    pad = cap - rs.size
    rs = np.concatenate([rs, np.full(pad, n, np.int64)])      # sentinel
    cs = np.concatenate([cs, np.zeros(pad, np.int64)])
    vs = np.concatenate([vs, np.zeros(pad, np.float64)])
    return "coo", (rs, cs, vs), diag


def _sweep_solve_dia(op, di, b, nsweeps: int):
    """Banded-factor sweeps: ``N @ x`` by :func:`best_spmv` (K1 on the card
    for a float32 operand)."""
    from ..ops.spmv_kernels import best_spmv
    if b.ndim == 1:
        mv = lambda x: best_spmv(op, x)                       # noqa: E731
    else:
        mv = lambda X: torch.stack(                           # noqa: E731
            [best_spmv(op, X[:, c]) for c in range(X.shape[1])], dim=1)
    x = di * b
    for _ in range(nsweeps):
        x = di * (b - mv(x).to(b.dtype))
    return x


def _sweep_solve_ell(C, W, di, b, nsweeps: int):
    """Scatter-free sweeps over the ELL table: a gather and a row sum."""
    x = di * b
    for _ in range(nsweeps):
        g = x[C]                                   # (n, K[, k])
        nx = ((W * g).sum(dim=1) if b.ndim == 1
              else torch.einsum("ik,ikj->ij", W, g))
        x = di * (b - nx)
    return x


def _sweep_solve_coo(rows, cols, w, di, b, nsweeps: int):
    """COO sweeps (skewed rows): a gather and an ``index_add_`` whose
    sentinel row ``n`` is dropped."""
    n = b.shape[0]
    x = di * b
    for _ in range(nsweeps):
        upd = w * x[cols] if b.ndim == 1 else w[:, None] * x[cols]
        nx = torch.zeros((n + 1, *b.shape[1:]), dtype=b.dtype,
                         device=b.device).index_add_(0, rows, upd)[:n]
        x = di * (b - nx)
    return x


class _TriPlan:
    """One triangular factor, laid out for both the host and the sweeps.
    The sweep payload goes to a right-hand side's device and type on first
    use and is kept there."""

    def __init__(self, n, colptr, rowind, val, *, lower, unit_diag=False):
        self.n, self.lower, self.unit_diag = n, lower, unit_diag
        self.colptr, self.rowind, self.val = colptr, rowind, val
        lev = _levels_from_csc(n, colptr, rowind, lower=lower)
        self.nlev = int(lev.max()) + 1 if n else 0
        self.kind, self.payload, diag = _strict_parts(
            n, colptr, rowind, val, lower=lower)
        if unit_diag:
            diag = np.ones(n, np.float64)
        elif np.any(diag == 0.0):
            j = int(np.nonzero(diag == 0.0)[0][0])
            raise SpSparseError(f"singular triangular factor: zero "
                                f"diagonal at column {j}")
        self.dinv = 1.0 / diag
        self._on_device = {}

    def route(self, method: str = "auto") -> str:
        """``'device'`` or ``'host'``: ``auto`` takes the sweeps for a
        shallow factor (``nlev <= max(64, n // 64)``)."""
        if method == "auto":
            return ("device" if self.nlev <= max(64, self.n // 64)
                    else "host")
        return method

    def _device_payload(self, b: Tensor):
        """``(operand, dinv)`` on ``b``'s device: the DIA strict part in
        float64 for a float64 ``b`` and as a float32 ``PreparedDIA`` (K1's
        operand) otherwise; ELL and COO tables in ``b``'s type."""
        from ..ops.dia_stream import prepare_dia
        key = (b.device, b.dtype)
        if key not in self._on_device:
            dev, dt = b.device, b.dtype
            if self.kind == "dia":
                offs, data = self.payload
                dia = SparseDIA(data=torch.from_numpy(data).to(dev),
                                offsets=offs, shape=(self.n, self.n))
                op = dia if dt == torch.float64 else prepare_dia(dia)
            elif self.kind == "ell":
                C, W = self.payload
                op = (torch.from_numpy(C).to(dev).long(),
                      torch.from_numpy(W).to(dev, dt))
            else:
                rs, cs, vs = self.payload
                op = (torch.from_numpy(rs).to(dev),
                      torch.from_numpy(cs).to(dev),
                      torch.from_numpy(vs).to(dev, dt))
            self._on_device[key] = (op, torch.from_numpy(self.dinv).to(
                dev, dt))
        return self._on_device[key]

    def solve(self, b: Tensor, method: str = "auto") -> Tensor:
        if self.route(method) == "device":
            ns = max(self.nlev - 1, 0)
            op, dinv = self._device_payload(b)
            di = dinv if b.ndim == 1 else dinv[:, None]
            if self.kind == "dia":
                return _sweep_solve_dia(op, di, b, ns)
            if self.kind == "ell":
                return _sweep_solve_ell(*op, di, b, ns)
            return _sweep_solve_coo(*op, di, b, ns)
        host = b.cpu().to(torch.float64).numpy()
        x = native.trisolve_host(self.n, self.colptr, self.rowind, self.val,
                                 host, lower=self.lower,
                                 unit_diagonal=self.unit_diag)
        return torch.from_numpy(np.ascontiguousarray(x)).to(b.device,
                                                            b.dtype)


# ----------------------------------------------------------------------
# Public API
# ----------------------------------------------------------------------

class SparseLU:
    """LU factorization of a square sparse matrix
    (scipy.sparse.linalg.SuperLU contract): ``Pr @ A @ Pc = L @ U`` with
    ``Pr[perm_r, arange(n)] = 1`` and ``Pc[arange(n), perm_c] = 1``. ``L``
    is unit lower triangular, ``U`` upper triangular, both
    :class:`SparseCOO` on ``a``'s device; ``perm_r``/``perm_c`` are host
    int64 arrays."""

    def __init__(self, a: SparseCOO, permc_spec: str = "NATURAL",
                 pivot_threshold: float = 1.0, solve_method: str = "auto",
                 drop_tol: float = 0.0, fill_factor: float | None = None):
        if a.rank != 2 or a.shape[0] != a.shape[1]:
            raise SpSparseError(f"splu needs a square rank-2 matrix, "
                                f"got {a.shape}")
        n = int(a.shape[0])
        self.shape = (n, n)
        self.device = a.device
        colptr, rowind, val = _coo_to_csc_host(a)
        if permc_spec == "NATURAL":
            pc = np.arange(n, dtype=np.int64)
        elif permc_spec == "RCM":
            from ..core.reorder import rcm_permutation
            pc = np.asarray(rcm_permutation(a), np.int64)
        else:
            raise SpSparseError(
                f"permc_spec must be 'NATURAL' or 'RCM', got {permc_spec!r}")
        max_keep = -1
        if fill_factor is not None:
            # per-column budget: fill_factor x the average column fill of
            # A, for L and U each (SuperLU-spilu semantics)
            max_keep = max(1, int(np.ceil(
                fill_factor * max(1, rowind.size) / max(1, n))))
        try:
            (lcp, lri, lv), (ucp, uri, uv), pr = native.lu_factor_host(
                n, colptr, rowind, val, pc, pivot_threshold,
                drop_tol=drop_tol, max_keep_l=max_keep,
                max_keep_u=max_keep)
        except ValueError as e:
            raise SpSparseError(f"splu: {e}") from None
        self._solve_method = solve_method
        self._pr_internal = pr           # LU row i <- A row pr[i]
        self._pc_internal = pc           # LU col jj <- A col pc[jj]
        # scipy orientation: the inverses of the "LU axis <- A axis" maps.
        self.perm_r = np.argsort(pr).astype(np.int64)
        self.perm_c = np.argsort(pc).astype(np.int64)
        self._lplan = _TriPlan(n, lcp, lri, lv, lower=True, unit_diag=True)
        self._uplan = _TriPlan(n, ucp, uri, uv, lower=False)
        self._lt = self._ut = None       # transpose plans, built on use
        self._perm_on = {}
        self.nnz = int(lri.size + n + uri.size)

    # -- factor views ---------------------------------------------------
    def _factor_coo(self, colptr, rowind, val, *, with_unit_diag):
        n = self.shape[0]
        c = np.repeat(np.arange(n, dtype=np.int64),
                      np.diff(colptr).astype(np.int64))
        r, v = rowind, val
        if with_unit_diag:
            d = np.arange(n, dtype=np.int64)
            r = np.concatenate([r, d])
            c = np.concatenate([c, d])
            v = np.concatenate([v, np.ones(n)])
        idx = np.stack([r, c], axis=1)
        return SparseCOO.from_arrays(idx, v, self.shape,
                                     device=self.device).consolidate()

    @property
    def L(self) -> SparseCOO:
        return self._factor_coo(self._lplan.colptr, self._lplan.rowind,
                                self._lplan.val, with_unit_diag=True)

    @property
    def U(self) -> SparseCOO:
        return self._factor_coo(self._uplan.colptr, self._uplan.rowind,
                                self._uplan.val, with_unit_diag=False)

    # -- solves ----------------------------------------------------------
    def _transpose_plans(self):
        if self._lt is None:
            n = self.shape[0]

            def transpose_csc(colptr, rowind, val):
                c = np.repeat(np.arange(n, dtype=np.int64),
                              np.diff(colptr).astype(np.int64))
                order = np.lexsort((c, rowind))
                nr, nc, nv = c[order], rowind[order], val[order]
                ncp = np.searchsorted(nc, np.arange(n + 1)).astype(np.int64)
                return ncp, nr, nv

            lt = transpose_csc(self._lplan.colptr, self._lplan.rowind,
                               self._lplan.val)
            ut = transpose_csc(self._uplan.colptr, self._uplan.rowind,
                               self._uplan.val)
            self._lt = _TriPlan(n, *lt, lower=False, unit_diag=True)
            self._ut = _TriPlan(n, *ut, lower=True)
        return self._lt, self._ut

    def _perms(self, dev):
        if dev not in self._perm_on:
            self._perm_on[dev] = (torch.from_numpy(self._pr_internal).to(dev),
                                  torch.from_numpy(self._pc_internal).to(dev))
        return self._perm_on[dev]

    def solve(self, b, trans: str = "N") -> Tensor:
        """Solve ``A x = b`` (``trans='N'``) or ``A^T x = b``
        (``'T'``/``'H'``); ``b``: (n,) or (n, k), a tensor (which stays on
        its device) or host data (to the matrix's device)."""
        b = operand_tensor(b, self.device)
        if b.shape[0] != self.shape[0]:
            raise SpSparseError(f"solve: b has leading dim {b.shape[0]}, "
                                f"matrix is {self.shape}")
        m = self._solve_method
        pr, pc = self._perms(b.device)
        if trans == "N":
            # A = Pr^T L U Pc^T  =>  L U z = b[pr], x[pc] = z
            z = self._uplan.solve(self._lplan.solve(b[pr], m), m)
            return torch.zeros_like(z).index_copy_(0, pc, z)
        if trans in ("T", "H"):
            lt, ut = self._transpose_plans()
            v = lt.solve(ut.solve(b[pc], m), m)
            return torch.zeros_like(v).index_copy_(0, pr, v)
        raise SpSparseError(f"trans must be 'N', 'T' or 'H', got {trans!r}")

    def __call__(self, b):
        return self.solve(b)


def splu(a: SparseCOO, *, permc_spec: str = "NATURAL",
         pivot_threshold: float = 1.0,
         solve_method: str = "auto") -> SparseLU:
    """LU-factor a square sparse matrix (scipy.sparse.linalg.splu): the
    factorization on the host, :meth:`SparseLU.solve` by host substitution
    or device sweeps (module docstring)."""
    return SparseLU(a, permc_spec=permc_spec,
                    pivot_threshold=pivot_threshold,
                    solve_method=solve_method)


def spilu(a: SparseCOO, *, drop_tol: float = 1e-4,
          fill_factor: float = 10.0, permc_spec: str = "NATURAL",
          pivot_threshold: float = 1.0,
          solve_method: str = "auto") -> SparseLU:
    """Incomplete LU (scipy.sparse.linalg.spilu, SuperLU ILUTP contract):
    U entries below ``drop_tol * ||A[:, j]||`` and L multipliers below
    ``drop_tol`` are dropped, and each factor column keeps at most
    ``fill_factor * nnz(A)/n`` entries. ``ilu.solve`` is the
    preconditioner ``M^-1`` for ``pcg_solve``/``bicgstab_solve``."""
    return SparseLU(a, permc_spec=permc_spec,
                    pivot_threshold=pivot_threshold,
                    solve_method=solve_method, drop_tol=drop_tol,
                    fill_factor=fill_factor)


def factorized(a: SparseCOO, **kw):
    """Pre-factorized solver callable (scipy.sparse.linalg.factorized)."""
    return splu(a, **kw).solve


def spsolve(a: SparseCOO, b, **kw):
    """Direct solve ``A x = b`` (scipy.sparse.linalg.spsolve): a dense
    ``b`` gives a dense tensor, a :class:`SparseCOO` ``b`` a
    :class:`SparseCOO`."""
    lu = splu(a, **kw)
    if isinstance(b, SparseCOO):
        return SparseCOO.from_dense(lu.solve(b.to_dense()))
    return lu.solve(b)


def spsolve_triangular(a: SparseCOO, b, *, lower: bool = True,
                       unit_diagonal: bool = False,
                       method: str = "auto") -> Tensor:
    """Solve a triangular system (scipy.sparse.linalg.spsolve_triangular).
    Only the stated triangle is read. ``method``: ``'device'`` forces the
    sweeps, ``'host'`` the sequential substitution, ``'auto'`` picks by
    level depth. ``b`` stays on its device (host data goes to ``a``'s)."""
    if a.rank != 2 or a.shape[0] != a.shape[1]:
        raise SpSparseError(f"spsolve_triangular needs a square matrix, "
                            f"got {a.shape}")
    n = int(a.shape[0])
    colptr, rowind, val = _coo_to_csc_host(a)
    c = np.repeat(np.arange(n, dtype=np.int64),
                  np.diff(colptr).astype(np.int64))
    keep = (rowind >= c) if lower else (rowind <= c)
    rowind, val, c = rowind[keep], val[keep], c[keep]
    colptr = np.searchsorted(c, np.arange(n + 1)).astype(np.int64)
    plan = _TriPlan(n, colptr, rowind, val, lower=lower,
                    unit_diag=unit_diagonal)
    if not unit_diagonal:
        # every diagonal entry must be stored (scipy contract)
        present = np.zeros(n, bool)
        present[c[rowind == c]] = True
        if not present.all():
            j = int(np.nonzero(~present)[0][0])
            raise SpSparseError(
                f"spsolve_triangular: missing diagonal at column {j}")
    return plan.solve(operand_tensor(b, a.device), method)

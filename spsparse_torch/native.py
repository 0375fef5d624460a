"""ctypes binding to the native host runtime (``csrc/spsparse_host.cpp``,
``csrc/spsparse_lu.cpp``).

PyTorch-port counterpart of :mod:`spsparse_tpu.native`, a copy of its
binding and numpy fallbacks (this module imports neither JAX nor the JAX
package). The C++ library runs the host-side phases: consolidate (stable
sort + duplicate merge), present-row beginnings, CSR row pointers, bounds
checks, the sparse LU factorization (Gilbert-Peierls, threshold partial
pivoting, optional ILUT drops) and sequential CSC triangular solves.

Build. On first use the two sources are compiled by one ``g++`` into
``spsparse_torch/_kernels/host-<hash>/libspsparse_host.so``, keyed by a
hash of the sources, the flags and the machine like the CUDA kernels of
:mod:`spsparse_torch.backend`, and renamed into place so that a build cut
off halfway never leaves a library that loads. It is built without
``-march=native`` (a checkout may be copied to another host's CPU), but
with ``-mfma`` on an x86-64 CPU that has FMA: ``csrc/Makefile`` builds
with ``-march=native``, under which g++ contracts three multiply-adds of
the LU into FMAs, and the factors equal the JAX package's bit for bit only
when the same multiply-adds are fused. The tracked
``csrc/libspsparse_host.so`` is never loaded and ``csrc/`` is never
written. Nothing is built when this module is imported.

When ``g++`` or the build is unavailable, every entry point falls back to
its numpy version with the same contract (host code, not kernels), as in
the JAX package; :func:`available` says which one runs.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

import numpy as np

from .core.errors import DuplicatePolicy

logger = logging.getLogger("spsparse_torch.native")

__all__ = ["available", "build", "consolidate_host", "dim_beginnings_host",
           "csr_row_ptr_host", "check_bounds_host",
           "lu_factor_host", "trisolve_host"]

SOURCES = tuple(Path(__file__).resolve().parent.parent / "csrc" / name
                for name in ("spsparse_host.cpp", "spsparse_lu.cpp"))
KERNEL_DIR = Path(__file__).resolve().parent / "_kernels"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
_LIB_NAME = "libspsparse_host.so"


def _flags() -> tuple:
    """``CXX_FLAGS``, plus ``-mfma`` on an x86-64 CPU with FMA."""
    if platform.machine() in ("x86_64", "AMD64"):
        try:
            with open("/proc/cpuinfo") as f:
                if " fma" in f.read():
                    return (*CXX_FLAGS, "-mfma")
        except OSError:
            pass
    return CXX_FLAGS


def _source_hash() -> str:
    h = hashlib.sha256(" ".join((platform.machine(), *_flags())).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the host library into its hash-keyed directory (a no-op when
    it is there). Raises ``RuntimeError`` when ``g++`` is missing or the
    compile fails."""
    out_dir = KERNEL_DIR / f"host-{_source_hash()}"
    lib = out_dir / _LIB_NAME
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("spsparse_torch.native: no C++ compiler (g++)")
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = os.path.join(tmp, _LIB_NAME)
        cmd = [cxx, *_flags(), "-o", tmp_lib, *map(str, SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"spsparse_torch.native: {' '.join(cmd)} "
                               f"failed:\n{proc.stderr}")
        os.replace(tmp_lib, lib)
    return lib


@functools.lru_cache(maxsize=1)
def _lib():
    """Load (building if needed) the native library; None if unavailable."""
    try:
        lib = ctypes.CDLL(str(build()))
    except Exception as e:  # toolchain-dependent
        logger.info("native host library unavailable (%s); using numpy", e)
        return None
    i64p, f64p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(
        ctypes.c_double)
    i64, i32, f64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_double
    sig = {
        "spsparse_consolidate_f64": (i64, [
            i64p, f64p, i64, i32, i64p, ctypes.POINTER(i32), i32, i32, i32,
            i64p, f64p]),
        "spsparse_dim_beginnings_i64": (i64, [i64p, i64, i64p, i64p]),
        "spsparse_csr_row_ptr": (None, [i64p, i64, i64, i64p]),
        "spsparse_check_bounds": (i64, [i64p, i64, i32, i64p]),
        "spsparse_lu_factor_ex_f64": (ctypes.c_void_p, [
            i64, i64p, i64p, f64p, i64p, f64, f64, i64, i64, i64p]),
        "spsparse_lu_nnz_l": (i64, [ctypes.c_void_p]),
        "spsparse_lu_nnz_u": (i64, [ctypes.c_void_p]),
        "spsparse_lu_get": (None, [ctypes.c_void_p, i64p, i64p, f64p, i64p,
                                   i64p, f64p, i64p]),
        "spsparse_lu_free": (None, [ctypes.c_void_p]),
        "spsparse_trisolve_csc_f64": (i64, [i64, i64p, i64p, f64p, i32, i32,
                                            f64p, i64, i64]),
    }
    for name, (res, args) in sig.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def available() -> bool:
    """True when the native library built and loaded (else numpy runs)."""
    return _lib() is not None


def _p64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _pf64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _p32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _numpy_consolidate(indices, vals, shape, sort_order, policy, zero_nan):
    """Pure-numpy fallback (same contract)."""
    keep = vals != 0
    if zero_nan:
        keep &= ~np.isnan(vals)
    idx = indices[keep]
    v = vals[keep]
    if idx.shape[0] == 0:
        return idx.reshape(0, indices.shape[1]), v
    order = np.lexsort(tuple(idx[:, d] for d in reversed(sort_order)))
    idx, v = idx[order], v[order]
    same = np.all(idx[1:] == idx[:-1], axis=1)
    starts = np.concatenate([[True], ~same])
    seg = np.cumsum(starts) - 1
    out_idx = idx[starts]
    if policy == DuplicatePolicy.ADD:
        out_v = np.zeros(out_idx.shape[0], v.dtype)
        np.add.at(out_v, seg, v)
    elif policy == DuplicatePolicy.LEAVE_ALONE:
        out_v = v[starts]
    else:  # REPLACE: last of each run
        ends = np.concatenate([starts[1:], [True]])
        out_v = v[ends]
    return out_idx, out_v


def consolidate_host(
    indices, vals, shape: Sequence[int],
    sort_order: Sequence[int] | None = None,
    duplicate_policy: DuplicatePolicy = DuplicatePolicy.ADD,
    zero_nan: bool = False, n_threads: int | None = None,
):
    """Host consolidate: compact ``(indices (m, rank), vals (m,))`` numpy
    arrays sorted by ``sort_order``, duplicates merged in float64 in
    insertion order."""
    indices = np.ascontiguousarray(np.asarray(indices, np.int64))
    if indices.ndim == 1:
        indices = indices[:, None]
    vals = np.ascontiguousarray(np.asarray(vals, np.float64))
    n, rank = indices.shape
    sort_order = tuple(sort_order or range(rank))
    lib = _lib()
    if lib is not None and n:
        out_idx = np.empty_like(indices)
        out_vals = np.empty_like(vals)
        shape_a = np.asarray(shape, np.int64)
        so_a = np.asarray(sort_order, np.int32)
        nt = n_threads if n_threads is not None else (os.cpu_count() or 1)
        m = lib.spsparse_consolidate_f64(
            _p64(indices), _pf64(vals), n, rank, _p64(shape_a), _p32(so_a),
            int(duplicate_policy.value), int(bool(zero_nan)), int(nt),
            _p64(out_idx), _pf64(out_vals))
        if m >= 0:
            return out_idx[:m].copy(), out_vals[:m].copy()
        logger.info("native consolidate declined input; numpy fallback")
    return _numpy_consolidate(indices, vals, shape, sort_order,
                              duplicate_policy, zero_nan)


def dim_beginnings_host(lead):
    """Present-rows begins (+sentinel) and row ids from a sorted lead
    column."""
    lead = np.ascontiguousarray(np.asarray(lead, np.int64))
    n = lead.shape[0]
    lib = _lib()
    if lib is not None:
        begins = np.empty(n + 1, np.int64)
        rows = np.empty(max(n, 1), np.int64)
        r = lib.spsparse_dim_beginnings_i64(_p64(lead), n, _p64(begins),
                                            _p64(rows))
        return begins[: r + 1].copy(), rows[:r].copy()
    if n == 0:
        return np.zeros(1, np.int64), np.zeros(0, np.int64)
    starts = np.concatenate([[True], lead[1:] != lead[:-1]])
    begins = np.concatenate([np.nonzero(starts)[0], [n]]).astype(np.int64)
    return begins, lead[starts]


def csr_row_ptr_host(rows, nrows: int):
    """CSR row pointer ``(nrows + 1,)`` of sorted row ids."""
    rows = np.ascontiguousarray(np.asarray(rows, np.int64))
    lib = _lib()
    if lib is not None:
        out = np.empty(nrows + 1, np.int64)
        lib.spsparse_csr_row_ptr(_p64(rows), rows.shape[0], nrows, _p64(out))
        return out
    return np.searchsorted(rows, np.arange(nrows + 1)).astype(np.int64)


def check_bounds_host(indices, shape) -> int:
    """Index of the first out-of-bounds entry, or -1."""
    indices = np.ascontiguousarray(np.asarray(indices, np.int64))
    if indices.ndim == 1:
        indices = indices[:, None]
    lib = _lib()
    shape_a = np.asarray(shape, np.int64)
    if lib is not None:
        return int(lib.spsparse_check_bounds(
            _p64(indices), indices.shape[0], indices.shape[1], _p64(shape_a)))
    bad = (indices < 0) | (indices >= shape_a)
    rows = np.nonzero(bad.any(axis=1))[0]
    return int(rows[0]) if rows.size else -1


def _to_csc(M, n):
    cp, ri, v = [0], [], []
    for j in range(n):
        nz = np.nonzero(M[:, j])[0]
        ri.extend(nz.tolist())
        v.extend(M[nz, j].tolist())
        cp.append(len(ri))
    return (np.asarray(cp, np.int64), np.asarray(ri, np.int64),
            np.asarray(v, np.float64))


def _numpy_lu(n, colptr, rowind, val, perm_c, pivot_threshold):
    """Dense partial-pivot LU fallback (O(n^3)); the native factor's output
    contract. Only sensible for small n."""
    A = np.zeros((n, n))
    for j in range(n):
        for p in range(colptr[j], colptr[j + 1]):
            A[rowind[p], j] += val[p]
    A = A[:, perm_c]
    piv = np.arange(n)
    for k in range(n):
        col = np.abs(A[k:, k])
        if col.max() == 0:
            return None, k
        m = k + int(np.argmax(col))
        if np.abs(A[k, k]) >= pivot_threshold * col.max() and A[k, k] != 0:
            m = k
        if m != k:
            A[[k, m]] = A[[m, k]]
            piv[[k, m]] = piv[[m, k]]
        A[k + 1:, k] /= A[k, k]
        A[k + 1:, k + 1:] -= np.outer(A[k + 1:, k], A[k, k + 1:])
    return (_to_csc(np.tril(A, -1), n), _to_csc(np.triu(A), n),
            piv.astype(np.int64)), -1


def _drop(n, cp, ri, v, tol_per_col, keep, protect_diag):
    """Post-hoc ILUT drop rule of the numpy fallback, column by column."""
    ncp, nri, nv = [0], [], []
    for j in range(n):
        lo, hi = cp[j], cp[j + 1]
        r, x = ri[lo:hi], v[lo:hi]
        is_diag = (r == j) if protect_diag else np.zeros(r.size, bool)
        ok = is_diag | (np.abs(x) >= tol_per_col[j])
        if keep >= 0 and ok.sum() > keep + is_diag.sum():
            mag = np.where(is_diag, np.inf, np.abs(x))
            thresh = np.sort(mag[ok])[::-1][keep + is_diag.sum() - 1]
            ok &= mag >= thresh
        nri.extend(r[ok].tolist())
        nv.extend(x[ok].tolist())
        ncp.append(len(nri))
    return (np.asarray(ncp, np.int64), np.asarray(nri, np.int64),
            np.asarray(nv, np.float64))


def lu_factor_host(n: int, colptr, rowind, val, perm_c=None,
                   pivot_threshold: float = 1.0, drop_tol: float = 0.0,
                   max_keep_l: int = -1, max_keep_u: int = -1):
    """Sparse LU of CSC input: ``A[:, perm_c] = P^T L U``. Returns
    ``((l_colptr, l_rowind, l_val), (u_colptr, u_rowind, u_val), perm_r)``:
    L unit-diagonal (diagonal not stored), U with its diagonal, both CSC in
    pivoted row coordinates. Raises ``ValueError`` naming the failing
    column when singular. ``drop_tol``/``max_keep_l``/``max_keep_u``
    select incomplete (ILUT) factorization (csrc/spsparse_lu.cpp); the
    numpy fallback applies the drop rules post hoc to the exact factors."""
    colptr = np.ascontiguousarray(colptr, np.int64)
    rowind = np.ascontiguousarray(rowind, np.int64)
    val = np.ascontiguousarray(val, np.float64)
    pc = np.ascontiguousarray(
        perm_c if perm_c is not None else np.arange(n), np.int64)
    lib = _lib()
    if lib is not None:
        info = np.empty(1, np.int64)
        h = lib.spsparse_lu_factor_ex_f64(
            n, _p64(colptr), _p64(rowind), _pf64(val), _p64(pc),
            float(pivot_threshold), float(drop_tol), int(max_keep_l),
            int(max_keep_u), _p64(info))
        if not h:
            raise ValueError(f"matrix is singular at column {int(info[0])}")
        try:
            nl = lib.spsparse_lu_nnz_l(h)
            nu = lib.spsparse_lu_nnz_u(h)
            lcp = np.empty(n + 1, np.int64)
            lri = np.empty(max(nl, 1), np.int64)
            lv = np.empty(max(nl, 1), np.float64)
            ucp = np.empty(n + 1, np.int64)
            uri = np.empty(max(nu, 1), np.int64)
            uv = np.empty(max(nu, 1), np.float64)
            pr = np.empty(n, np.int64)
            lib.spsparse_lu_get(h, _p64(lcp), _p64(lri), _pf64(lv),
                                _p64(ucp), _p64(uri), _pf64(uv), _p64(pr))
        finally:
            lib.spsparse_lu_free(h)
        return ((lcp, lri[:nl], lv[:nl]), (ucp, uri[:nu], uv[:nu]), pr)
    out, bad = _numpy_lu(n, colptr, rowind, val, pc, pivot_threshold)
    if out is None:
        raise ValueError(f"matrix is singular at column {bad}")
    if drop_tol > 0.0 or max_keep_l >= 0 or max_keep_u >= 0:
        (lcp, lri, lv), (ucp, uri, uv), pr = out
        colnorm = np.zeros(n)
        np.add.at(colnorm, np.repeat(np.arange(n), np.diff(colptr)),
                  val ** 2)
        colnorm = np.sqrt(colnorm)[pc]
        out = (_drop(n, lcp, lri, lv, np.full(n, drop_tol), max_keep_l,
                     False),
               _drop(n, ucp, uri, uv, drop_tol * colnorm, max_keep_u, True),
               pr)
    return out


def trisolve_host(n: int, colptr, rowind, val, b, *, lower: bool,
                  unit_diagonal: bool = False):
    """Sequential CSC triangular solve on the host (the route for deep
    factors, :mod:`spsparse_torch.solvers.direct`). ``b``: (n,) or (n, k);
    returns the solution with b's trailing shape. Raises ``ValueError`` on
    a zero or missing diagonal."""
    colptr = np.ascontiguousarray(colptr, np.int64)
    rowind = np.ascontiguousarray(rowind, np.int64)
    val = np.ascontiguousarray(val, np.float64)
    b = np.asarray(b, np.float64)
    squeeze = b.ndim == 1
    # Always a copy: the C routine solves in place and must never alias the
    # caller's buffer (a reshaped 1-D b is a contiguous view).
    B = np.array(b.reshape(n, -1).T, np.float64, order="C", copy=True)
    lib = _lib()
    if lib is not None:
        r = lib.spsparse_trisolve_csc_f64(
            n, _p64(colptr), _p64(rowind), _pf64(val),
            int(bool(lower)), int(bool(unit_diagonal)),
            _pf64(B), B.shape[0], n)
        if r >= 0:
            raise ValueError(f"zero diagonal at column {int(r)}")
    else:
        for x in B:
            cols = range(n) if lower else range(n - 1, -1, -1)
            for j in cols:
                lo, hi = colptr[j], colptr[j + 1]
                rs, vs = rowind[lo:hi], val[lo:hi]
                if not unit_diagonal:
                    dm = rs == j
                    if not dm.any() or vs[dm][0] == 0:
                        raise ValueError(f"zero diagonal at column {j}")
                    x[j] /= vs[dm][0]
                off = rs > j if lower else rs < j
                x[rs[off]] -= vs[off] * x[j]
    out = B.T
    return out[:, 0] if squeeze else out.reshape(b.shape)

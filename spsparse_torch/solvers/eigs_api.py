"""scipy-signature spectral entry points: ``eigs`` / ``eigsh`` with
shift-invert (``sigma=``), a thin dispatch over the engines of
:mod:`spsparse_torch.solvers.spectral` and the direct tier.

PyTorch counterpart of :mod:`spsparse_tpu.solvers.eigs_api`. Pass a
:class:`SparseCOO` (or a :class:`~spsparse_torch.solvers.LinearOperator`,
or a bare matvec) instead of wiring matvec closures, and pass ``sigma`` for
interior eigenvalues through the shift-invert composition: the inner
``(A - sigma I)^-1`` is the native LU (:func:`~.direct.splu`, RCM column
order), factored once on the host and applied once a Krylov step. Real
shifts only (the factorization is real float64), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.algebra import coo_add, coo_scale
from ..core.construct import coo_eye
from ..core.coo import SparseCOO
from ..core.device import resolve_device
from ..core.errors import SpSparseError
from .direct import splu
from .spectral import arnoldi_eigs, lanczos_eigsh

__all__ = ["eigs", "eigsh"]


def _as_matvec(A):
    """``(matvec, n)`` from a SparseCOO, a LinearOperator or a callable."""
    if isinstance(A, SparseCOO):
        from ..core.structure import to_csr
        from ..ops.spmm import spmv
        if A.rank != 2 or A.shape[0] != A.shape[1]:
            raise SpSparseError(f"eigs needs a square matrix, "
                                f"got {A.shape}")
        csr = to_csr(A)
        return (lambda v: spmv(csr, v)), int(A.shape[0])
    shape = getattr(A, "shape", None)
    if callable(A):
        n = int(shape[0]) if shape else None
        return A, n
    raise SpSparseError("eigs: A must be a SparseCOO, LinearOperator or "
                        "matvec callable")


def _shifted_lu(A: SparseCOO, sigma: float):
    if not isinstance(A, SparseCOO):
        raise SpSparseError("sigma (shift-invert) requires a SparseCOO "
                            "matrix — the inner solve factorizes A - "
                            "sigma*I with the native LU")
    n = int(A.shape[0])
    shifted = coo_add(A, coo_scale(coo_eye(n, dtype=np.float64,
                                           device=A.device),
                                   -float(sigma)))
    return splu(shifted, permc_spec="RCM")


def _v0(v0, n, A, seed=0):
    """The start vector: ``v0``, else float64 normals from
    ``default_rng(seed)`` on ``A``'s device (the card for a callable)."""
    if v0 is not None:
        return v0 if isinstance(v0, torch.Tensor) else torch.as_tensor(
            np.asarray(v0), device=_device(A))
    if n is None:
        raise SpSparseError("pass v0= when A is a bare matvec with no "
                            ".shape")
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(n)).to(_device(A))


def _device(A):
    return A.device if isinstance(A, SparseCOO) else resolve_device(None)


def _dedupe_top(lam, key, k):
    """The first k indices in ``key`` order whose values differ from every
    earlier pick by more than ``1e-9 * max(1, |lam|)``."""
    sel = []
    for i in np.argsort(key, kind="stable"):
        if any(abs(lam[i] - lam[j]) < 1e-9 * max(1.0, abs(lam[i]))
               for j in sel):
            continue
        sel.append(i)
        if len(sel) == k:
            break
    return np.asarray(sel)


def eigs(A, k: int = 6, *, sigma: float | None = None, which: str = "LM",
         v0=None, ncv: int | None = None, restarts: int = 8,
         tol: float = 1e-10, return_eigenvectors: bool = True):
    """``k`` eigenpairs of a general square operator
    (scipy.sparse.linalg.eigs signature) by the restarted Arnoldi engine;
    with ``sigma``, of ``(A - sigma I)^-1`` (``which`` applies to the
    transformed values, scipy's convention), mapped back ``lam = sigma +
    1/theta``. Returns numpy arrays, as the engine does."""
    mv, n = _as_matvec(A)
    if sigma is None:
        vals, vecs = arnoldi_eigs(mv, _v0(v0, n, A), k=k, which=which,
                                  iters=ncv, restarts=restarts, tol=tol)
    else:
        lu = _shifted_lu(A, sigma)
        theta, vecs = arnoldi_eigs(lu.solve, _v0(v0, int(A.shape[0]), A),
                                   k=k, which=which, iters=ncv,
                                   restarts=restarts, tol=tol)
        vals = sigma + 1.0 / theta
    return (vals, vecs) if return_eigenvectors else vals


def eigsh(A, k: int = 6, *, sigma: float | None = None,
          which: str = "LM", v0=None, ncv: int | None = None,
          return_eigenvectors: bool = True):
    """``k`` eigenpairs of a symmetric operator (scipy.sparse.linalg.eigsh
    signature; engine :func:`~.spectral.lanczos_eigsh`).

    ``which``: ``'LA'``/``'SA'``, or ``'LM'`` (both spectrum ends, the k
    largest ``|lam|``). ``'SM'`` without ``sigma`` is refused; pass the
    shift instead. With ``sigma``: shift-invert through the native LU,
    the eigenvalues nearest ``sigma``, ascending. Returns tensors on the
    start vector's device."""
    mv, n = _as_matvec(A)
    ncv_eff = ncv or (min(max(6 * k + 40, 64), n) if n else None)
    if sigma is not None:
        lu = _shifted_lu(A, sigma)
        nn = int(A.shape[0])
        ncv_eff = ncv or min(max(6 * k + 40, 64), nn)
        # theta = 1/(lam - sigma): the wanted pairs have the largest
        # |theta|, on either side of zero, so take both ends.
        ta, ua = lanczos_eigsh(lu.solve, _v0(v0, nn, A), k=k,
                               iters=ncv_eff, which="LA")
        ts, us = lanczos_eigsh(lu.solve, _v0(v0, nn, A, seed=1), k=k,
                               iters=ncv_eff, which="SA")
        theta = np.concatenate([ta.cpu().numpy(), ts.cpu().numpy()])
        U = torch.cat([ua, us], dim=1)
        ok = np.abs(theta) > 1e-300
        lam = np.where(ok, sigma + 1.0 / np.where(ok, theta, 1.0), np.inf)
        sel = _dedupe_top(lam, np.abs(lam - sigma), k)
        asc = sel[np.argsort(lam[sel])]
        vals = torch.from_numpy(lam[asc]).to(U.device)
        return (vals, U[:, torch.from_numpy(asc).to(U.device)]
                ) if return_eigenvectors else vals
    if which in ("LA", "SA"):
        vals, vecs = lanczos_eigsh(mv, _v0(v0, n, A), k=k, iters=ncv_eff,
                                   which=which)
    elif which == "LM":
        va, ua = lanczos_eigsh(mv, _v0(v0, n, A), k=k, iters=ncv_eff,
                               which="LA")
        vs, us = lanczos_eigsh(mv, _v0(v0, n, A, seed=1), k=k,
                               iters=ncv_eff, which="SA")
        allv = np.concatenate([va.cpu().numpy(), vs.cpu().numpy()])
        allu = torch.cat([ua, us], dim=1)
        # pairs found from both ends deduplicated, then top-k by magnitude
        sel = _dedupe_top(allv, -np.abs(allv), k)
        asc = sel[np.argsort(allv[sel])]
        vals = torch.from_numpy(allv[asc]).to(allu.device)
        vecs = allu[:, torch.from_numpy(asc).to(allu.device)]
    elif which == "SM":
        raise SpSparseError("eigsh(which='SM') without sigma is the "
                            "slow-converging ARPACK trap; pass "
                            "sigma=0.0 for the shift-invert route")
    else:
        raise SpSparseError(f"which must be LA/SA/LM/SM, got {which!r}")
    return (vals, vecs) if return_eigenvectors else vals

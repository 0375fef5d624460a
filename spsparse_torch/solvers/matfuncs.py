"""Sparse matrix functions: ``inv`` and ``expm`` (scipy.sparse.linalg
parity; for the action ``f(A) @ v`` use
:func:`spsparse_torch.solvers.expm_multiply` / ``funm_multiply``).

PyTorch counterpart of :mod:`spsparse_tpu.solvers.matfuncs`. ``expm`` is
Higham's (2005) scaling-and-squaring Pade-13 algorithm, as scipy's: the
degree chosen by 1-norm thresholds, the matrix products through
:func:`spsparse_torch.ops.best_spgemm` and the final rational solve through
the native :func:`~.direct.splu`. Both functions are eager: the inverse and
exponential of a sparse matrix generally fill in.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.algebra import coo_add, coo_scale
from ..core.construct import coo_eye, coo_norm
from ..core.coo import SparseCOO
from ..core.errors import SpSparseError
from .direct import splu

__all__ = ["inv", "expm"]


def _require_square(a: SparseCOO, who: str):
    if a.rank != 2 or a.shape[0] != a.shape[1]:
        raise SpSparseError(f"{who} needs a square rank-2 matrix, "
                            f"got {a.shape}")


def inv(a: SparseCOO) -> SparseCOO:
    """``A^-1`` as a sparse matrix (scipy.sparse.linalg.inv): one LU
    factorization, n triangular solves against the identity (float64, on
    ``a``'s device). The inverse is usually dense: prefer
    :func:`~.direct.factorized` to apply ``A^-1`` without forming it."""
    _require_square(a, "inv")
    n = int(a.shape[0])
    X = splu(a).solve(torch.eye(n, dtype=torch.float64, device=a.device))
    return SparseCOO.from_dense(X)


# Pade coefficients b_0..b_m for degrees 3/5/7/9/13 (Higham 2005, Table
# 2.3, the published constants scipy uses too).
_PADE_B = {
    3: [120.0, 60.0, 12.0, 1.0],
    5: [30240.0, 15120.0, 3360.0, 420.0, 30.0, 1.0],
    7: [17297280.0, 8648640.0, 1995840.0, 277200.0, 25200.0, 1512.0,
        56.0, 1.0],
    9: [17643225600.0, 8821612800.0, 2075673600.0, 302702400.0,
        30270240.0, 2162160.0, 110880.0, 3960.0, 90.0, 1.0],
    13: [64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
         1187353796428800.0, 129060195264000.0, 10559470521600.0,
         670442572800.0, 33522128640.0, 1323241920.0, 40840800.0,
         960960.0, 16380.0, 182.0, 1.0],
}

# theta_m 1-norm thresholds (Higham 2005, Table 2.3).
_THETA = {3: 1.495585217958292e-2, 5: 2.539398330063230e-1,
          7: 9.504178996162932e-1, 9: 2.097847961257068,
          13: 5.371920351148152}


def expm(a: SparseCOO) -> SparseCOO:
    """Matrix exponential ``e^A`` (scipy.sparse.linalg.expm; Higham 2005
    scaling-and-squaring Pade), a consolidated :class:`SparseCOO` on
    ``a``'s device. ``e^A`` of a sparse matrix is typically dense; for
    ``e^A @ v`` use :func:`spsparse_torch.solvers.expm_multiply`."""
    from ..ops.spgemm import best_spgemm

    _require_square(a, "expm")
    n = int(a.shape[0])
    if n == 0:
        return a
    nrm = float(coo_norm(a, 1))
    A = a

    def poly(powers, coeffs):
        """sum_i coeffs[i] * powers[i] (powers[0] is I)."""
        out = None
        for p, c in zip(powers, coeffs):
            if c == 0.0:
                continue
            t = coo_scale(p, c)
            out = t if out is None else coo_add(out, t)
        return out

    s = 0
    if nrm > _THETA[13]:
        s = max(0, int(np.ceil(np.log2(nrm / _THETA[13]))))
        A = coo_scale(a, 0.5 ** s)
        nrm = nrm * 0.5 ** s

    I = coo_eye(n, dtype=np.float64, device=a.device)
    A2 = best_spgemm(A, A)
    for m in (3, 5, 7, 9):
        if nrm <= _THETA[m]:
            b = _PADE_B[m]
            # exactly (m+1)//2 even powers [I, A2, ..., A^(m-1)], one a
            # coefficient of b[1::2] / b[0::2]
            powers = [I, A2]
            while len(powers) < (m + 1) // 2:
                powers.append(best_spgemm(powers[-1], A2))
            U = best_spgemm(A, poly(powers, b[1::2]))
            V = poly(powers, b[0::2])
            break
    else:
        b = _PADE_B[13]
        A4 = best_spgemm(A2, A2)
        A6 = best_spgemm(A4, A2)
        # U = A (A6 (b13 A6 + b11 A4 + b9 A2) + b7 A6 + b5 A4 + b3 A2 + b1 I)
        W1 = poly([A2, A4, A6], [b[9], b[11], b[13]])
        W = coo_add(best_spgemm(A6, W1),
                    poly([I, A2, A4, A6], [b[1], b[3], b[5], b[7]]))
        U = best_spgemm(A, W)
        Z1 = poly([A2, A4, A6], [b[8], b[10], b[12]])
        V = coo_add(best_spgemm(A6, Z1),
                    poly([I, A2, A4, A6], [b[0], b[2], b[4], b[6]]))

    # R = (V - U)^-1 (V + U), solved through the native LU
    num = coo_add(V, U)
    den = coo_add(V, coo_scale(U, -1.0))
    X = splu(den).solve(num.to_dense().to(torch.float64))
    for _ in range(s):
        X = X @ X
    return SparseCOO.from_dense(X)

"""Spectral solvers: symmetric eigenpairs, singular triplets, general
eigenpairs and matrix-function actions over any ``matvec`` (the
``scipy.sparse.linalg.eigsh / lobpcg / svds / eigs / expm_multiply``
capability).

PyTorch counterpart of :mod:`spsparse_tpu.solvers.spectral`, the same
algorithms step for step:

* every ``lax.fori_loop``/``scan`` is a Python loop with the JAX package's
  fixed trip count, and every breakdown is masked with ``torch.where`` on
  device scalars (no ``.item()`` inside a loop), so a Krylov build never
  waits on the host;
* full reorthogonalization by CGS2 (two skinny ``(m, n) @ (n,)`` products
  a step, masked to the live rows as in the JAX package);
* the small dense problems (the tridiagonal, the bidiagonal SVD, LOBPCG's
  ``3k x 3k`` Rayleigh-Ritz) use ``torch.linalg`` on the operand's device,
  as the JAX package uses ``jnp.linalg`` outside any kernel; the symmetric
  ones are symmetrized first, as ``jnp.linalg.eigh`` does, and solved in
  float64 (CUDA's float32 eigh is not accurate to float32);
* selections that ``jax.lax.top_k`` makes (ties to the lower index) use a
  stable sort, so they pick the same indices.

The Arnoldi Hessenberg eigenproblem runs on the host in numpy, as in the
JAX package, and :func:`arnoldi_eigs` returns numpy arrays.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .iterative import _dot

Tensor = torch.Tensor

__all__ = ["lanczos_eigsh", "arnoldi_eigs", "lobpcg_solve",
           "svds_lanczos", "funm_multiply", "expm_multiply"]


def _nz(d: Tensor) -> Tensor:
    return torch.where(d == 0, torch.ones_like(d), d)


def _eigh(M: Tensor):
    """``jnp.linalg.eigh``: the symmetrized matrix's ascending eigenpairs,
    solved in float64 and returned in ``M``'s dtype. CUDA's float32 eigh
    is not accurate to float32: on an H100 it put the top eigenvalue of a
    256-step Lanczos tridiagonal (norm 8) 4.4e-4 above the float64 one,
    above the operator's whole spectrum (``tests_gpu/lanczos_top_gap.py``)."""
    S = (M + M.mT) / 2
    if S.dtype == torch.float64 or S.dtype.is_complex:
        return torch.linalg.eigh(S)
    w, U = torch.linalg.eigh(S.double())
    return w.to(M.dtype), U.to(M.dtype)


def _top_k(x: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """``jax.lax.top_k``: the k largest, descending, ties to the lower
    index."""
    v, i = torch.sort(x, descending=True, stable=True)
    return v[:k], i[:k]


def _cgs2(V: Tensor, w: Tensor, j: int, m: int) -> Tensor:
    """Project ``w`` off the first ``j+1`` rows of ``V`` (CGS, twice); the
    mask keeps the projection to the live rows as in the JAX package."""
    mask = (torch.arange(m, device=w.device) <= j).to(w.dtype)
    w = w - ((V @ w) * mask) @ V
    w = w - ((V @ w) * mask) @ V
    return w


def _lanczos_decomp(matvec: Callable[[Tensor], Tensor], v0: Tensor,
                    iters: int):
    """Lanczos with full (CGS2) reorthogonalization. Returns ``(V, alpha,
    beta)``: ``V (iters+1, n)`` orthonormal rows (dead rows zero after a
    breakdown), the tridiagonal's diagonal ``alpha (iters,)`` and
    off-diagonal ``beta (iters,)``. After a breakdown the dead ``alpha``
    entries repeat the last live Rayleigh quotient with zero coupling; the
    callers filter the spurious pairs by their zero-norm Ritz vectors."""
    n = v0.shape[0]
    dt, dev = v0.dtype, v0.device
    nrm0 = torch.sqrt(_dot(v0, v0))
    V = torch.zeros((iters + 1, n), dtype=dt, device=dev)
    V[0] = v0 / _nz(nrm0)
    alpha = torch.zeros(iters, dtype=dt, device=dev)
    beta = torch.zeros(iters, dtype=dt, device=dev)
    alive = nrm0 > 0
    last_a = torch.zeros((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    for j in range(iters):
        w = matvec(V[j])
        a = _dot(V[j], w)
        w = _cgs2(V, w, j, iters + 1)
        b_ = torch.sqrt(_dot(w, w))
        tiny = 1e-12 * torch.clamp(a.abs(), min=1)
        alive_next = alive & (b_ > tiny)
        a_eff = torch.where(alive, a, last_a)
        V[j + 1] = torch.where(alive_next, w / _nz(b_), zero)
        alpha[j] = a_eff
        beta[j] = torch.where(alive_next, b_, zero)
        last_a = a_eff
        alive = alive_next
    return V, alpha, beta


def _tridiag(alpha: Tensor, beta: Tensor) -> Tensor:
    return (torch.diag(alpha) + torch.diag(beta[:-1], 1)
            + torch.diag(beta[:-1], -1))


def _mask_dead_ritz(vals: Tensor, vec_norms: Tensor,
                    largest: bool) -> Tensor:
    """Ritz values whose Ritz vectors have ~zero norm (spurious
    post-breakdown pairs) become -/+inf, so a top-k/bottom-k never picks
    them."""
    bad = torch.full_like(vals, -torch.inf if largest else torch.inf)
    return torch.where(vec_norms < 0.5, bad, vals)


def lanczos_eigsh(matvec: Callable[[Tensor], Tensor], v0: Tensor, *,
                  k: int, iters: int | None = None,
                  which: str = "LA") -> tuple[Tensor, Tensor]:
    """``k`` extreme eigenpairs of a symmetric operator by Lanczos with full
    reorthogonalization (``which`` ``"LA"``/``"SA"`` as scipy's eigsh).

    ``iters`` (default ``min(max(2k + 16, 24), n)``) is the Krylov size.
    Returns ``(vals (k,), vecs (n, k))``, values ascending, ``A @ vecs ~
    vecs * vals``."""
    if which not in ("LA", "SA"):
        raise ValueError(f"which must be 'LA' or 'SA', got {which!r}")
    n = v0.shape[0]
    if iters is None:
        iters = min(max(2 * k + 16, 24), n)
    if not (0 < k <= iters):
        raise ValueError(f"need 0 < k={k} <= iters={iters}")
    V, alpha, beta = _lanczos_decomp(matvec, v0, iters)
    w, Y = _eigh(_tridiag(alpha, beta))                # ascending
    # Dead pairs (breakdown padding) have eigenvectors on the zeroed V
    # rows, so their lifted vectors have ~0 norm.
    lifted = V[:iters].T @ Y                           # (n, iters)
    lnorm = torch.linalg.norm(lifted, dim=0)
    largest = which == "LA"
    w = _mask_dead_ritz(w, lnorm, largest)
    if largest:
        vals, sel = _top_k(w, k)
        vals, sel = vals.flip(0), sel.flip(0)          # ascending
    else:
        nvals, sel = _top_k(-w, k)
        vals = -nvals
    vecs = lifted[:, sel]
    vecs = vecs / torch.clamp(torch.linalg.norm(vecs, dim=0), min=1e-30)
    return vals, vecs


def funm_multiply(matvec: Callable[[Tensor], Tensor], v: Tensor, *,
                  f: Callable[[Tensor], Tensor],
                  iters: int = 32) -> Tensor:
    """``f(A) @ v`` for a symmetric operator by the Lanczos approximation
    ``||v|| * V^T f(T) e_1``, ``f`` applied to the Ritz values of the
    ``iters x iters`` tridiagonal (a tensor function: ``torch.exp``,
    ``torch.sqrt``, ...). Spurious post-breakdown pairs have a zero first
    eigenvector component and contribute nothing."""
    V, alpha, beta = _lanczos_decomp(matvec, v, iters)
    w, Y = _eigh(_tridiag(alpha, beta))
    nrm = torch.sqrt(_dot(v, v))
    coeff = Y @ (f(w).to(Y.dtype) * Y[0, :])           # f(T) e_1
    return nrm * (coeff @ V[:iters])


def expm_multiply(matvec: Callable[[Tensor], Tensor], v: Tensor, *,
                  t: float = 1.0, iters: int = 32) -> Tensor:
    """``exp(t A) @ v`` for symmetric ``A`` by Lanczos
    (:func:`funm_multiply` with ``f = exp(t .)``)."""
    tt = torch.as_tensor(t, dtype=v.dtype, device=v.device)
    return funm_multiply(matvec, v, f=lambda w: torch.exp(tt * w),
                         iters=iters)


def _whiten(G: Tensor) -> tuple[Tensor, Tensor]:
    """Pseudo-inverse square root of a symmetric PSD Gram matrix by
    eigenvalue masking (LOBPCG's rank-deficiency guard): directions with an
    eigenvalue below ``100 eps`` of the largest are dropped."""
    g, U = _eigh(G)
    fi = torch.finfo(G.dtype)
    gmax = torch.clamp(g[-1], min=0)
    ok = g > 100 * fi.eps * torch.clamp(gmax, min=fi.tiny)
    inv_sqrt = torch.where(ok, 1 / torch.sqrt(torch.where(ok, g, 1.0)),
                           torch.zeros_like(g))
    return U * inv_sqrt[None, :], ok


def lobpcg_solve(matmat: Callable[[Tensor], Tensor], X0: Tensor, *,
                 iters: int,
                 minv: Tensor | Callable[[Tensor], Tensor] | None = None,
                 largest: bool = False) -> tuple[Tensor, Tensor]:
    """Locally optimal block preconditioned conjugate gradient for ``k``
    extreme eigenpairs of a symmetric operator (scipy's lobpcg).

    ``matmat`` maps ``(n, k) -> (n, k)`` (over the DIA multi-RHS kernel K3,
    ``lambda M: spmm_dia_mrhs(prep, M.T).T`` for ``k <= 8``). Each iteration
    is one ``3k x 3k`` Rayleigh-Ritz problem on the whitened span of
    ``[X, W, P]``. ``minv``: a Jacobi vector ``(n,)`` or a callable
    ``(n, k) -> (n, k)``. Returns ``(vals (k,), X (n, k))``, ascending
    (``largest=False``) or descending (``largest=True``)."""
    if X0.ndim != 2:
        raise ValueError(f"X0 must be (n, k), got {tuple(X0.shape)}")
    n, k = X0.shape
    dt = X0.dtype
    if minv is None:
        apply_m = lambda r: r                                 # noqa: E731
    elif callable(minv):
        apply_m = minv
    else:
        apply_m = lambda r: minv[:, None] * r                 # noqa: E731

    def rr(S, AS):
        """Rayleigh-Ritz on the whitened span of S's columns. A dropped
        direction leaves a zero row and column in M; a diagonal penalty
        past the far end of M's spectrum (twice its Gershgorin bound plus
        one) keeps its spurious zero eigenvalue out of the selection. The
        JAX package's penalty is 1/eps^2: LAPACK leaves the other
        eigenvalues exact beside it, but CUDA's eigh does not (1.45 off on
        an O(5) block on an H100), and any penalty past the spectrum
        selects the same directions."""
        W, ok = _whiten(S.T @ S)
        M = W.T @ (S.T @ AS) @ W
        far = 2 * (M.abs().sum(dim=1).max() + 1)
        pen = torch.where(ok, torch.zeros_like(M[0]), -far if largest
                          else far)
        w, Y = _eigh(M + torch.diag(pen))
        if largest:
            w, Y = w.flip(0), Y.flip(1)
        return w[:k], W @ Y[:, :k]

    X = X0
    AX = matmat(X)
    lam, C = rr(X, AX)
    X, AX = X @ C, AX @ C
    P = torch.zeros_like(X)
    AP = torch.zeros_like(X)
    for _ in range(int(iters)):
        R = AX - X * lam[None, :]
        Wd = apply_m(R)
        # Project the preconditioned residual off X.
        Wd = Wd - X @ (X.T @ Wd)
        wn = torch.linalg.norm(Wd, dim=0)
        Wd = Wd / torch.clamp(wn, min=1e-30)[None, :]
        AW = matmat(Wd)
        S = torch.cat([X, Wd, P], dim=1)                      # (n, 3k)
        AS = torch.cat([AX, AW, AP], dim=1)
        lam, C = rr(S, AS)
        # P: the W+P part of the new X (the X-block rows of C zeroed).
        Cp = C.clone()
        Cp[:k, :] = 0
        X, AX, P, AP = S @ C, AS @ C, S @ Cp, AS @ Cp
    nr = torch.clamp(torch.linalg.norm(X, dim=0), min=1e-30)
    return lam.to(dt), X / nr[None, :]


def svds_lanczos(matvec: Callable[[Tensor], Tensor],
                 rmatvec: Callable[[Tensor], Tensor], v0: Tensor, *,
                 k: int, iters: int | None = None
                 ) -> tuple[Tensor, Tensor, Tensor]:
    """Top-``k`` singular triplets by Golub-Kahan bidiagonalization with
    full CGS2 reorthogonalization of both bases (scipy's svds).

    ``matvec: (n,) -> (m,)`` applies ``A``, ``rmatvec: (m,) -> (n,)``
    applies ``A^T``, ``v0 (n,)`` seeds the right basis; ``iters`` defaults
    to ``min(max(2k + 16, 24), n)``. Returns ``(U (m, k), s (k,), Vt (k,
    n))``, singular values descending."""
    n = v0.shape[0]
    dt, dev = v0.dtype, v0.device
    if iters is None:
        iters = min(max(2 * k + 16, 24), n)
    if not (0 < k <= iters):
        raise ValueError(f"need 0 < k={k} <= iters={iters}")
    m = matvec(v0).shape[0]
    nrm0 = torch.sqrt(_dot(v0, v0))
    Vb = torch.zeros((iters, n), dtype=dt, device=dev)
    Vb[0] = v0 / _nz(nrm0)
    Ub = torch.zeros((iters, m), dtype=dt, device=dev)
    alpha = torch.zeros(iters, dtype=dt, device=dev)
    beta = torch.zeros(iters, dtype=dt, device=dev)
    alive = nrm0 > 0
    zero = torch.zeros((), dtype=dt, device=dev)
    for j in range(iters):
        # u_j from A v_j, orthogonalized against u_0..u_{j-1}.
        p = _cgs2(Ub, matvec(Vb[j]), j - 1, iters)
        a = torch.sqrt(_dot(p, p))
        ok_a = alive & (a > 1e-12)
        u = torch.where(ok_a, p / _nz(a), zero)
        Ub[j] = u
        # v_{j+1} from A^T u_j, orthogonalized against v_0..v_j.
        q = _cgs2(Vb, rmatvec(u), j, iters)
        b_ = torch.sqrt(_dot(q, q))
        ok_b = ok_a & (b_ > 1e-12)
        if j + 1 < iters:
            Vb[j + 1] = torch.where(ok_b, q / _nz(b_), zero)
        alpha[j] = torch.where(ok_a, a, zero)
        beta[j] = torch.where(ok_b, b_, zero)
        alive = ok_a
    # u_j from A v_j and v_{j+1} from A^T u_j make B[i, j] = u_i^T A v_j
    # upper bidiagonal (diagonal alpha, superdiagonal beta).
    B = torch.diag(alpha) + torch.diag(beta[:-1], 1)
    Pb, s, Qt = torch.linalg.svd(B)                  # descending
    Uk_full = Ub.T @ Pb                               # (m, iters)
    Vk_full = Vb.T @ Qt.T                             # (n, iters)
    un = torch.linalg.norm(Uk_full, dim=0)
    vn = torch.linalg.norm(Vk_full, dim=0)
    s = torch.where((un > 0.5) & (vn > 0.5), s, torch.zeros_like(s))
    order = torch.argsort(-s, stable=True)[:k]
    U = Uk_full[:, order]
    Vt = Vk_full[:, order].T
    U = U / torch.clamp(torch.linalg.norm(U, dim=0), min=1e-30)[None, :]
    Vt = Vt / torch.clamp(torch.linalg.norm(Vt, dim=1), min=1e-30)[:, None]
    return U, s[order], Vt


# ----------------------------------------------------------------------
# Nonsymmetric eigenpairs: explicitly restarted Arnoldi
# ----------------------------------------------------------------------

def _arnoldi_decomp(matvec: Callable[[Tensor], Tensor], v0: Tensor,
                    iters: int):
    """Arnoldi with CGS2 reorthogonalization: ``(V (iters+1, n), H
    (iters+1, iters))`` with ``A V[:m].T = V.T H``; dead rows zero after an
    invariant-subspace breakdown."""
    n = v0.shape[0]
    dt, dev = v0.dtype, v0.device
    m = iters
    nrm0 = torch.sqrt(_dot(v0, v0))
    V = torch.zeros((m + 1, n), dtype=dt, device=dev)
    V[0] = v0 / _nz(nrm0)
    H = torch.zeros((m + 1, m), dtype=dt, device=dev)
    alive = nrm0 > 0
    zero = torch.zeros((), dtype=dt, device=dev)
    rows = torch.arange(m + 1, device=dev)
    for j in range(m):
        w = matvec(V[j])
        mask = (rows <= j).to(dt)
        h1 = (V @ w) * mask
        w = w - h1 @ V
        h2 = (V @ w) * mask                  # CGS second pass
        w = w - h2 @ V
        h = h1 + h2
        b_ = torch.sqrt(_dot(w, w))
        scale = torch.clamp(h.abs().max(), min=1)
        alive_next = alive & (b_ > 1e-12 * scale)
        V[j + 1] = torch.where(alive_next, w / _nz(b_), zero)
        h[j + 1] = torch.where(alive_next, b_, zero)
        H[:, j] = torch.where(alive, h, zero)
        alive = alive_next
    return V, H


def _select_ritz(w, which: str, k: int):
    """Indices of the k wanted Ritz values (scipy's which codes)."""
    key = {"LM": -np.abs(w), "SM": np.abs(w),
           "LR": -w.real, "SR": w.real,
           "LI": -w.imag, "SI": w.imag}.get(which)
    if key is None:
        raise ValueError(f"which must be one of LM/SM/LR/SR/LI/SI, "
                         f"got {which!r}")
    return np.argsort(key, kind="stable")[:k]


def arnoldi_eigs(matvec: Callable[[Tensor], Tensor], v0: Tensor, *,
                 k: int = 6, which: str = "LM", iters: int | None = None,
                 restarts: int = 8, tol: float = 1e-10):
    """``k`` eigenpairs of a general operator (scipy's eigs ``which``
    codes, complex output): the Krylov decomposition on the operand's
    device, the ``(iters, iters)`` Hessenberg eigenproblem on the host in
    numpy, explicit restarts seeded with the sum of the wanted Ritz vectors
    (``restarts`` cycles; with ``tol > 0`` they stop once every wanted
    pair's residual bound ``|h_{m+1,m}| |y_m|`` is below ``tol * |ritz|``).

    Returns numpy ``(vals (k,) complex, vecs (n, k) complex)`` in wanted
    order, as the JAX package does."""
    n = v0.shape[0]
    if iters is None:
        iters = min(max(3 * k + 20, 36), n)
    if not (0 < k <= iters):
        raise ValueError(f"need 0 < k={k} <= iters={iters}")
    m = iters
    v = v0
    vals = vecs = None
    for _ in range(max(1, restarts)):
        V, H = _arnoldi_decomp(matvec, v, m)
        Hn = H.cpu().numpy()
        Vn = V.cpu().numpy()
        w, Y = np.linalg.eig(Hn[:m, :m])
        lifted = Vn[:m].T @ Y                       # (n, m) complex
        lnorm = np.linalg.norm(lifted, axis=0)
        # Spurious post-breakdown pairs go to the unwanted end under the
        # sort key of _select_ritz.
        dead = lnorm < 0.5
        sent = {"LM": 0.0, "SM": np.inf,
                "LR": complex(-np.inf, 0.0), "SR": complex(np.inf, 0.0),
                "LI": complex(0.0, -np.inf),
                "SI": complex(0.0, np.inf)}.get(which, 0.0)
        w = np.where(dead, sent, w)
        sel = _select_ritz(w, which, k)
        vals = w[sel]
        vecs = lifted[:, sel] / np.where(lnorm[sel] == 0, 1, lnorm[sel])
        res = np.abs(Hn[m, m - 1]) * np.abs(Y[m - 1, sel])
        if tol > 0 and np.all(res <= tol * np.maximum(np.abs(vals), 1e-30)):
            break
        # Explicit restart: re-seed with the wanted Ritz directions.
        seed = vecs.real.sum(axis=1) + vecs.imag.sum(axis=1)
        nr = np.linalg.norm(seed)
        if nr == 0:
            break
        v = torch.from_numpy(seed / nr).to(v0.device, v0.dtype)
    return vals, vecs

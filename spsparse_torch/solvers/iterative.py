"""Iterative solvers over sparse operators.

PyTorch counterpart of :mod:`spsparse_tpu.solvers.iterative`: conjugate
gradients (plain, preconditioned, multi-RHS, implicit-gradient), BiCGStab,
CGS, TFQMR, MINRES, Chebyshev, restarted GMRES, Lanczos spectrum bounds and
power iteration. The operator is a pluggable ``matvec`` callable: a DIA
kernel (:func:`spsparse_torch.ops.best_spmv`, the multi-RHS
:func:`spsparse_torch.ops.spmm_dia_mrhs`), a generic CSR/ELL product, a
:class:`~spsparse_torch.solvers.LinearOperator`, or a dense matmul.

Each ``lax.scan`` of the JAX package is a Python loop here, and every
breakdown guard is a ``torch.where`` on device scalars, never ``.item()``:
a solve never waits on the host between iterations, and the iteration
counts are fixed as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tensor = torch.Tensor
MatVec = Callable[[Tensor], Tensor]

__all__ = ["CGState", "safe_div", "cg_step", "cg_solve", "pcg_solve",
           "cg_solve_mrhs", "jacobi_preconditioner", "power_iteration",
           "bicgstab_solve", "cgs_solve", "tfqmr_solve", "minres_solve",
           "chebyshev_solve", "gmres_solve", "lanczos_bounds",
           "cg_solve_implicit"]


@dataclasses.dataclass(frozen=True)
class CGState:
    x: Tensor
    r: Tensor
    p: Tensor
    rs: Tensor


def _dot(u: Tensor, v: Tensor) -> Tensor:
    """``vdot`` over all elements (conjugating ``u``), as ``jnp.vdot``."""
    return torch.vdot(u.reshape(-1), v.reshape(-1))


def _nonzero(d: Tensor) -> Tensor:
    """``d`` with zeros replaced by ones: the denominator guard."""
    return torch.where(d == 0, torch.ones_like(d), d)


def safe_div(num: Tensor, den: Tensor) -> Tensor:
    """``num / den`` with 0 where ``den == 0`` — the masked-denominator
    breakdown guard shared by the fixed-iteration solvers (a converged or
    broken-down iterate carries unchanged instead of producing NaNs)."""
    q = num / _nonzero(den)
    return torch.where(den != 0, q, torch.zeros_like(q))


def _apply_m(minv) -> MatVec:
    if minv is None:
        return lambda r: r
    return minv if callable(minv) else (lambda r: minv * r)


def cg_step(matvec: MatVec, state: CGState) -> CGState:
    """One conjugate-gradient iteration for SPD ``A``."""
    Ap = matvec(state.p)
    alpha = state.rs / _nonzero(_dot(state.p, Ap))
    x = state.x + alpha * state.p
    r = state.r - alpha * Ap
    rs_new = _dot(r, r)
    beta = rs_new / _nonzero(state.rs)
    p = r + beta * state.p
    return CGState(x=x, r=r, p=p, rs=rs_new)


def cg_solve(matvec: MatVec, b: Tensor, *, iters: int,
             x0: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Fixed-iteration CG; returns ``(x, final_residual_norm_sq)``."""
    x0 = torch.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x0)
    state = CGState(x=x0, r=r0, p=r0, rs=_dot(r0, r0))
    for _ in range(int(iters)):
        state = cg_step(matvec, state)
    return state.x, state.rs


def pcg_solve(matvec: MatVec, b: Tensor, *, iters: int,
              minv: Tensor | MatVec | None = None,
              x0: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Preconditioned CG: ``minv`` is the preconditioner application —
    a dense vector (Jacobi: elementwise ``1/diag(A)``) or a callable
    ``z = M^{-1} r``. Plain CG when ``minv`` is None."""
    if minv is None:
        return cg_solve(matvec, b, iters=iters, x0=x0)
    apply_m = _apply_m(minv)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    p = apply_m(r)
    rz = _dot(r, p)
    for _ in range(int(iters)):
        Ap = matvec(p)
        alpha = rz / _nonzero(_dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_m(r)
        rz_new = _dot(r, z)
        beta = rz_new / _nonzero(rz)
        p = z + beta * p
        rz = rz_new
    return x, _dot(r, r)


def cg_solve_mrhs(matmat: MatVec, B: Tensor, *, iters: int,
                  minv: Tensor | MatVec | None = None,
                  x0: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Batched (multi-RHS) preconditioned CG: solve ``A X = B`` for an SPD
    operator and ``B`` of shape ``(..., n, k)``, columns last, all ``k``
    systems advanced in lockstep with per-column step lengths.

    ``matmat`` maps ``(n, k) -> (n, k)``: over the DIA multi-RHS kernel K3
    that is ``lambda M: spmm_dia_mrhs(prep, M.T).T``, which reads the
    diagonals once for all ``k <= 8`` columns. Each column follows exactly
    the mathematics of :func:`pcg_solve` (k independent CGs sharing operator
    applications, no cross-column coupling): one column's breakdown never
    poisons the others. ``minv`` is a per-row array of shape
    ``B.shape[:-1]`` (Jacobi), an array that broadcasts against ``B``, or a
    callable ``Z = M^{-1} R``. Returns ``(X, rs)`` with ``rs`` the
    per-column final ``||r||^2`` (shape ``(k,)``).
    """
    if B.ndim < 2:
        raise ValueError(f"cg_solve_mrhs expects B of shape (..., n, k), "
                         f"got {tuple(B.shape)}")
    if minv is None or callable(minv):
        apply_m = _apply_m(minv)
    else:
        # A per-row array is one axis short of B and must equal B's row
        # shape exactly (a (k,) per-column vector would otherwise be
        # misapplied silently when n == k); full-rank arrays must broadcast.
        mv = torch.as_tensor(minv, device=B.device)
        if mv.ndim == B.ndim - 1:
            if tuple(mv.shape) != tuple(B.shape[:-1]):
                raise ValueError(
                    f"cg_solve_mrhs: per-row minv must have shape "
                    f"B.shape[:-1] = {tuple(B.shape[:-1])}, got "
                    f"{tuple(mv.shape)}; for a per-column preconditioner "
                    f"pass shape (1, k) or a callable")
            apply_m = lambda r: mv[..., None] * r  # noqa: E731
        else:
            try:
                torch.broadcast_shapes(mv.shape, B.shape)
            except RuntimeError:
                raise ValueError(
                    f"cg_solve_mrhs: minv shape {tuple(mv.shape)} does not "
                    f"broadcast against B shape {tuple(B.shape)}") from None
            apply_m = lambda r: mv * r  # noqa: E731

    def col_dot(u, v):
        return torch.sum(u.conj() * v, dim=tuple(range(u.ndim - 1)))

    x = torch.zeros_like(B) if x0 is None else x0
    r = B - matmat(x)
    p = apply_m(r)
    rz = col_dot(r, p)
    for _ in range(int(iters)):
        Ap = matmat(p)
        alpha = rz / _nonzero(col_dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_m(r)
        rz_new = col_dot(r, z)
        beta = rz_new / _nonzero(rz)
        p = z + beta * p
        rz = rz_new
    return x, col_dot(r, r)


def jacobi_preconditioner(diag: Tensor, eps: float = 1e-12) -> Tensor:
    """Elementwise inverse-diagonal preconditioner vector for
    :func:`pcg_solve` (zero diagonal entries get 1)."""
    return torch.where(diag.abs() > eps, 1.0 / diag, torch.ones_like(diag))


def bicgstab_solve(matvec: MatVec, b: Tensor, *, iters: int,
                   minv: Tensor | MatVec | None = None,
                   x0: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """BiCGStab for general (non-symmetric) ``A``, fixed iteration count,
    optional right-applied preconditioner (van der Vorst form); the
    rho/omega denominators are masked by :func:`safe_div`. Returns
    ``(x, final_residual_norm_sq)``."""
    apply_m = _apply_m(minv)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    rhat = r
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho = alpha = omega = one
    for _ in range(int(iters)):
        rho_new = _dot(rhat, r)
        beta = safe_div(rho_new * alpha, rho * omega)
        p = r + beta * (p - omega * v)
        ph = apply_m(p)
        v = matvec(ph)
        alpha = safe_div(rho_new, _dot(rhat, v))
        s = r - alpha * v
        sh = apply_m(s)
        t = matvec(sh)
        omega = safe_div(_dot(t, s), _dot(t, t))
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        rho = rho_new
    return x, _dot(r, r)


def cgs_solve(matvec: MatVec, b: Tensor, *, iters: int,
              minv: Tensor | MatVec | None = None,
              x0: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Conjugate Gradient Squared (Sonneveld) for general ``A``: two
    matvecs per iteration, no ``A^T``. Returns ``(x,
    final_residual_norm_sq)`` of the recurrence residual."""
    apply_m = _apply_m(minv)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    rtld = r
    p = torch.zeros_like(b)
    q = torch.zeros_like(b)
    rho = torch.ones((), dtype=b.dtype, device=b.device)
    for _ in range(int(iters)):
        rho_new = _dot(rtld, r)
        beta = safe_div(rho_new, rho)
        u = r + beta * q
        p = u + beta * (q + beta * p)
        vhat = matvec(apply_m(p))
        alpha = safe_div(rho_new, _dot(rtld, vhat))
        q = u - alpha * vhat
        uhat = apply_m(u + q)
        x = x + alpha * uhat
        r = r - alpha * matvec(uhat)
        rho = rho_new
    return x, _dot(r, r)


def tfqmr_solve(matvec: MatVec, b: Tensor, *, iters: int,
                x0: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Transpose-Free QMR (Freund 1993) for general ``A``: CGS's two
    matvecs per iteration with quasi-minimal-residual smoothing. Each
    iteration is one even and one odd half-step. Returns ``(x,
    true_final_residual_norm_sq)`` (one extra matvec at the end)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x)
    dt, dev = b.dtype, b.device
    one = torch.ones((), dtype=dt, device=dev)
    rtld = r0

    def half(x, d, w, tau, theta, eta, y, Ay, alpha):
        w = w - alpha * Ay
        d = y + safe_div(theta * theta * eta, alpha) * d
        theta = safe_div(torch.sqrt(_dot(w, w)), tau)
        c2 = safe_div(one, 1 + theta * theta)
        tau = tau * theta * torch.sqrt(c2)
        eta = c2 * alpha
        x = x + eta * d
        return x, d, w, tau, theta, eta

    Ar0 = matvec(r0)
    w, y1, Ay1, v = r0, r0, Ar0, Ar0
    d = torch.zeros_like(b)
    tau = torch.sqrt(_dot(r0, r0))
    theta = torch.zeros((), dtype=dt, device=dev)
    eta = torch.zeros((), dtype=dt, device=dev)
    rho = _dot(rtld, r0)
    for _ in range(int(iters)):
        alpha = safe_div(rho, _dot(rtld, v))
        y2 = y1 - alpha * v
        Ay2 = matvec(y2)
        # The odd half-step needs A @ y1 itself (v equals it only on the
        # first iteration), so Ay1 is carried explicitly.
        x, d, w, tau, theta, eta = half(x, d, w, tau, theta, eta,
                                        y1, Ay1, alpha)
        x, d, w, tau, theta, eta = half(x, d, w, tau, theta, eta,
                                        y2, Ay2, alpha)
        rho_new = _dot(rtld, w)
        beta = safe_div(rho_new, rho)
        y1 = w + beta * y2
        Ay1 = matvec(y1)
        v = Ay1 + beta * (Ay2 + beta * v)
        rho = rho_new
    r = b - matvec(x)
    return x, _dot(r, r)


def minres_solve(matvec: MatVec, b: Tensor, *, iters: int,
                 x0: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """MINRES (Paige & Saunders) for symmetric, possibly indefinite
    operators: Lanczos tridiagonalisation with an implicit QR through
    carried Givens rotations. Breakdown or early convergence freezes the
    iterate through masked updates. Returns ``(x, rnorm_sq_estimate)``
    (the recurrence's ``|eta|^2``)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    beta1 = torch.sqrt(_dot(r, r))
    dt, dev = b.dtype, b.device
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    v = r * safe_div(one, beta1)
    v_prev = torch.zeros_like(b)
    w = torch.zeros_like(b)
    w_prev = torch.zeros_like(b)
    beta, c, c_old, s, s_old = zero, one, one, zero, zero
    eta = beta1
    alive = beta1 > 0
    for _ in range(int(iters)):
        Av = matvec(v)
        alpha = _dot(v, Av)
        r_next = Av - alpha * v - beta * v_prev
        beta_n = torch.sqrt(_dot(r_next, r_next))
        # Apply the two previous rotations to the new tridiagonal column,
        # then form the rotation that eliminates beta_{j+1}.
        rho1_hat = c * alpha - c_old * s * beta
        rho1 = torch.sqrt(rho1_hat ** 2 + beta_n ** 2)
        rho2 = s * alpha + c_old * c * beta
        rho3 = s_old * beta
        c_new = safe_div(rho1_hat, rho1)
        s_new = safe_div(beta_n, rho1)
        w_next = (v - rho3 * w_prev - rho2 * w) * safe_div(one, rho1)
        upd = alive & (rho1 != 0)
        x = torch.where(upd, x + (c_new * eta) * w_next, x)
        eta = torch.where(upd, -s_new * eta, eta)
        alive_next = upd & (beta_n > 0)
        v_next = r_next * safe_div(one, beta_n)
        v, v_prev = (torch.where(alive_next, v_next, v),
                     torch.where(alive_next, v, v_prev))
        w, w_prev = torch.where(upd, w_next, w), torch.where(upd, w, w_prev)
        beta = torch.where(alive_next, beta_n, beta)
        c, c_old = torch.where(upd, c_new, c), torch.where(upd, c, c_old)
        s, s_old = torch.where(upd, s_new, s), torch.where(upd, s, s_old)
        alive = alive_next
    return x, eta ** 2


def chebyshev_solve(matvec: MatVec, b: Tensor, *, lam_min: float,
                    lam_max: float, iters: int,
                    x0: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Chebyshev semi-iteration for SPD ``A`` with spectrum inside
    ``[lam_min, lam_max]``: no inner products in the loop. Exactly
    ``iters`` solution updates. Returns ``(x, final_residual_norm_sq)``."""
    theta = (lam_max + lam_min) / 2
    delta = (lam_max - lam_min) / 2
    sigma1 = theta / delta
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    d = r / theta
    rho = torch.as_tensor(1.0 / sigma1, dtype=b.dtype, device=b.device)
    # The loop applies one update and prepares the next direction; the
    # flush after it applies the last one.
    for _ in range(max(int(iters) - 1, 0)):
        x = x + d
        r = r - matvec(d)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * r
        rho = rho_new
    x = x + d
    r = r - matvec(d)
    return x, _dot(r, r)


class _AdjointSolve(torch.autograd.Function):
    """Forward: the correction ``A^{-1} r`` of an exact solution, which is
    zero. Backward: one solve with the same (symmetric) operator, so the
    gradient of the solution is the adjoint system's solution."""

    @staticmethod
    def forward(ctx, r, solve):
        ctx.solve = solve
        return torch.zeros_like(r)

    @staticmethod
    def backward(ctx, g):
        with torch.no_grad():
            return ctx.solve(g), None


def cg_solve_implicit(matvec: MatVec, b: Tensor, *, iters: int,
                      minv: Tensor | MatVec | None = None) -> Tensor:
    """:func:`pcg_solve` whose gradient flows by the implicit function
    theorem (the counterpart of ``lax.custom_linear_solve``): one more CG
    solve on the cotangent instead of backpropagating through ``iters``
    SpMVs. Memory is O(n) and the backward costs one forward solve.
    Differentiable in ``b`` and in any tensors ``matvec`` closes over
    (``A`` must be SPD, so symmetric). Returns ``x`` only.

    ``x = x* + S(b - A x*)`` with ``x*`` the solve (detached) and ``S`` the
    :class:`_AdjointSolve` Function: its value is 0, and autograd through
    ``b - A x*`` carries ``-A^{-1} (dA) x*`` to the operator's tensors."""
    def solve(rhs):
        return pcg_solve(matvec, rhs, iters=iters, minv=minv)[0]

    with torch.no_grad():
        x = solve(b)
    if not torch.is_grad_enabled():
        return x
    r = b - matvec(x)
    if not r.requires_grad:
        return x
    return x + _AdjointSolve.apply(r, solve)


def lanczos_bounds(matvec: MatVec, v0: Tensor, *, iters: int = 30,
                   safety: float = 1.05) -> tuple[Tensor, Tensor]:
    """Estimated ``(lam_min, lam_max)`` of an SPD operator by Lanczos with
    full reorthogonalisation (two CGS passes), widened by ``safety``: the
    input :func:`chebyshev_solve` needs. A breakdown (the Krylov space is
    exhausted) repeats the last Rayleigh quotient with zero coupling instead
    of writing a spurious zero Ritz value."""
    n = v0.shape[0]
    dt, dev = v0.dtype, v0.device
    nrm0 = torch.sqrt(_dot(v0, v0))
    V = torch.zeros((iters + 1, n), dtype=dt, device=dev)
    V[0] = v0 / _nonzero(nrm0)
    alpha = torch.zeros(iters, dtype=dt, device=dev)
    beta = torch.zeros(iters, dtype=dt, device=dev)
    alive = nrm0 > 0
    last_a = torch.zeros((), dtype=dt, device=dev)
    steps = torch.arange(iters + 1, device=dev)
    for j in range(iters):
        w = matvec(V[j])
        a = _dot(V[j], w)
        mask = (steps <= j).to(dt)
        w = w - ((V @ w) * mask) @ V
        w = w - ((V @ w) * mask) @ V     # second pass (CGS2)
        b_ = torch.sqrt(_dot(w, w))
        tiny = 1e-12 * torch.clamp(a.abs(), min=1)
        alive_next = alive & (b_ > tiny)
        a_eff = torch.where(alive, a, last_a)
        b_eff = torch.where(alive_next, b_, torch.zeros_like(b_))
        V[j + 1] = torch.where(alive_next, w / _nonzero(b_),
                               torch.zeros_like(w))
        alpha[j] = a_eff
        beta[j] = b_eff
        last_a = a_eff
        alive = alive_next
    T = (torch.diag(alpha) + torch.diag(beta[:-1], 1)
         + torch.diag(beta[:-1], -1))
    ritz = torch.linalg.eigvalsh(T)
    return ritz[0] / safety, ritz[-1] * safety


def gmres_solve(matvec: MatVec, b: Tensor, *, m: int = 20, restarts: int = 4,
                minv: Tensor | MatVec | None = None,
                x0: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Restarted GMRES(m) for general ``A``, right-preconditioned. The
    Arnoldi basis ``V (m+1, n)`` is built with classical Gram-Schmidt run
    twice (CGS2); the small ``(m+1, m)`` least-squares problem is solved
    densely per restart by the pseudo-inverse (the minimum-norm solution, as
    the JAX package's SVD-based ``lstsq``). Returns ``(x,
    final_residual_norm_sq)``."""
    apply_m = _apply_m(minv)
    x = torch.zeros_like(b) if x0 is None else x0
    n = b.shape[0]
    dt, dev = b.dtype, b.device
    steps = torch.arange(m + 1, device=dev)
    for _ in range(int(restarts)):
        r = b - matvec(x)
        beta = torch.sqrt(_dot(r, r))
        V = torch.zeros((m + 1, n), dtype=dt, device=dev)
        V[0] = r / _nonzero(beta)
        H = torch.zeros((m + 1, m), dtype=dt, device=dev)
        for j in range(m):
            w = matvec(apply_m(V[j]))
            # Rows of V past j are zero, so the masked projections are
            # exact; the second pass removes CGS's loss of orthogonality.
            mask = (steps <= j).to(dt)
            h1 = (V @ w) * mask
            w = w - h1 @ V
            h2 = (V @ w) * mask
            w = w - h2 @ V
            nrm = torch.sqrt(_dot(w, w))
            H[:, j] = h1 + h2
            H[j + 1, j] = nrm
            V[j + 1] = w / _nonzero(nrm)
        e1 = torch.zeros(m + 1, dtype=dt, device=dev)
        e1[0] = beta
        y = torch.linalg.pinv(H) @ e1
        x = x + apply_m(y @ V[:m])
    r = b - matvec(x)
    return x, _dot(r, r)


def power_iteration(matvec: MatVec, v0: Tensor, *,
                    iters: int) -> tuple[Tensor, Tensor]:
    """Dominant eigenpair estimate by normalised power iteration; returns
    ``(v, |A v_prev|)`` of the last step."""
    if int(iters) < 1:
        raise ValueError("power_iteration needs iters >= 1")
    v = v0
    for _ in range(int(iters)):
        w = matvec(v)
        nrm = torch.sqrt(_dot(w, w))
        v = w / _nonzero(nrm)
    return v, nrm

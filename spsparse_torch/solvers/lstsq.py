"""Sparse least-squares solvers over a ``(matvec, rmatvec)`` operator pair:
CGLS, LSQR and LSMR (the ``scipy.sparse.linalg.lsqr / lsmr`` capability).

PyTorch counterpart of :mod:`spsparse_tpu.solvers.lstsq`. Each solves
``min ||A x - b||^2 + damp^2 ||x||^2`` without forming ``A^T A``: one
product with ``A`` and one with ``A^T`` an iteration, through whatever
kernel the callables pick (over a float32 DIA operand, kernel K1 both ways).
The JAX package's ``lax.scan`` is a Python loop with the same fixed trip
count, and every breakdown guard is :func:`~.iterative.safe_div` on device
scalars, so an iteration never waits on the host.
"""

from __future__ import annotations

from typing import Callable

import torch

from .iterative import _dot, safe_div as _safe_div

Tensor = torch.Tensor

__all__ = ["cgls_solve", "lsqr_solve", "lsmr_solve"]


def _scalar(v, like: Tensor) -> Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def cgls_solve(matvec: Callable[[Tensor], Tensor],
               rmatvec: Callable[[Tensor], Tensor], b: Tensor, *,
               iters: int, damp: float = 0.0,
               x0: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """CGLS: conjugate gradients on ``(A^T A + damp^2 I) x = A^T b`` in
    factored form (residuals kept as ``r = b - A x``).

    ``matvec: (n,) -> (m,)``, ``rmatvec: (m,) -> (n,)``, ``b (m,)``.
    Returns ``(x (n,), gnorm_sq)``, ``gnorm_sq = ||A^T r - damp^2 x||^2``
    at the last iterate."""
    dampf = _scalar(damp, b)
    n_like = rmatvec(b)
    x = torch.zeros_like(n_like) if x0 is None else x0
    r = b - matvec(x)
    p = rmatvec(r) - dampf**2 * x
    gamma = _dot(p, p)
    for _ in range(int(iters)):
        q = matvec(p)
        delta = _dot(q, q) + dampf**2 * _dot(p, p)
        alpha = _safe_div(gamma, delta)
        x = x + alpha * p
        r = r - alpha * q
        s = rmatvec(r) - dampf**2 * x
        gamma_new = _dot(s, s)
        beta = _safe_div(gamma_new, gamma)
        p = s + beta * p
        gamma = gamma_new
    return x, gamma


def lsqr_solve(matvec: Callable[[Tensor], Tensor],
               rmatvec: Callable[[Tensor], Tensor], b: Tensor, *,
               iters: int, damp: float = 0.0) -> tuple[Tensor, Tensor]:
    """LSQR (Paige & Saunders): Golub-Kahan bidiagonalization with an
    implicit QR of the bidiagonal, from ``x0 = 0``.

    Returns ``(x, rnorm_sq_estimate)``: the recurrence's estimate of
    ``||A x - b||^2 + damp^2 ||x||^2`` (``||r||^2`` when ``damp == 0``)."""
    dampf = _scalar(damp, b)
    one = _scalar(1, b)
    beta = torch.sqrt(_dot(b, b))
    u = b * _safe_div(one, beta)
    av = rmatvec(u)
    alpha = torch.sqrt(_dot(av, av))
    v = av * _safe_div(one, alpha)
    x = torch.zeros_like(v)
    w = v
    phibar, rhobar = beta, alpha
    psi2 = _scalar(0, b)
    for _ in range(int(iters)):
        # Bidiagonalization: beta_{i+1} u_{i+1} = A v_i - alpha_i u_i,
        #                    alpha_{i+1} v_{i+1} = A^T u_{i+1} - beta v_i.
        u = matvec(v) - alpha * u
        beta = torch.sqrt(_dot(u, u))
        u = u * _safe_div(one, beta)
        v_next = rmatvec(u) - beta * v
        alpha = torch.sqrt(_dot(v_next, v_next))
        v = v_next * _safe_div(one, alpha)
        # Eliminate the damping entry.
        rhobar1 = torch.sqrt(rhobar**2 + dampf**2)
        c1 = _safe_div(rhobar, rhobar1)
        s1 = _safe_div(dampf, rhobar1)
        psi = s1 * phibar
        phibar1 = c1 * phibar
        # Plane rotation eliminating beta_{i+1}.
        rho = torch.sqrt(rhobar1**2 + beta**2)
        c = _safe_div(rhobar1, rho)
        s = _safe_div(beta, rho)
        theta = s * alpha
        rhobar = -c * alpha
        phi = c * phibar1
        phibar = s * phibar1
        x = x + _safe_div(phi, rho) * w
        w = v - _safe_div(theta, rho) * w
        psi2 = psi2 + psi**2
    return x, phibar**2 + psi2


def lsmr_solve(matvec: Callable[[Tensor], Tensor],
               rmatvec: Callable[[Tensor], Tensor], b: Tensor, *,
               iters: int, damp: float = 0.0) -> tuple[Tensor, Tensor]:
    """LSMR (Fong & Saunders): MINRES on the normal equations through the
    Golub-Kahan bidiagonalization of :func:`lsqr_solve`, from ``x0 = 0``.

    Returns ``(x, gnorm_sq_estimate)``: the recurrence's estimate of
    ``||A^T r - damp^2 x||^2``."""
    dampf = _scalar(damp, b)
    one = _scalar(1, b)
    beta1 = torch.sqrt(_dot(b, b))
    u = b * _safe_div(one, beta1)
    av = rmatvec(u)
    alpha = torch.sqrt(_dot(av, av))
    v = av * _safe_div(one, alpha)
    x = torch.zeros_like(v)
    h = v
    hbar = torch.zeros_like(v)
    alphabar = alpha
    cbar, sbar = one, _scalar(0, b)
    zetabar = alpha * beta1
    rho_old, rhobar_old = one, one
    for _ in range(int(iters)):
        u = matvec(v) - alpha * u
        beta = torch.sqrt(_dot(u, u))
        u = u * _safe_div(one, beta)
        v_n = rmatvec(u) - beta * v
        alpha = torch.sqrt(_dot(v_n, v_n))
        v = v_n * _safe_div(one, alpha)
        # Damping rotation on alphabar, then the first QR rotation.
        alphahat = torch.sqrt(alphabar**2 + dampf**2)
        rho = torch.sqrt(alphahat**2 + beta**2)
        c = _safe_div(alphahat, rho)
        s = _safe_div(beta, rho)
        theta_new = s * alpha
        alphabar = c * alpha
        # Second rotation (the MINRES-on-T part).
        thetabar = sbar * rho
        rhotemp = cbar * rho
        rhobar = torch.sqrt(rhotemp**2 + theta_new**2)
        cbar = _safe_div(rhotemp, rhobar)
        sbar = _safe_div(theta_new, rhobar)
        zeta = cbar * zetabar
        zetabar = -sbar * zetabar
        hbar = h - _safe_div(thetabar * rho, rho_old * rhobar_old) * hbar
        x = x + _safe_div(zeta, rho * rhobar) * hbar
        h = v - _safe_div(theta_new, rho) * h
        rho_old, rhobar_old = rho, rhobar
    return x, zetabar**2

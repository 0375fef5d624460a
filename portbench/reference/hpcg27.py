"""Plain reference of the HPCG cells: the operator from the generated
entries (a COO product), CG by K4's iteration and Jacobi-preconditioned CG
by ``pcg_solve``'s, in the dtype asked for.

Numbers compared for each sampled solve (the largest over the samples):

* ``x_err``: ``||x - x_ref|| / ||x_ref||``, the solution after the same
  number of iterations from the same right-hand side;
* ``res_err``: ``|rho - rho_ref|`` with ``rho = ||b - A x|| / ||b||``
  formed in float64 by the reference's operator: the true residual of the
  program's answer against the reference's.
"""

from __future__ import annotations

import torch

from ..gen import hpcg27
from .common import CooOperator, finite, rel_gap

Tensor = torch.Tensor


def operator(cfg: dict, device) -> CooOperator:
    idx, vals = hpcg27.entries(cfg, device)
    rows, cols = idx[:, 0].contiguous(), idx[:, 1].contiguous()
    del idx
    return CooOperator(rows, cols, vals, hpcg27.n_rows(cfg))


def _guard(d: Tensor) -> Tensor:
    return torch.where(d == 0, torch.ones_like(d), d)


def cg(op: CooOperator, b: Tensor, iters: int, dtype) -> Tensor:
    """K4's iteration: ``x = 0, r = p = b``; ``p = r + beta p``, ``Ap``,
    ``alpha = rs / p.Ap``, ``x += alpha p``, ``r -= alpha Ap``, ``beta =
    r.r / rs``; both divisions guarded against 0."""
    b = b.to(dtype)
    x = torch.zeros_like(b)
    r = b.clone()
    p = torch.zeros_like(b)
    rs = torch.dot(r, r)
    beta = torch.zeros_like(rs)
    for _ in range(iters):
        p = r + beta * p
        Ap = op.matvec(p)
        alpha = rs / _guard(torch.dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        rsnew = torch.dot(r, r)
        beta = rsnew / _guard(rs)
        rs = rsnew
    return x


def pcg(op: CooOperator, b: Tensor, iters: int, dtype) -> Tensor:
    """Jacobi-preconditioned CG from ``x = 0``: ``r = b - A x``, ``z =
    M^-1 r``, ``p = z``; ``alpha = r.z / p.Ap``, ``x += alpha p``, ``r -=
    alpha Ap``, ``z = M^-1 r``, ``beta = r.z_new / r.z``, ``p = z + beta
    p``; ``M^-1 = 1 / diag(A)``."""
    minv = (1.0 / op.diagonal()).to(dtype)
    b = b.to(dtype)
    x = torch.zeros_like(b)
    r = b - op.matvec(x)
    p = minv * r
    rz = torch.dot(r, p)
    for _ in range(iters):
        Ap = op.matvec(p)
        alpha = rz / _guard(torch.dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = minv * r
        rz_new = torch.dot(r, z)
        beta = rz_new / _guard(rz)
        p = z + beta * p
        rz = rz_new
    return x


SOLVERS = {"cg": cg, "pcg": pcg}


def check(cfg: dict, mix: dict, seed: int, device, samples: list,
          control: bool = False) -> dict:
    """Readings for ``samples``, a list of ``(pool slot, x)`` the program
    returned. With ``control``, the program's answers are ignored and the
    reference in bfloat16 stands in its place."""
    op = operator(cfg, device)
    pool = hpcg27.rhs_pool(cfg, mix["rhs_pool"], seed, device)
    solve = SOLVERS[mix["solver"]]
    out = {"x_err": 0.0, "res_err": 0.0}
    for slot, x in samples:
        b = pool[slot]
        ref = solve(op, b, mix["iters"], torch.float64)
        if control:
            x = solve(op, b, mix["iters"], torch.bfloat16)
        bd = b.double()
        bn = float(torch.linalg.vector_norm(bd))
        rho = float(torch.linalg.vector_norm(bd - op.matvec(x.double()))) / bn
        rho_ref = float(torch.linalg.vector_norm(bd - op.matvec(ref))) / bn
        out["x_err"] = max(out["x_err"], rel_gap(x, ref))
        out["res_err"] = max(out["res_err"], finite(abs(rho - rho_ref)))
    return out

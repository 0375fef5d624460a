"""Iterative, least-squares, spectral and direct solvers, preconditioners
and operators over the port's sparse ops (the JAX package's end-to-end
"model" layer): conjugate gradients (plain, preconditioned, multi-RHS,
implicit gradient), BiCGStab, CGS, TFQMR, MINRES, Chebyshev, GMRES, Lanczos
bounds, power iteration; least squares by CGLS, LSQR and LSMR; spectral by
Lanczos ``eigsh``, Arnoldi ``eigs``, LOBPCG and Golub-Kahan ``svds``, with
``expm_multiply``/``funm_multiply``; direct by the native sparse LU
(``splu``/``spilu``/``spsolve``/``factorized``/``spsolve_triangular``,
level-sweep or host triangular solves); ``inv`` and ``expm``;
``onenormest``; Jacobi, block-Jacobi, Neumann and smoothed-aggregation AMG
preconditioning; ``LinearOperator``.
"""

from .iterative import (CGState, safe_div, cg_step, cg_solve, pcg_solve,
                        cg_solve_mrhs, jacobi_preconditioner,
                        bicgstab_solve, cgs_solve, tfqmr_solve,
                        minres_solve, chebyshev_solve, gmres_solve,
                        lanczos_bounds, power_iteration, cg_solve_implicit)
from .precond import (extract_diagonal, extract_diag_blocks,
                      block_jacobi_preconditioner, neumann_preconditioner)
from .lstsq import cgls_solve, lsqr_solve, lsmr_solve
from .spectral import (lanczos_eigsh, arnoldi_eigs, lobpcg_solve,
                       svds_lanczos, funm_multiply, expm_multiply)
from .amg import amg_setup, amg_vcycle, AmgHierarchy, AmgLevel
from .linop import LinearOperator, aslinearoperator, identity_operator
from .norms import onenormest
from .direct import (SparseLU, splu, spilu, spsolve, factorized,
                     spsolve_triangular)
from .matfuncs import inv, expm
from .eigs_api import eigs, eigsh

__all__ = ["CGState", "safe_div", "cg_step", "cg_solve", "pcg_solve",
           "cg_solve_mrhs", "jacobi_preconditioner",
           "bicgstab_solve", "cgs_solve", "tfqmr_solve", "minres_solve",
           "chebyshev_solve", "gmres_solve", "lanczos_bounds",
           "power_iteration", "cg_solve_implicit",
           "extract_diagonal", "extract_diag_blocks",
           "block_jacobi_preconditioner", "neumann_preconditioner",
           "cgls_solve", "lsqr_solve", "lsmr_solve",
           "lanczos_eigsh", "arnoldi_eigs", "lobpcg_solve", "svds_lanczos",
           "funm_multiply", "expm_multiply",
           "amg_setup", "amg_vcycle", "AmgHierarchy", "AmgLevel",
           "LinearOperator", "aslinearoperator", "identity_operator",
           "onenormest",
           "SparseLU", "splu", "spilu", "spsolve", "factorized",
           "spsolve_triangular", "inv", "expm", "eigs", "eigsh"]

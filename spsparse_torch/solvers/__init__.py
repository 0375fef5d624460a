"""Iterative solvers, preconditioners and operators over the port's sparse
ops: conjugate gradients (plain, preconditioned, multi-RHS, implicit
gradient), BiCGStab, CGS, TFQMR, MINRES, Chebyshev, GMRES, Lanczos bounds,
power iteration; Jacobi, block-Jacobi and Neumann preconditioning;
``LinearOperator``.

The JAX package's other solver modules (least squares, spectral, AMG,
direct LU, matrix functions, norms) are not ported yet (ROADMAP item 20).
"""

from .iterative import (CGState, safe_div, cg_step, cg_solve, pcg_solve,
                        cg_solve_mrhs, jacobi_preconditioner,
                        bicgstab_solve, cgs_solve, tfqmr_solve,
                        minres_solve, chebyshev_solve, gmres_solve,
                        lanczos_bounds, power_iteration, cg_solve_implicit)
from .precond import (extract_diagonal, extract_diag_blocks,
                      block_jacobi_preconditioner, neumann_preconditioner)
from .linop import LinearOperator, aslinearoperator, identity_operator

__all__ = ["CGState", "safe_div", "cg_step", "cg_solve", "pcg_solve",
           "cg_solve_mrhs", "jacobi_preconditioner",
           "bicgstab_solve", "cgs_solve", "tfqmr_solve", "minres_solve",
           "chebyshev_solve", "gmres_solve", "lanczos_bounds",
           "power_iteration", "cg_solve_implicit",
           "extract_diagonal", "extract_diag_blocks",
           "block_jacobi_preconditioner", "neumann_preconditioner",
           "LinearOperator", "aslinearoperator", "identity_operator"]

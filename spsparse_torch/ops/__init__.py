"""Sparse operator layer: multiply chains, SpMV/SpMM, DIA kernels
(SpMV, chain, multi-RHS SpMM, CG)."""

from .multiply_sparse import (multiply, multiply_mv, multiply_chain,
                              expansion_size)
from .spmm import spmv, spmm
from .spmv_kernels import spmv_dia, spmv_ell, best_spmv, best_spmm
from .dia_stream import (PreparedDIA, prepare_dia, spmv_dia_stream,
                         spmv_dia_stream_reference)
from .dia_chain import spmv_dia_chain, spmv_dia_chain_reference
from .dia_mrhs import spmm_dia_mrhs, spmm_dia_mrhs_reference, RHS_BLOCK
from .dia_cg import cg_solve_dia, cg_solve_dia_reference

__all__ = [
    "multiply", "multiply_mv", "multiply_chain", "expansion_size",
    "spmv", "spmm",
    "spmv_dia", "spmv_ell", "best_spmv", "best_spmm",
    "PreparedDIA", "prepare_dia", "spmv_dia_stream",
    "spmv_dia_stream_reference",
    "spmv_dia_chain", "spmv_dia_chain_reference",
    "spmm_dia_mrhs", "spmm_dia_mrhs_reference", "RHS_BLOCK",
    "cg_solve_dia", "cg_solve_dia_reference",
]

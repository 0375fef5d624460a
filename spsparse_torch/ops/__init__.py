"""Sparse operator layer: multiply chains, SpMV/SpMM, DIA kernels
(SpMV, chain, multi-RHS SpMM, CG), tiled general SpMM kernels (super-row
window, dense-block, one-hot) and the prepared general path."""

from .multiply_sparse import (multiply, multiply_mv, multiply_chain,
                              expansion_size)
from .spmm import spmv, spmm, spmm_bsr
from .spmv_kernels import spmv_dia, spmv_ell, best_spmv, best_spmm
from .dia_stream import (PreparedDIA, prepare_dia, spmv_dia_stream,
                         spmv_dia_stream_reference)
from .dia_chain import spmv_dia_chain, spmv_dia_chain_reference
from .dia_mrhs import spmm_dia_mrhs, spmm_dia_mrhs_reference, RHS_BLOCK
from .dia_cg import cg_solve_dia, cg_solve_dia_reference
from .tiled_ops import spmv_tiled, spmm_tiled
from .tiled_spmm import (DENSE_FILL_THRESHOLD, PreparedTiledRows,
                         prepare_tiled_rows, PreparedTiledDense,
                         prepare_tiled_dense, spmm_tiled_onehot,
                         spmm_tiled_onehot_reference, spmm_tiled_dense,
                         spmm_tiled_dense_reference)
from .tiled_window import (PreparedTiledWindow, prepare_tiled_window,
                           to_tiled_dense, spmm_tiled_window,
                           spmm_tiled_window_reference)
from .general import (GATHER_FILL_THRESHOLD, PreparedGather,
                      PreparedGatherEll, PreparedGeneral, prepare_general,
                      spmm_general, spmv_general)

__all__ = [
    "multiply", "multiply_mv", "multiply_chain", "expansion_size",
    "spmv", "spmm", "spmm_bsr",
    "spmv_dia", "spmv_ell", "best_spmv", "best_spmm",
    "PreparedDIA", "prepare_dia", "spmv_dia_stream",
    "spmv_dia_stream_reference",
    "spmv_dia_chain", "spmv_dia_chain_reference",
    "spmm_dia_mrhs", "spmm_dia_mrhs_reference", "RHS_BLOCK",
    "cg_solve_dia", "cg_solve_dia_reference",
    "spmv_tiled", "spmm_tiled",
    "DENSE_FILL_THRESHOLD", "PreparedTiledRows", "prepare_tiled_rows",
    "PreparedTiledDense", "prepare_tiled_dense", "spmm_tiled_onehot",
    "spmm_tiled_onehot_reference", "spmm_tiled_dense",
    "spmm_tiled_dense_reference",
    "PreparedTiledWindow", "prepare_tiled_window", "to_tiled_dense",
    "spmm_tiled_window", "spmm_tiled_window_reference",
    "GATHER_FILL_THRESHOLD", "PreparedGather", "PreparedGatherEll",
    "PreparedGeneral", "prepare_general", "spmm_general", "spmv_general",
]

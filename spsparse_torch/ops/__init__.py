"""Sparse operator layer: multiply chains, SpGEMM (ESC, planned ESC and the
tiled band and pair kernels), SpMV/SpMM, DIA kernels (SpMV, chain,
multi-RHS SpMM, CG), tiled general SpMM kernels (super-row window,
dense-block, one-hot), the prepared general path, unstructured SpMV (the
shuffle layout and the CSR segmented sum) and the bitonic block sort."""

from .multiply_sparse import (multiply, multiply_mv, multiply_chain,
                              expansion_size)
from .spgemm import (spgemm, spgemm_aat, plan_spgemm_caps, best_spgemm,
                     coo_matrix_power)
from .spgemm_tiled import (spgemm_tiled, plan_tiled_spgemm, densify_tiled,
                           spgemm_tiled_pairs, spgemm_tiled_stream,
                           spgemm_tiled_reference)
from .spgemm_planned import plan_esc, spgemm_planned, spgemm_planned_vals
from .spgemm_window import (plan_window_spgemm, spgemm_window,
                            spgemm_window_reference)
from .spmm import spmv, spmm, spmm_bsr
from .spmv_kernels import spmv_dia, spmv_ell, best_spmv, best_spmm
from .spmv_shuffle import (PreparedShuffleSpMV, prepare_shuffle_spmv,
                           spmv_shuffle, spmv_shuffle_reference,
                           shuffle_gather, shuffle_gather_reference)
from .segsum import (segmented_row_sums, segmented_row_sums_reference,
                     csr_products, spmv_csr_segsum, pad_products,
                     max_entries_per_rowblock)
from .block_sort import (plan_stages, sort_blocks, sort_blocks_reference,
                         sort_blocks_stable)
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
    "spgemm", "spgemm_aat", "plan_spgemm_caps", "best_spgemm",
    "coo_matrix_power",
    "spgemm_tiled", "plan_tiled_spgemm", "densify_tiled",
    "spgemm_tiled_pairs", "spgemm_tiled_stream", "spgemm_tiled_reference",
    "plan_esc", "spgemm_planned", "spgemm_planned_vals",
    "plan_window_spgemm", "spgemm_window", "spgemm_window_reference",
    "spmv", "spmm", "spmm_bsr",
    "spmv_dia", "spmv_ell", "best_spmv", "best_spmm",
    "PreparedShuffleSpMV", "prepare_shuffle_spmv", "spmv_shuffle",
    "spmv_shuffle_reference", "shuffle_gather", "shuffle_gather_reference",
    "segmented_row_sums", "segmented_row_sums_reference", "csr_products",
    "spmv_csr_segsum", "pad_products", "max_entries_per_rowblock",
    "plan_stages", "sort_blocks", "sort_blocks_reference",
    "sort_blocks_stable",
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

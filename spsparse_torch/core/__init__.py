"""Core layer: COO arrays, consolidation, structure views, DIA, BSR and
tiled storage, joins, accumulators, constructors, elementwise algebra,
reordering and scipy interop."""

from .errors import (
    DuplicatePolicy,
    SpSparseError,
    set_error_handler,
    set_dump_stack_on_error,
    spsparse_error,
    isnone,
    ROW_MAJOR,
    COL_MAJOR,
)
from .device import default_device, resolve_device
from .coo import SparseCOO, CooBuilder, coo_matrix, coo_vector
from .consolidate import (
    consolidate,
    sorted_permutation,
    merge_sorted_entries,
    filter_compact,
    Consolidated,
)
from .structure import (
    dim_beginnings,
    DimBeginnings,
    SparseCSR,
    SparseELL,
    to_csr,
    to_csc,
    to_ell,
)
from .dia import SparseDIA, to_dia, dia_to_coo
from .bsr import SparseBSR, to_bsr
from .tiled import SparseTiledCOO, to_tiled, pack_columns
from .algebra import (coo_concat, coo_add, coo_scale,
                      coo_hstack, coo_vstack, coo_block_diag,
                      coo_binop, coo_multiply, coo_maximum, coo_minimum,
                      coo_power)
from .reorder import rcm_permutation, coo_permute, bandwidth
from .construct import (coo_eye, coo_diags, coo_random, coo_slice, coo_kron,
                        coo_kronsum,
                        coo_filter, coo_tril, coo_triu, coo_norm,
                        row_sums, col_sums, scale_rows, scale_cols)
from .join import JoinResult, join2, join3, intersect_mask
from .accum import scatter_to_dense, scalar_sum, permute_output, project_output
from .interop import from_scipy, to_scipy

__all__ = [
    "DuplicatePolicy", "SpSparseError", "set_error_handler",
    "set_dump_stack_on_error", "spsparse_error",
    "isnone", "ROW_MAJOR", "COL_MAJOR", "default_device", "resolve_device",
    "SparseCOO", "CooBuilder", "coo_matrix", "coo_vector",
    "consolidate", "sorted_permutation", "merge_sorted_entries",
    "filter_compact", "Consolidated",
    "dim_beginnings", "DimBeginnings", "SparseCSR", "SparseELL",
    "to_csr", "to_csc", "to_ell",
    "SparseDIA", "to_dia", "dia_to_coo",
    "SparseBSR", "to_bsr", "SparseTiledCOO", "to_tiled", "pack_columns",
    "coo_concat", "coo_add", "coo_scale",
    "coo_binop", "coo_multiply", "coo_maximum", "coo_minimum", "coo_power",
    "coo_hstack", "coo_vstack", "coo_block_diag", "coo_norm",
    "coo_eye", "coo_diags", "coo_random", "coo_slice", "coo_kron",
    "coo_kronsum",
    "coo_filter", "coo_tril", "coo_triu",
    "rcm_permutation", "coo_permute", "bandwidth",
    "row_sums", "col_sums", "scale_rows", "scale_cols",
    "JoinResult", "join2", "join3", "intersect_mask",
    "scatter_to_dense", "scalar_sum", "permute_output", "project_output",
    "from_scipy", "to_scipy",
]

"""Core layer: COO arrays, consolidation, structure views, DIA, BSR and
tiled storage, and the identity constructor."""

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
from .construct import coo_eye

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
    "coo_eye",
]

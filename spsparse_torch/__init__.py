"""spsparse_torch: the PyTorch/CUDA port of spsparse-tpu.

The same library as :mod:`spsparse_tpu` — rank-N padded COO arrays,
duplicate-consolidating sort, CSR/ELL/DIA views, the diag-scaled sparse
multiply chain, SpMV/SpMM over DIA, BSR, tiled and prepared general
operands, and NetCDF I/O — on PyTorch tensors, with the
TPU's Pallas kernels rewritten as hand-written CUDA kernels for Hopper
(``spsparse_torch/csrc``, built by :mod:`spsparse_torch.backend` on first
use). Every kernel has a plain PyTorch version beside it, taken for CPU
tensors. This package imports neither JAX nor :mod:`spsparse_tpu`.
"""

from .core import (
    DuplicatePolicy,
    SpSparseError,
    set_error_handler,
    set_dump_stack_on_error,
    isnone,
    ROW_MAJOR,
    COL_MAJOR,
    SparseCOO,
    CooBuilder,
    coo_matrix,
    coo_vector,
    consolidate,
    sorted_permutation,
    filter_compact,
    Consolidated,
    dim_beginnings,
    DimBeginnings,
    SparseCSR,
    SparseELL,
    to_csr,
    to_csc,
    to_ell,
    SparseDIA,
    to_dia,
    SparseBSR,
    to_bsr,
    SparseTiledCOO,
    to_tiled,
    coo_eye,
    default_device,
)

from . import backend, convert, core, io, ops, solvers, utils  # noqa: E402

__version__ = "0.1.0"

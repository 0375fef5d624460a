"""spsparse_torch: the PyTorch/CUDA port of spsparse-tpu.

The same library as :mod:`spsparse_tpu` — rank-N padded COO arrays,
duplicate-consolidating sort, CSR/ELL/DIA views, the diag-scaled sparse
multiply chain, SpMV/SpMM over DIA, BSR, tiled and prepared general
operands, SpGEMM, unstructured SpMV (the shuffle layout, the CSR segmented
sum), the bitonic block sort, sorted-merge joins, accumulators,
constructors, elementwise algebra, RCM reordering, scipy interop, the
``scipy.sparse.csgraph`` tier (semiring SpMV), NetCDF I/O (classic and
NetCDF-4, and sharded checkpoints), scipy ``.npz`` files, the command line
tools and the distributed layer (row-partitioned operands over a mesh of
partitions on one device or one ``torch.distributed`` rank each) — on PyTorch
tensors, with the
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
    coo_concat,
    coo_binop,
    coo_multiply,
    coo_maximum,
    coo_minimum,
    coo_power,
    coo_add,
    coo_scale,
    coo_hstack,
    coo_vstack,
    coo_block_diag,
    coo_norm,
    coo_eye,
    coo_diags,
    coo_random,
    coo_slice,
    coo_kron,
    coo_kronsum,
    coo_filter,
    coo_tril,
    coo_triu,
    rcm_permutation,
    coo_permute,
    bandwidth,
    row_sums,
    col_sums,
    scale_rows,
    scale_cols,
    join2,
    join3,
    scatter_to_dense,
    scalar_sum,
    permute_output,
    project_output,
    default_device,
)

from . import (backend, convert, core, dist, graph, io, ops,  # noqa: E402
               solvers, tools, utils)

__version__ = "0.1.0"

"""SpGEMM entry points: plain and Gram products, the structure-dispatched
product, matrix powers and capacity planning.

Counterpart of :mod:`spsparse_tpu.ops.spgemm`. The general engine is the
ESC multiply (:func:`spsparse_torch.ops.multiply`); :func:`best_spgemm`
sends operands whose nonzeros fill their 128x128 tiles to the tiled
kernels (:func:`spsparse_torch.ops.spgemm_tiled.spgemm_tiled`: the band
kernel K8 or the pair kernel K9) instead.
"""

from __future__ import annotations

import torch

from ..core.coo import SparseCOO, round_up_pow2
from ..core.errors import DuplicatePolicy, SpSparseError
from ..core.structure import to_csr
from ..core.tiled import to_tiled
from ..utils.trace import trace_scope
from .multiply_sparse import multiply
from .spgemm_tiled import spgemm_tiled
from .tiled_spmm import DENSE_FILL_THRESHOLD

__all__ = ["spgemm", "spgemm_aat", "plan_spgemm_caps", "best_spgemm",
           "coo_matrix_power"]


def spgemm(A: SparseCOO, B: SparseCOO, *, transpose_a: bool = False,
           transpose_b: bool = False, cap: int | None = None,
           expand_cap: int | None = None,
           duplicate_policy: DuplicatePolicy = DuplicatePolicy.ADD,
           zero_nan: bool = False) -> SparseCOO:
    """``C = A^(T?) @ B^(T?)``: the ESC multiply chain without scales (the
    fully general path)."""
    return multiply(1.0, A, B, transpose_a=transpose_a,
                    transpose_b=transpose_b, cap=cap, expand_cap=expand_cap,
                    duplicate_policy=duplicate_policy, zero_nan=zero_nan)


def spgemm_aat(A: SparseCOO, *, cap: int | None = None,
               expand_cap: int | None = None) -> SparseCOO:
    """Gram product ``A @ A^T`` through the ESC multiply (bench config 4's
    regridding pattern)."""
    return spgemm(A, A, transpose_b=True, cap=cap, expand_cap=expand_cap)


def _tile_fill(x: SparseCOO) -> float:
    """Nonzero entries per occupied 128x128 tile."""
    tl = to_tiled(x)
    return int((tl.vals != 0).sum()) / max(tl.n_tiles, 1)


def best_spgemm(A: SparseCOO, B: SparseCOO, *, transpose_b: bool = False,
                cap: int | None = None) -> SparseCOO:
    """Structure-dispatched ``C = A @ B^(T?)`` (eager).

    When both operands' tile fill reaches :data:`DENSE_FILL_THRESHOLD`
    (a TPU crossover, kept so that both packages route alike) and neither
    is float64, the tiled kernels compute it (their float32 blocks would
    round float64); otherwise the ESC multiply. The result is row-major
    consolidated with zeros dropped either way. With the host event log
    on, each call records its route, ``"tiled"`` or ``"esc"``."""
    f64 = torch.float64 in (A.dtype, B.dtype)
    if not f64 and min(_tile_fill(A), _tile_fill(B)) >= DENSE_FILL_THRESHOLD:
        with trace_scope("spsparse.best_spgemm", route="tiled"):
            out = spgemm_tiled(A, B, transpose_b=transpose_b, cap=cap)
            return out.consolidate((0, 1))
    with trace_scope("spsparse.best_spgemm", route="esc"):
        return spgemm(A, B, transpose_b=transpose_b, cap=cap)


def coo_matrix_power(A: SparseCOO, k: int) -> SparseCOO:
    """``A**k`` of a square matrix by binary exponentiation over
    :func:`best_spgemm` (``O(log k)`` products, each dispatched by
    structure). ``k == 0`` gives the identity on ``A``'s device."""
    from ..core.construct import coo_eye

    k = int(k)
    if k < 0:
        raise SpSparseError("coo_matrix_power: negative powers need an "
                            "explicit solve; k must be >= 0")
    if A.rank != 2 or A.shape[0] != A.shape[1]:
        raise SpSparseError(f"coo_matrix_power needs a square matrix, "
                            f"got {A.shape}")
    if k == 0:
        return coo_eye(int(A.shape[0]), dtype=A.dtype, device=A.device)
    result = None
    base = A
    while k:
        if k & 1:
            result = base if result is None else best_spgemm(result, base)
        k >>= 1
        if k:
            base = best_spgemm(base, base)
    return result


def plan_spgemm_caps(A: SparseCOO, B: SparseCOO, *,
                     transpose_a: bool = False, transpose_b: bool = False,
                     safety: float = 1.0) -> tuple[int, int]:
    """Exact capacity plan of a SpGEMM (eager): ``(expand_cap, out_cap)``,
    the number of elementary products (the Gustavson count) and a bound
    ``min(expand_cap, rows*cols)`` on the output nnz, scaled by ``safety``
    and rounded up to powers of two."""
    Aw = A.transposed((1, 0)) if transpose_a else A
    Bw = B.transposed((1, 0)) if transpose_b else B
    acon = Aw.consolidate((0, 1))
    bcsr = to_csr(Bw.consolidate((0, 1)))
    k = acon.indices[: acon.nnz, 1].long()
    row_len = (bcsr.row_ptr[1:] - bcsr.row_ptr[:-1]).long()
    expand = int(row_len[k.clamp(max=bcsr.nrows - 1)].sum())
    expand = max(int(expand * safety), 1)
    out = min(expand, Aw.shape[0] * Bw.shape[1])
    return round_up_pow2(expand), round_up_pow2(max(out, 1))

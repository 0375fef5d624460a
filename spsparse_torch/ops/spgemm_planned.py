"""Static-pattern ("planned") ESC SpGEMM: the sorts at plan time, none at
apply time.

Counterpart of :mod:`spsparse_tpu.ops.spgemm_planned`. For repeated
products over a fixed sparsity pattern, everything the ESC multiply sorts
depends only on the pattern. :func:`plan_esc` expands and sorts once on the
host (numpy) and returns two gather maps ``ea``/``eb`` into the
consolidated operands' values, the sorted output-cell id ``seg`` of each
product and the output cells; the apply :func:`spgemm_planned_vals` is then

    out[c] = sum over products s of cell c of  va[ea[s]] * vb[eb[s]]

two gathers, one multiply and one ``index_add_``. The JAX apply is XLA code
(``take`` and a sorted ``segment_sum``), so plain PyTorch is its port; no
hand kernel is owed.

As in the JAX package, the output pattern is static: a cell whose products
sum to exactly zero stays, with value 0 (unlike
:func:`spsparse_torch.ops.spgemm.spgemm`, which drops it). Products of a
cell are in ascending ``(i, k)`` order.

``plan_esc(host=True)`` consolidates the operands on the host in float64
(this module's copy of the JAX package's numpy consolidate, not an
import), so a float32 duplicate sum can differ by one ulp from the device
path, and its consolidated operands come back exact-size.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.coo import SparseCOO
from ..core.errors import spsparse_error

__all__ = ["EscPlan", "plan_esc", "spgemm_planned_vals", "spgemm_planned"]

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EscPlan:
    """Product plan over consolidated operand patterns.

    ``ea/eb (P,)`` int32 index the consolidated operands' value vectors
    (products sorted by output cell, ascending ``(i, k)`` within a cell);
    ``seg (P,)`` int32 sorted output-cell ids; ``out_indices (n_out, 2)``
    the output cells (row-major sorted)."""

    ea: Tensor
    eb: Tensor
    seg: Tensor
    out_indices: Tensor
    n_out: int
    out_shape: tuple

    @property
    def n_products(self) -> int:
        return self.ea.shape[0]


def _numpy_consolidate(indices: np.ndarray, vals: np.ndarray):
    """Row-major consolidate(ADD) in float64: drop zeros, lexsort, sum the
    runs of equal index tuples in order."""
    keep = vals != 0
    idx, v = indices[keep], vals[keep]
    if idx.shape[0] == 0:
        return idx.reshape(0, indices.shape[1]), v
    order = np.lexsort(tuple(idx[:, d] for d in reversed(range(idx.shape[1]))))
    idx, v = idx[order], v[order]
    starts = np.concatenate([[True], np.any(idx[1:] != idx[:-1], axis=1)])
    seg = np.cumsum(starts) - 1
    out_v = np.zeros(int(starts.sum()), v.dtype)
    np.add.at(out_v, seg, v)
    return idx[starts], out_v


def _consolidate_host_coo(M: SparseCOO) -> SparseCOO:
    """Row-major host consolidate of ``M``'s live entries (float64 sums),
    as an exact-size :class:`SparseCOO` on ``M``'s device."""
    n = M.nnz
    idx = M.indices[:n].cpu().numpy().astype(np.int64)
    vals = M.vals[:n].cpu().to(torch.float64).numpy()
    out_idx, out_vals = _numpy_consolidate(idx, vals)
    return SparseCOO(
        indices=torch.from_numpy(out_idx).to(M.device, M.index_dtype),
        vals=torch.from_numpy(out_vals).to(M.device, M.dtype),
        nnz=out_idx.shape[0], shape=M.shape, sort_order=(0, 1))


def plan_esc(A: SparseCOO, B: SparseCOO, *, transpose_a: bool = False,
             transpose_b: bool = False, host: bool = False):
    """Plan ``A^(T?) @ B^(T?)`` (eager). Returns ``(plan, acon, bcon)``:
    ``acon``/``bcon`` are the consolidated operands whose ``.vals`` slots
    the plan's gather maps index; one plan serves any number of value
    updates with the same pattern. The plan lives on ``A``'s device.

    ``host=True`` consolidates on the host (numpy, float64 sums) instead of
    the operands' device; the pattern is the same, and ``acon``/``bcon``
    are exact-size rather than padded to a power of two."""
    if A.rank != 2 or B.rank != 2:
        spsparse_error(-1, "plan_esc requires rank-2 operands")
    Aw = A.transposed((1, 0)) if transpose_a else A
    Bw = B.transposed((1, 0)) if transpose_b else B
    if Aw.shape[1] != Bw.shape[0]:
        spsparse_error(
            -1, "Inner dimensions for A (%d) and B (%d) must match!",
            Aw.shape[1], Bw.shape[0])
    if host:
        acon = _consolidate_host_coo(Aw)
        bcon = _consolidate_host_coo(Bw)
    else:
        acon = Aw.consolidate((0, 1))
        bcon = Bw.consolidate((0, 1))
    na, nb = acon.nnz, bcon.nnz
    a_idx = acon.indices[:na].cpu().numpy().astype(np.int64)
    b_idx = bcon.indices[:nb].cpu().numpy().astype(np.int64)
    ai, ak = a_idx[:, 0], a_idx[:, 1]
    bk, bj = b_idx[:, 0], b_idx[:, 1]

    # Expansion: every A entry meets the entries of B's row k.
    b_start = np.searchsorted(bk, np.arange(Bw.shape[0] + 1))
    cnt = b_start[np.minimum(ak + 1, Bw.shape[0])] - \
        b_start[np.minimum(ak, Bw.shape[0])]
    ea = np.repeat(np.arange(na), cnt)
    if ea.size:
        within = np.arange(ea.size) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        eb = b_start[ak[ea]] + within
    else:
        eb = np.zeros(0, np.int64)

    # Sort by output cell, ascending (i, k) within a cell.
    i_p, j_p = ai[ea], bj[eb]
    order = np.lexsort((ea, j_p, i_p))
    ea, eb, i_p, j_p = ea[order], eb[order], i_p[order], j_p[order]
    cell = i_p * Bw.shape[1] + j_p
    first = np.ones(cell.shape[0], bool)
    first[1:] = cell[1:] != cell[:-1]
    seg = np.cumsum(first) - 1
    n_out = int(first.sum())
    out_idx = np.stack([i_p[first], j_p[first]], axis=1)
    dev = A.device

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    plan = EscPlan(ea=i32(ea), eb=i32(eb), seg=i32(seg),
                   out_indices=torch.from_numpy(out_idx).to(
                       acon.index_dtype).to(dev),
                   n_out=n_out, out_shape=(Aw.shape[0], Bw.shape[1]))
    return plan, acon, bcon


def spgemm_planned_vals(plan: EscPlan, va: Tensor, vb: Tensor) -> Tensor:
    """Output values of the plan's cells (``max(n_out, 1)`` long) from the
    consolidated operands' value vectors ``va``/``vb``."""
    prod = va[plan.ea] * vb[plan.eb]
    out = torch.zeros(max(plan.n_out, 1), dtype=prod.dtype,
                      device=prod.device)
    return out.index_add_(0, plan.seg, prod)


def spgemm_planned(plan: EscPlan, va: Tensor, vb: Tensor) -> SparseCOO:
    """The apply as a row-major sorted :class:`SparseCOO` (static pattern;
    exact-zero sums kept)."""
    vals = spgemm_planned_vals(plan, va, vb)
    if plan.n_out == 0:
        return SparseCOO.empty(plan.out_shape, 1, device=vals.device)
    return SparseCOO(indices=plan.out_indices, vals=vals, nnz=plan.n_out,
                     shape=plan.out_shape, sort_order=(0, 1))

"""Semiring SpMV — the primitive under every graph algorithm of the tier.

Counterpart of :mod:`spsparse_tpu.graph.semiring`. Breadth-first search,
Bellman-Ford shortest paths, reachability, label propagation (connected
components) and Boruvka's MST rounds are all iterated sparse
matrix-vector products over a *semiring* other than (+, x): min-plus for
shortest paths, or-and for reachability, min-min for label propagation.
One relaxation round is one gather plus one segmented reduction over the
edge list.

The JAX package runs these rounds as XLA ops (``jnp.take`` and
``jax.ops.segment_min/max/sum``), not as Pallas kernels, so the port's
counterparts are PyTorch's own gather (advanced indexing) and
``Tensor.scatter_reduce_`` (``amin``/``amax``/``sum``) into a buffer that
holds the reduction's identity, or ``amin``/``amax``/``sum`` over a
dimension on the ELL-by-head plan.

Frontier shape convention: ``x`` is ``(n,)`` for a single source or
``(n, k)`` for ``k`` simultaneous sources or labels. On the device the
frontier is held as ``(k, n)`` (:func:`by_column`), and the reductions run
over the live edges only (:func:`live_edges`): both are the same
arithmetic as the JAX package's, element for element, in a layout that
suits the card's gathers and atomics.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core.coo import SparseCOO, operand_tensor
from ..core.errors import SpSparseError
from ..utils.trace import log_event

__all__ = [
    "Semiring", "MIN_PLUS", "MAX_PLUS", "MIN_MIN", "MAX_MIN", "OR_AND",
    "PLUS_TIMES", "spmv_semiring", "edge_arrays",
    "RelaxPlan", "prepare_relax", "relax",
]

Tensor = torch.Tensor

_REDUCE = {"min": "amin", "max": "amax", "sum": "sum"}
_COMBINE = {"min": torch.minimum, "max": torch.maximum, "sum": torch.add}


def _empty_value(combine: str, dtype: torch.dtype):
    """What ``jax.ops.segment_<combine>`` leaves in a segment that receives
    nothing: the reduction's identity for the dtype (``+inf``/``-inf`` or
    the integer extremes for min/max, 0 for sum)."""
    if combine == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if combine == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if combine == "min" else info.min


def segment_reduce(data: Tensor, segment_ids: Tensor, num: int,
                   combine: str) -> Tensor:
    """``jax.ops.segment_<combine>`` along the last axis: ``data ([k,] E)``
    reduced into ``([k,] num)`` by ``segment_ids (E,)``. A segment that
    receives nothing keeps the reduction's identity, as the JAX op leaves
    it. Ids must lie in ``[0, num)``."""
    if combine not in _REDUCE:
        raise SpSparseError(f"unknown combine {combine!r}")
    out = torch.full(tuple(data.shape[:-1]) + (num,),
                     _empty_value(combine, data.dtype), dtype=data.dtype,
                     device=data.device)
    idx = segment_ids.long().expand_as(data)
    return out.scatter_reduce_(-1, idx, data, _REDUCE[combine],
                               include_self=True)


def by_column(x: Tensor) -> Tensor:
    """A frontier ``(n,)`` or ``(n, k)`` as ``(k, n)``, each column a
    contiguous row. The device rounds gather node values along these rows:
    on an H100 gathering 4M rows of an ``(n, 8)`` float64 frontier took
    2.53 ms, the same gather within the rows of ``(8, n)`` 0.26 ms
    (``tests_gpu/graph_probe.py``)."""
    return x[None] if x.ndim == 1 else x.T.contiguous()


def from_columns(yk: Tensor, ndim: int) -> Tensor:
    """Undo :func:`by_column` for a result with ``ndim`` axes."""
    return yk[0] if ndim == 1 else yk.T.contiguous()


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A (combine, extend) pair with the combine identity.

    ``extend(w, x)`` maps an edge weight and the tail node's value to the
    edge's contribution; ``combine`` reduces contributions arriving at
    each head node (one of ``'min' | 'max' | 'sum'``); ``identity`` is
    ``combine``'s identity, used for padding and out-of-frontier edges.
    """

    name: str
    combine: str                      # 'min' | 'max' | 'sum'
    extend: Callable[[Tensor, Tensor], Tensor]
    identity: float

    def segment(self, data: Tensor, segment_ids: Tensor, num: int) -> Tensor:
        """``data (E[, k])`` reduced into ``(num[, k])`` rows."""
        return from_columns(segment_reduce(by_column(data), segment_ids,
                                           num, self.combine), data.ndim)


MIN_PLUS = Semiring("min_plus", "min", lambda w, x: w + x, np.inf)
MAX_PLUS = Semiring("max_plus", "max", lambda w, x: w + x, -np.inf)
#: label propagation: carry the smaller of (incoming label, edge ignored)
MIN_MIN = Semiring("min_min", "min", lambda w, x: x, np.inf)
#: bottleneck / maximum-capacity paths
MAX_MIN = Semiring("max_min", "max", lambda w, x: torch.minimum(w, x),
                   -np.inf)
#: boolean reachability on 0/1 floats (max = or, * = and)
OR_AND = Semiring("or_and", "max", lambda w, x: x * (w != 0), 0.0)
PLUS_TIMES = Semiring("plus_times", "sum", lambda w, x: w * x, 0.0)


def _check_square(a: SparseCOO) -> None:
    if a.rank != 2 or a.shape[0] != a.shape[1]:
        raise SpSparseError(
            f"graph algorithms need a square rank-2 array, got {a.shape}")


def edge_arrays(a: SparseCOO, *, directed: bool = True,
                unweighted: bool = False):
    """Edge list ``(tails, heads, weights, live)`` of a rank-2 graph, on
    ``a``'s device.

    With ``directed=False`` every stored edge is emitted in both
    orientations (scipy.sparse.csgraph's undirected convention), so the
    arrays have length ``2*cap``. Padding slots come back with
    ``live=False`` and node id 0, so callers can mask contributions to
    the semiring identity without indexing out of range.
    """
    _check_square(a)
    live = a.valid_mask()
    zero = torch.zeros((), dtype=a.index_dtype, device=a.device)
    t = torch.where(live, a.indices[:, 0], zero)
    h = torch.where(live, a.indices[:, 1], zero)
    vals = torch.ones_like(a.vals) if unweighted else a.vals
    w = torch.where(live, vals, torch.zeros((), dtype=a.dtype,
                                            device=a.device))
    if not directed:
        t, h = torch.cat([t, h]), torch.cat([h, t])
        w = torch.cat([w, w])
        live = torch.cat([live, live])
    return t, h, w, live


@dataclasses.dataclass(frozen=True)
class RelaxPlan:
    """Scatter-free relaxation layout: incoming edges grouped by head into
    ELL rows — ``tails (n, K)`` int32 and ``weights (n, K)`` float64,
    padded with a self-pointing tail, ``pad (n, K)`` true on padding. One
    relaxation round is a dense gather plus a reduction over the K axis.
    Built once a graph on the host (:func:`prepare_relax`), relaxed many
    times on the device."""

    tails: Tensor
    weights: Tensor
    pad: Tensor
    n: int = 0

    @property
    def k(self) -> int:
        return int(self.tails.shape[1])

    @property
    def device(self) -> torch.device:
        return self.tails.device


def prepare_relax(a: SparseCOO, *, directed: bool = True,
                  unweighted: bool = False) -> RelaxPlan:
    """Group the edges by head node into the ELL-by-head layout, on the
    host in numpy (a one-time planning cost), then move the plan to
    ``a``'s device. ``K`` is the largest in-degree (after symmetrization
    when ``directed=False``), so the layout suits bounded in-degrees —
    mesh and coupling graphs; for power-law in-degrees prefer
    :func:`spmv_semiring`."""
    _check_square(a)
    n = int(a.shape[0])
    idx = a.indices[: a.nnz].cpu().numpy()
    t = idx[:, 0].astype(np.int64)
    h = idx[:, 1].astype(np.int64)
    w = a.vals[: a.nnz].cpu().double().numpy()
    if unweighted:
        w = np.ones_like(w)
    if not directed:
        t, h = np.concatenate([t, h]), np.concatenate([h, t])
        w = np.concatenate([w, w])
    order = np.argsort(h, kind="stable")
    t, h, w = t[order], h[order], w[order]
    ptr = np.searchsorted(h, np.arange(n + 1))
    deg = ptr[1:] - ptr[:-1]
    K = max(int(deg.max()) if n else 0, 1)
    tails = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, K))
    weights = np.zeros((n, K))
    pad = np.ones((n, K), bool)
    slot = np.arange(len(h)) - ptr[h]           # position within its row
    tails[h, slot] = t
    weights[h, slot] = w
    pad[h, slot] = False
    dev = a.device
    return RelaxPlan(tails=torch.from_numpy(tails).to(dev),
                     weights=torch.from_numpy(weights).to(dev),
                     pad=torch.from_numpy(pad).to(dev), n=n)


def relax(plan: RelaxPlan, x, semiring: Semiring) -> Tensor:
    """One scatter-free relaxation round over the prepared layout:
    ``y[j] = combine_k extend(weights[j, k], x[tails[j, k]])`` — a dense
    gather plus a min/max/sum over the K axis; the same result as
    :func:`spmv_semiring` on the same graph (sums up to their order).
    ``x`` may be ``(n,)`` or ``(n, k)``."""
    x = operand_tensor(x, plan.device)
    return from_columns(relax_columns(plan, by_column(x), semiring), x.ndim)


def relax_columns(plan: RelaxPlan, xk: Tensor, semiring: Semiring) -> Tensor:
    """:func:`relax` on a frontier held as ``(k, n)`` (:func:`by_column`);
    the result ``(k, n)`` too."""
    k, n = xk.shape
    gathered = xk[:, plan.tails.reshape(-1).long()].view(k, n, plan.k)
    contrib = semiring.extend(plan.weights.to(xk.dtype), gathered)
    ident = torch.tensor(semiring.identity, dtype=contrib.dtype,
                         device=contrib.device)
    contrib = torch.where(plan.pad, ident, contrib)
    if semiring.combine == "min":
        return contrib.amin(dim=-1)
    if semiring.combine == "max":
        return contrib.amax(dim=-1)
    return contrib.sum(dim=-1)


def spmv_semiring(a: SparseCOO, x, semiring: Semiring, *,
                  transpose: bool = False, directed: bool = True,
                  unweighted: bool = False) -> Tensor:
    """One relaxation round: ``y[j] = combine over edges (i, j) of
    extend(w_ij, x[i])``.

    ``x`` may be ``(n,)`` or ``(n, k)``; the result matches. A node with
    no incoming edge gets the reduction's identity for the dtype (what
    ``jax.ops.segment_*`` leaves), NOT ``x``'s old value; compose with
    ``torch.minimum(x, y)`` etc. for monotone fixpoints. Works on
    unsorted, duplicate-bearing COO directly.
    """
    t, h, w, live = edge_arrays(a, directed=directed, unweighted=unweighted)
    if transpose:
        t, h = h, t
    t, h, w = live_edges(live, t.long(), h.long(), w)
    x = operand_tensor(x, a.device)
    xk = by_column(x)
    contrib = semiring.extend(w.to(x.dtype), xk[:, t])     # (k, E)
    yk = segment_reduce(contrib, h, int(a.shape[0]), semiring.combine)
    if t.shape[0] < live.shape[0]:
        # the padding slots' identity lands on node 0, as in the JAX
        # package (OR_AND's identity 0 is not the empty max -inf)
        ident = torch.tensor(semiring.identity, dtype=yk.dtype,
                             device=yk.device)
        yk[:, 0] = _COMBINE[semiring.combine](yk[:, 0], ident)
    return from_columns(yk, x.ndim)


def live_edges(live: Tensor, *arrays: Tensor) -> tuple:
    """``arrays`` cut to their live slots. Padding slots all name node 0,
    so reducing them would make every one an atomic on node 0's row (on
    an H100, 5.3 ms against 0.08 for labels over W's edges with three
    quarters dead, ``tests_gpu/graph_probe.py``); their contributions are
    identities, and dropping them changes no result."""
    keep = torch.nonzero(live).squeeze(1)
    log_event("graph.live_edges", rounds=0, syncs=1)
    return tuple(arr[keep] for arr in arrays)

"""Graph algorithms over sparse adjacency matrices — the
``scipy.sparse.csgraph`` tier.

Counterpart of :mod:`spsparse_tpu.graph.csgraph`, with its split between
device and host:

* Shortest paths (Bellman-Ford, all sources in one batched pass),
  breadth-first levels, weak connected components (min-label
  propagation) and the minimum spanning tree (Boruvka rounds) are
  iterated :mod:`~spsparse_torch.graph.semiring` relaxations on the
  operand's device. Each ``lax.while_loop`` of the JAX package is a Python
  loop here whose exit test is one host sync a round; the round counts
  and ``maxiter`` semantics are the JAX package's, so results agree
  exactly. While the event log is on
  (:func:`spsparse_torch.utils.enable_event_log`) every loop logs its
  rounds and host syncs.
* Structures with data-dependent sizes or sequential pointer chasing (BFS
  and DFS orders, Tarjan's strong components, bipartite matchings,
  Dinic's maximum flow, Yen's paths) run on the host in numpy, the same
  numpy as the JAX package's. Where the JAX function returns a numpy
  array, so does the port; where it returns a device array, the port
  returns a tensor on the operand's device.

Edge semantics match scipy's sparse-input convention: explicitly stored
zeros ARE zero-weight edges (padding slots are masked out separately);
``directed=False`` lets the algorithm travel both ``G[i, j]`` and
``G[j, i]``.

The graph tier reaches no Pallas kernel in the JAX package, so it has no
hand-written CUDA kernel here: its rounds are PyTorch gathers and
``scatter_reduce_``.
"""

from __future__ import annotations

import dataclasses
import heapq
import sys
import warnings
from collections import deque

import numpy as np
import torch

from ..core.algebra import coo_add, coo_scale
from ..core.consolidate import filter_compact
from ..core.construct import coo_filter
from ..core.coo import SparseCOO, numpy_dtype, operand_tensor
from ..core.errors import SpSparseError
from ..utils.trace import log_event, traced
from .semiring import (MIN_PLUS, RelaxPlan, _check_square, edge_arrays,
                       live_edges, relax_columns, segment_reduce)

__all__ = [
    "bellman_ford", "dijkstra", "johnson", "shortest_path",
    "floyd_warshall", "bfs_levels", "breadth_first_order",
    "depth_first_order", "breadth_first_tree", "depth_first_tree",
    "connected_components", "minimum_spanning_tree",
    "laplacian", "maximum_bipartite_matching",
    "min_weight_full_bipartite_matching", "structural_rank",
    "maximum_flow", "MaximumFlowResult", "NEG_SENTINEL",
    "NegativeCycleError", "yen", "reconstruct_path", "construct_dist_matrix",
    "csgraph_from_dense", "csgraph_to_dense", "csgraph_from_masked",
    "csgraph_to_masked",
]

Tensor = torch.Tensor

#: scipy.sparse.csgraph's "no predecessor" marker.
NEG_SENTINEL = -9999


class NegativeCycleError(SpSparseError):
    """A negative-weight cycle is reachable from a requested source
    (scipy.sparse.csgraph.NegativeCycleError). Subclasses
    :class:`SpSparseError` so framework-level handlers keep working."""


def _float_dtype(a: SparseCOO) -> torch.dtype:
    return a.dtype if a.dtype.is_floating_point else torch.float64


def _node_ids(ids, device) -> Tensor:
    """Node ids (a list, array or tensor) as a 1-D tensor on ``device``."""
    return torch.atleast_1d(operand_tensor(ids, device)).to(device)


def _sources(sources, device) -> Tensor:
    return _node_ids(sources, device).to(torch.int32)


def _fixpoint(step, d: Tensor, maxiter: int, what: str) -> Tensor:
    """``d = step(d)`` once, then while ``it < maxiter`` and the last step
    lowered some entry: the JAX package's ``lax.while_loop``, with its exit
    test read on the host once a round."""
    d = step(d)
    it, changed = 0, True
    while it < maxiter and changed:
        nd = step(d)
        changed = bool((nd < d).any())
        d, it = nd, it + 1
    log_event(what, rounds=it + 1, syncs=it)
    return d


def _negative_cycle_check(step, d: Tensor, what: str) -> None:
    improving = bool((step(d) < d).any())
    log_event(what, rounds=1, syncs=1)
    if improving:
        raise NegativeCycleError(
            "bellman_ford: negative-weight cycle reachable from a source")


# ----------------------------------------------------------------------
# Shortest paths
# ----------------------------------------------------------------------

def _relax_step(t, h, w, live, n, dtype):
    """One round ``d[j] = min(d[j], min over edges (i,j) of d[i]+w)`` on
    distances held as ``(k, n)``, a source a row."""
    t, h, w = live_edges(live, t.long(), h.long(), w.to(dtype))

    def step(d):
        y = segment_reduce(d[:, t] + w, h, n, "min")     # (k, n)
        return torch.minimum(d, y)

    return step


def _predecessors(t, h, w, live, n, d):
    """Shortest-path tree from converged distances ``d (k, n)``:
    ``pred[j]`` is the tail of a minimizing incoming edge, i.e. an argmin
    over edges ``(i, j)`` of ``d[i] + w`` (ties to the smallest tail).
    Both sides of the tie test read the same contribution array, so the
    tree stays valid when ``d`` came from another summation order
    (Floyd-Warshall). Self-loops never belong to a shortest-path tree and
    are excluded. int32, ``NEG_SENTINEL`` where no finite incoming
    contribution exists."""
    t, h, w = live_edges(live & (t != h), t.long(), h.long(), w.to(d.dtype))
    c = d[:, t] + w                                      # (k, E)
    m = segment_reduce(c, h, n, "min")
    best = (c == m[:, h]) & torch.isfinite(c)
    cand = torch.where(best, t.to(torch.int32),
                       torch.tensor(n, dtype=torch.int32, device=d.device))
    pred = segment_reduce(cand, h, n, "min")
    # >= n covers both "no finite incoming contribution" (n) and "no
    # incoming edge at all" (the int32-max identity).
    return torch.where(pred >= n, torch.tensor(
        NEG_SENTINEL, dtype=torch.int32, device=d.device), pred)


def _set_sources(pred: Tensor, sources: Tensor) -> Tensor:
    k = sources.shape[0]
    pred[torch.arange(k, device=pred.device), sources.long()] = NEG_SENTINEL
    return pred


@traced("spsparse.bellman_ford")
def bellman_ford(a, sources, *, directed: bool = True,
                 unweighted: bool = False, return_predecessors: bool = False,
                 maxiter: int | None = None):
    """Multi-source Bellman-Ford shortest paths
    (scipy.sparse.csgraph.bellman_ford).

    ``sources`` is a length-``k`` array of source nodes; returns ``dist``
    of shape ``(k, n)`` (``inf`` where unreachable) on the operand's
    device and, with ``return_predecessors``, the ``(k, n)`` int32
    predecessor matrix with ``-9999`` at sources and unreachable nodes
    (scipy's convention — any valid shortest-path tree; ties broken to the
    smallest tail node).

    Negative edge weights are supported. A reachable negative cycle raises
    :class:`NegativeCycleError` when ``maxiter`` is None; with ``maxiter``
    the distances after at most that many rounds are returned unchecked.

    ``a`` may also be a :class:`~spsparse_torch.graph.semiring.RelaxPlan`
    (then ``directed``/``unweighted`` are baked in and must be left at
    their defaults): the scatter-free layout for iterated solves on the
    same graph, a gather plus a reduction over K a round.

    Runs in the ``spsparse.bellman_ford`` scope; its loop logs its rounds
    and host syncs as ``graph.bellman_ford``.
    """
    if isinstance(a, RelaxPlan):
        if not directed or unweighted:
            raise SpSparseError(
                "bellman_ford(plan): direction/weights are baked into "
                "the RelaxPlan at prepare_relax time; leave the flags "
                "at their defaults")
        return _bellman_ford_plan(a, sources, return_predecessors,
                                  maxiter)
    t, h, w, live = edge_arrays(a, directed=directed, unweighted=unweighted)
    n = int(a.shape[0])
    sources = _sources(sources, a.device)
    k = sources.shape[0]
    dt = _float_dtype(a)
    d0 = torch.full((k, n), float("inf"), dtype=dt, device=a.device)
    d0[torch.arange(k, device=a.device), sources.long()] = 0
    step = _relax_step(t, h, w, live, n, dt)
    dist = _fixpoint(step, d0, maxiter or n, "graph.bellman_ford")
    if maxiter is None:
        _negative_cycle_check(step, dist, "graph.bellman_ford.cycle_check")
    if not return_predecessors:
        return dist
    pred = _predecessors(t, h, w, live, n, dist)
    return dist, _set_sources(pred, sources)


def _bellman_ford_plan(plan: RelaxPlan, sources, return_predecessors,
                       maxiter):
    """Bellman-Ford over the scatter-free ELL-by-head layout."""
    n = plan.n
    dev = plan.device
    sources = _sources(sources, dev)
    k = sources.shape[0]
    dt = (plan.weights.dtype if plan.weights.dtype.is_floating_point
          else torch.float64)
    d0 = torch.full((k, n), float("inf"), dtype=dt, device=dev)
    d0[torch.arange(k, device=dev), sources.long()] = 0
    rounds = n if maxiter is None else int(maxiter)

    def step(d):
        return torch.minimum(d, relax_columns(plan, d, MIN_PLUS))

    dist = _fixpoint(step, d0, rounds, "graph.bellman_ford_plan")
    if maxiter is None:
        _negative_cycle_check(step, dist,
                              "graph.bellman_ford_plan.cycle_check")
    if not return_predecessors:
        return dist
    # argmin incoming edge per node, straight off the ELL layout
    rows = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    ok = (~plan.pad) & (plan.tails != rows)         # no pads, no self-loops
    wl = torch.where(ok, plan.weights.to(dt), torch.tensor(
        float("inf"), dtype=dt, device=dev))
    c = dist[:, plan.tails.reshape(-1).long()].view(k, n, plan.k) + wl
    m = c.amin(dim=-1)                                    # (k, n)
    best = (c == m[..., None]) & torch.isfinite(c)
    cand = torch.where(best, plan.tails,
                       torch.tensor(n, dtype=torch.int32, device=dev))
    pred = cand.amin(dim=-1)
    pred = torch.where(pred >= n, torch.tensor(
        NEG_SENTINEL, dtype=torch.int32, device=dev), pred)
    return dist, _set_sources(pred, sources)


def shortest_path(a: SparseCOO, *, method: str = "auto",
                  directed: bool = True, indices=None,
                  unweighted: bool = False,
                  return_predecessors: bool = False):
    """All-pairs / multi-source shortest paths
    (scipy.sparse.csgraph.shortest_path).

    ``method``: ``'BF'``/``'D'``/``'auto'`` run the batched Bellman-Ford
    relaxation (identical results to Dijkstra for non-negative weights);
    ``'FW'`` runs the dense Floyd-Warshall. With ``indices=None`` all
    ``n`` sources are solved in one batch.
    """
    n = int(a.shape[0])
    if method == "FW":
        if indices is not None:
            raise SpSparseError("method='FW' computes all pairs; "
                                "indices is not supported (scipy parity)")
        return floyd_warshall(a, directed=directed, unweighted=unweighted,
                              return_predecessors=return_predecessors)
    if method not in ("auto", "BF", "D"):
        raise SpSparseError(f"unknown shortest_path method {method!r}")
    sources = torch.arange(n, device=a.device) if indices is None else indices
    return bellman_ford(a, sources, directed=directed, unweighted=unweighted,
                        return_predecessors=return_predecessors)


def dijkstra(a: SparseCOO, *, directed: bool = True, indices=None,
             unweighted: bool = False, return_predecessors: bool = False,
             limit: float = np.inf, min_only: bool = False):
    """Shortest paths for non-negative weights
    (scipy.sparse.csgraph.dijkstra).

    There is no priority queue: the batched Bellman-Ford relaxation
    computes the same distances, and for negative inputs it returns
    *correct* shortest paths where scipy's heap-based dijkstra returns
    wrong ones (it only warns). The same ``UserWarning`` is emitted for
    scipy parity and the correct answer kept.

    ``limit``: distances strictly greater than ``limit`` are reported as
    ``inf`` (and their predecessors cleared) — scipy's bounded
    exploration, post hoc.

    ``min_only`` (requires ``indices``): collapse the source axis —
    returns ``(dist (n,), predecessors (n,), sources (n,))`` when
    ``return_predecessors`` else just ``dist``; ``sources[j]`` is the
    source achieving the min (ties to the first listed), ``-9999`` where
    unreachable.
    """
    n = int(a.shape[0])
    if not unweighted and a.nnz and bool((a.vals[: a.nnz] < 0).any()):
        warnings.warn("Graph has negative weights: results remain exact "
                      "here (relaxation engine), unlike scipy's dijkstra.",
                      UserWarning, stacklevel=2)
    if min_only and indices is None:
        raise SpSparseError("dijkstra: min_only requires indices")
    sources = (torch.arange(n, device=a.device) if indices is None
               else _node_ids(indices, a.device))
    out = bellman_ford(a, sources, directed=directed, unweighted=unweighted,
                       return_predecessors=return_predecessors)
    dist, pred = out if return_predecessors else (out, None)
    over = dist > torch.tensor(limit, dtype=dist.dtype, device=dist.device)
    dist = torch.where(over, torch.tensor(float("inf"), dtype=dist.dtype,
                                          device=dist.device), dist)
    neg = torch.tensor(NEG_SENTINEL, dtype=torch.int32, device=dist.device)
    if pred is not None:
        pred = torch.where(over, neg, pred)
    if min_only:
        kbest = torch.argmin(dist, dim=0)                 # (n,) first-min
        dmin = torch.gather(dist, 0, kbest[None, :])[0]
        src = torch.where(torch.isfinite(dmin),
                          sources[kbest].to(torch.int32), neg)
        if not return_predecessors:
            return dmin
        return dmin, torch.gather(pred, 0, kbest[None, :])[0], src
    if return_predecessors:
        return dist, pred
    return dist


def johnson(a: SparseCOO, *, directed: bool = True, indices=None,
            return_predecessors: bool = False):
    """All-pairs shortest paths with negative weights allowed
    (scipy.sparse.csgraph.johnson).

    The relaxation engine handles negative weights natively, so scipy's
    potential pass would be a no-op: this is the batched
    :func:`bellman_ford`, kept as its own entry point for API parity.
    Raises :class:`NegativeCycleError` when a negative cycle is reachable
    from a requested source."""
    n = int(a.shape[0])
    sources = (torch.arange(n, device=a.device) if indices is None
               else _node_ids(indices, a.device))
    return bellman_ford(a, sources, directed=directed,
                        return_predecessors=return_predecessors)


def floyd_warshall(a: SparseCOO, *, directed: bool = True,
                   unweighted: bool = False,
                   return_predecessors: bool = False):
    """Dense all-pairs shortest paths (scipy.sparse.csgraph.
    floyd_warshall): a loop over pivots, each a vectorized ``(n, n)``
    min-plus rank-1 update. O(n^3) work, O(n^2) memory — the right tool
    up to a few thousand nodes; beyond that use :func:`bellman_ford`."""
    t, h, w, live = edge_arrays(a, unweighted=unweighted)
    n = int(a.shape[0])
    dt = _float_dtype(a)
    inf = torch.tensor(float("inf"), dtype=dt, device=a.device)
    D = torch.full((n * n,), float("inf"), dtype=dt, device=a.device)
    D.scatter_reduce_(0, t.long() * n + h.long(),
                      torch.where(live, w.to(dt), inf), "amin")
    D = D.view(n, n)
    if not directed:
        D = torch.minimum(D, D.T)
    D = torch.where(torch.eye(n, dtype=torch.bool, device=a.device),
                    torch.zeros((), dtype=dt, device=a.device), D)
    for k in range(n):
        D = torch.minimum(D, D[:, k, None] + D[None, k, :])
    neg = bool((torch.diagonal(D) < 0).any())
    log_event("graph.floyd_warshall", rounds=n, syncs=1)
    if neg:
        raise NegativeCycleError("floyd_warshall: negative-weight cycle")
    if not return_predecessors:
        return D
    if not directed:
        # undirected: edges usable both ways in the tree reconstruction
        t, h = torch.cat([t, h]), torch.cat([h, t])
        w = torch.cat([w, w])
        live = torch.cat([live, live])
    pred = _predecessors(t, h, w, live, n, D)
    ar = torch.arange(n, device=a.device)
    pred[ar, ar] = NEG_SENTINEL
    return D, pred


# ----------------------------------------------------------------------
# BFS
# ----------------------------------------------------------------------

def bfs_levels(a: SparseCOO, source, *, directed: bool = True) -> Tensor:
    """Hop counts from ``source`` (``inf`` where unreachable) — the
    level-synchronous BFS, i.e. unweighted Bellman-Ford with ``maxiter =
    n``; ``(n,)`` on the operand's device."""
    return bellman_ford(a, source, directed=directed, unweighted=True,
                        maxiter=int(a.shape[0]))[0]


def _host_edges(a: SparseCOO):
    """The live ``(tails, heads, values)`` of ``a`` as host numpy (int64
    node ids): what the host-tier algorithms start from."""
    idx = a.indices[: a.nnz].cpu().numpy()
    vals = a.vals[: a.nnz].cpu()
    if vals.dtype == torch.bfloat16:
        vals = vals.float()
    return (idx[:, 0].astype(np.int64), idx[:, 1].astype(np.int64),
            vals.numpy())


def breadth_first_order(a: SparseCOO, i_start: int, *,
                        directed: bool = True,
                        return_predecessors: bool = True):
    """BFS visit order from ``i_start``
    (scipy.sparse.csgraph.breadth_first_order).

    Returns ``node_array`` (the reachable nodes in scipy's queue-BFS
    discovery order — neighbors explored in ascending node id, which
    matches scipy exactly for canonical sorted-indices CSR input) and,
    optionally, the ``(n,)`` predecessor array (``-9999`` at the source
    and unreachable nodes, parent = first discoverer). Host numpy
    (variable-length output), like ``rcm_permutation``. Device-side BFS
    levels live in :func:`bfs_levels`.
    """
    n = int(a.shape[0])
    ptr, h, _ = _host_adjacency(a, directed, scipy_order=True)
    seen = np.zeros(n, bool)
    pred = np.full(n, NEG_SENTINEL, np.int32)
    order = []
    q = deque([int(i_start)])
    seen[int(i_start)] = True
    while q:
        v = q.popleft()
        order.append(v)
        for u in h[ptr[v]:ptr[v + 1]]:
            if not seen[u]:
                seen[u] = True
                pred[u] = v
                q.append(int(u))
    node_array = np.asarray(order, np.int32)
    if not return_predecessors:
        return node_array
    return node_array, pred


def _host_adjacency(a: SparseCOO, directed: bool, *,
                    scipy_order: bool = False):
    """Host CSR view ``(ptr, heads, weights)`` — the adjacency layout every
    sequential host-tier traversal shares. Default: heads sorted ascending
    within each row (binary-searchable). With ``scipy_order=True`` and
    ``directed=False``, each row lists the node's out-neighbors (CSR
    order) before its in-neighbors (transpose order) — scipy's undirected
    traversal order; for directed graphs the two orders coincide on
    canonical input."""
    t, h, w = _host_edges(a)
    if directed:
        order = np.lexsort((h, t))
    else:
        m = t.size
        t, h = np.concatenate([t, h]), np.concatenate([h, t])
        w = np.concatenate([w, w])
        if scipy_order:
            flag = np.repeat(np.array([0, 1], np.int8), m)
            order = np.lexsort((h, flag, t))
        else:
            order = np.lexsort((h, t))
    n = int(a.shape[0])
    t, h, w = t[order], h[order], w[order]
    ptr = np.searchsorted(t, np.arange(n + 1))
    return ptr, h, w


def depth_first_order(a: SparseCOO, i_start: int, *,
                      directed: bool = True,
                      return_predecessors: bool = True):
    """DFS preorder from ``i_start``
    (scipy.sparse.csgraph.depth_first_order): neighbors explored in
    ascending node id, which reproduces scipy's order exactly for
    canonical (sorted-indices) CSR input. Host numpy, like
    :func:`breadth_first_order`."""
    n = int(a.shape[0])
    ptr, h, _ = _host_adjacency(a, directed, scipy_order=True)
    seen = np.zeros(n, bool)
    pred = np.full(n, NEG_SENTINEL, np.int32)
    order = []
    stack = [(int(i_start), NEG_SENTINEL)]
    while stack:
        v, p = stack.pop()
        if seen[v]:
            continue
        seen[v] = True
        if p != NEG_SENTINEL:
            pred[v] = p
        order.append(v)
        nbrs = h[ptr[v]:ptr[v + 1]]
        for u in nbrs[::-1]:
            if not seen[u]:
                stack.append((int(u), v))
    node_array = np.asarray(order, np.int32)
    if not return_predecessors:
        return node_array
    return node_array, pred


def _edge_weight(ptr, h, w, p, v):
    """The least stored weight of edge ``(p, v)`` in a host adjacency with
    sorted rows (``inf`` if there is none)."""
    lo, hi = ptr[p], ptr[p + 1]
    k = lo + np.searchsorted(h[lo:hi], v)
    best = np.inf
    while k < hi and h[k] == v:
        best = min(best, w[k])
        k += 1
    return best


def _tree_from_pred(a: SparseCOO, pred, *, directed: bool) -> SparseCOO:
    """Tree edges ``(pred[v], v)`` as a SparseCOO on ``a``'s device with
    the traversed edge's stored weight (scipy's *_tree output contract).
    Parallel edges take the minimum weight; with ``directed=False`` the
    minimum of the two stored orientations is used (scipy's
    ``reconstruct_path`` convention)."""
    n = int(a.shape[0])
    pred = np.asarray(pred)
    child = np.nonzero(pred != NEG_SENTINEL)[0]
    parent = pred[child]
    ptr, h, w = _host_adjacency(a, directed)
    vals = np.array([_edge_weight(ptr, h, w, p, v)
                     for p, v in zip(parent, child)])
    idx = np.stack([parent, child], axis=1).astype(np.int64)
    return SparseCOO.from_arrays(idx, vals, (n, n), device=a.device)


def breadth_first_tree(a: SparseCOO, i_start: int, *,
                       directed: bool = True) -> SparseCOO:
    """The BFS spanning tree rooted at ``i_start`` as a sparse matrix
    (scipy.sparse.csgraph.breadth_first_tree); matches scipy exactly for
    canonical CSR input (see :func:`breadth_first_order`)."""
    _, pred = breadth_first_order(a, i_start, directed=directed,
                                  return_predecessors=True)
    return _tree_from_pred(a, pred, directed=directed)


def depth_first_tree(a: SparseCOO, i_start: int, *,
                     directed: bool = True) -> SparseCOO:
    """The DFS spanning tree rooted at ``i_start``
    (scipy.sparse.csgraph.depth_first_tree); matches scipy exactly for
    canonical CSR input (see :func:`depth_first_order`)."""
    _, pred = depth_first_order(a, i_start, directed=directed,
                                return_predecessors=True)
    return _tree_from_pred(a, pred, directed=directed)


# ----------------------------------------------------------------------
# Connected components
# ----------------------------------------------------------------------

def _min_label_components(t, h, live, n):
    """Min-label propagation + pointer jumping: converged ``lab[i]`` is the
    smallest node id in i's component (int32). O(log n)-ish rounds, each a
    segmented min + two gathers."""
    lab = torch.arange(n, dtype=torch.int32, device=t.device)
    t, h = live_edges(live, t.long(), h.long())

    def step(lab):
        inc = segment_reduce(lab[t], h, n, "min")
        lab = torch.minimum(lab, inc)
        lab = torch.minimum(lab, lab[lab.long()])        # pointer jumping
        return torch.minimum(lab, lab[lab.long()])

    lab = step(lab)
    it, changed = 0, True
    while it < n and changed:
        nl = step(lab)
        changed = bool((nl != lab).any())
        lab, it = nl, it + 1
    log_event("graph.min_label_components", rounds=it + 1, syncs=it)
    return lab


def _host_tarjan(t, h, n):
    """Iterative Tarjan SCC on the host (numpy) — sequential by nature.
    Returns labels relabeled in order of first node occurrence."""
    order = np.lexsort((h, t))
    t, h = t[order], h[order]
    ptr = np.searchsorted(t, np.arange(n + 1))
    index = np.full(n, -1, np.int64)
    low = np.zeros(n, np.int64)
    on_stack = np.zeros(n, bool)
    stack: list[int] = []
    labels = np.full(n, -1, np.int64)
    counter = 0
    n_comp = 0
    for root in range(n):
        if index[root] != -1:
            continue
        # (node, next-edge-offset) explicit DFS stack
        work = [(root, ptr[root])]
        index[root] = low[root] = counter
        counter += 1
        stack.append(root)
        on_stack[root] = True
        while work:
            v, ei = work[-1]
            if ei < ptr[v + 1]:
                work[-1] = (v, ei + 1)
                u = h[ei]
                if index[u] == -1:
                    index[u] = low[u] = counter
                    counter += 1
                    stack.append(u)
                    on_stack[u] = True
                    work.append((u, ptr[u]))
                elif on_stack[u]:
                    low[v] = min(low[v], index[u])
            else:
                work.pop()
                if work:
                    pv = work[-1][0]
                    low[pv] = min(low[pv], low[v])
                if low[v] == index[v]:
                    while True:
                        u = stack.pop()
                        on_stack[u] = False
                        labels[u] = n_comp
                        if u == v:
                            break
                    n_comp += 1
    # relabel by first occurrence (scipy-friendly canonical order)
    remap = np.full(n_comp, -1, np.int64)
    nxt = 0
    for lbl in labels:
        if remap[lbl] == -1:
            remap[lbl] = nxt
            nxt += 1
    return n_comp, remap[labels]


def connected_components(a: SparseCOO, *, directed: bool = True,
                         connection: str = "weak",
                         return_labels: bool = True):
    """Connected components (scipy.sparse.csgraph.connected_components).

    Weak (or undirected) components run on the device: min-label
    propagation with pointer jumping — labels are numbered in order of
    first node occurrence, matching scipy. Strong components of a
    directed graph are sequential (Tarjan) and run on the host. Returns
    ``(n_components, labels)`` (labels int32 on the operand's device) or
    just the count.
    """
    n = int(a.shape[0])
    if directed and connection == "strong":
        _check_square(a)
        tn, hn, _ = _host_edges(a)
        n_comp, labels = _host_tarjan(tn, hn, n)
        if not return_labels:
            return n_comp
        return n_comp, torch.from_numpy(labels.astype(np.int32)).to(a.device)
    if connection not in ("weak", "strong"):
        raise SpSparseError(f"unknown connection {connection!r}")
    t, h, _, live = edge_arrays(a, directed=False)
    lab = _min_label_components(t, h, live, n)
    is_root = lab == torch.arange(n, dtype=torch.int32, device=a.device)
    n_comp = int(is_root.sum())
    labels = (torch.cumsum(is_root, 0) - 1).to(torch.int32)[lab.long()]
    return (n_comp, labels) if return_labels else n_comp


# ----------------------------------------------------------------------
# Minimum spanning tree (Boruvka)
# ----------------------------------------------------------------------

def minimum_spanning_tree(a: SparseCOO) -> SparseCOO:
    """Minimum spanning forest
    (scipy.sparse.csgraph.minimum_spanning_tree), via Boruvka rounds on
    the device: every round, each component picks its lightest outgoing
    edge (one segmented min over the edge list) and the chosen edges merge
    components; O(log n) rounds. Ties break on (weight, edge id), which
    makes the chosen set cycle-free.

    The input is treated as undirected (either orientation of a stored
    entry defines the edge, as in scipy); the result keeps one entry per
    tree edge in ``(min(i,j), max(i,j))`` orientation, row-major sorted.
    """
    if a.rank != 2 or a.shape[0] != a.shape[1]:
        raise SpSparseError(
            f"minimum_spanning_tree needs a square rank-2 array, "
            f"got {a.shape}")
    n = int(a.shape[0])
    dev = a.device
    live0 = a.valid_mask()
    izero = torch.zeros((), dtype=torch.int32, device=dev)
    i = torch.where(live0, a.indices[:, 0].to(torch.int32), izero)
    j = torch.where(live0, a.indices[:, 1].to(torch.int32), izero)
    u = torch.minimum(i, j)
    v = torch.maximum(i, j)
    live = live0 & (u != v)                    # self-loops never in a tree
    E = int(u.shape[0])
    # the live edges; their slot ids break weight ties
    eid, ul, vl, w = live_edges(
        live, torch.arange(E, dtype=torch.int32, device=dev), u.long(),
        v.long(), a.vals.to(_float_dtype(a)))
    both_t, both_h = torch.cat([ul, vl]), torch.cat([vl, ul])
    none = torch.tensor(E, dtype=torch.int32, device=dev)
    comp = torch.arange(n, dtype=torch.int32, device=dev)
    in_forest = torch.zeros(eid.shape[0], dtype=torch.bool, device=dev)
    rounds = 0
    while True:
        rounds += 1
        cu, cv = comp[ul], comp[vl]
        cross = cu != cv
        # only edges between components are reduced: an edge inside one
        # adds nothing, and all of them would meet on its component's slot
        xe, xu, xv, xw = live_edges(cross, eid, cu, cv, w)
        # each endpoint's component sees the edge
        seg = torch.cat([xu, xv]).long()
        ww = torch.cat([xw, xw])
        m = segment_reduce(ww, seg, n, "min")
        cand = torch.isfinite(ww) & (ww == m[seg])
        ce = segment_reduce(torch.where(cand, torch.cat([xe, xe]), none),
                            seg, n, "min")
        # a component with no candidate keeps the int32-max identity or E:
        # both land in the dropped slot E
        chosen = torch.zeros(E + 1, dtype=torch.bool, device=dev)
        chosen[torch.clamp(ce, max=E).long()] = True
        chosen = chosen[eid.long()] & cross
        if not bool(chosen.any()):
            break
        in_forest = in_forest | chosen
        comp = _min_label_components(both_t, both_h,
                                     torch.cat([in_forest, in_forest]), n)
    forest = torch.zeros(E, dtype=torch.bool, device=dev)
    forest[eid.long()] = in_forest
    log_event("graph.boruvka", rounds=rounds, syncs=rounds)

    sent = torch.tensor(n, dtype=torch.int32, device=dev)
    und = SparseCOO(indices=torch.stack(
        [torch.where(live0, u, sent), torch.where(live0, v, sent)],
        dim=1).to(a.index_dtype), vals=a.vals, nnz=a.nnz, shape=a.shape)
    tree = filter_compact(und, forest)
    return tree.consolidate((0, 1))


# ----------------------------------------------------------------------
# Bipartite matching
# ----------------------------------------------------------------------

def maximum_bipartite_matching(a: SparseCOO, *,
                               perm_type: str = "row") -> np.ndarray:
    """Maximum-cardinality matching of the bipartite graph whose
    biadjacency matrix is ``a`` (scipy.sparse.csgraph.
    maximum_bipartite_matching): Hopcroft-Karp on the host — augmenting
    paths are sequential pointer chases. ``perm_type='row'`` returns, per
    row, the matched column (``-1`` if unmatched); ``'column'`` the
    reverse. Entry *values* are ignored (explicit zeros are edges, as
    stored). The augmenting search recurses once per path step, with the
    recursion limit raised to ``rows + columns + 100``."""
    if a.rank != 2:
        raise SpSparseError("maximum_bipartite_matching needs rank 2")
    if perm_type not in ("row", "column"):
        raise SpSparseError(f"perm_type must be 'row' or 'column', "
                            f"got {perm_type!r}")
    nr, nc = int(a.shape[0]), int(a.shape[1])
    r, c, _ = _host_edges(a)
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    ptr = np.searchsorted(r, np.arange(nr + 1))

    INF = np.iinfo(np.int64).max
    match_r = np.full(nr, -1, np.int64)        # row -> col
    match_c = np.full(nc, -1, np.int64)        # col -> row
    dist = np.empty(nr, np.int64)

    def bfs() -> bool:
        q = []
        for u in range(nr):
            if match_r[u] == -1:
                dist[u] = 0
                q.append(u)
            else:
                dist[u] = INF
        found = False
        head = 0
        while head < len(q):
            u = q[head]
            head += 1
            for v in c[ptr[u]:ptr[u + 1]]:
                w = match_c[v]
                if w == -1:
                    found = True
                elif dist[w] == INF:
                    dist[w] = dist[u] + 1
                    q.append(w)
        return found

    def dfs(u: int) -> bool:
        for v in c[ptr[u]:ptr[u + 1]]:
            w = match_c[v]
            if w == -1 or (dist[w] == dist[u] + 1 and dfs(w)):
                match_r[u] = v
                match_c[v] = u
                return True
        dist[u] = INF
        return False

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, nr + nc + 100))
    try:
        while bfs():
            for u in range(nr):
                if match_r[u] == -1:
                    dfs(u)
    finally:
        sys.setrecursionlimit(old_limit)
    return match_r if perm_type == "row" else match_c


def min_weight_full_bipartite_matching(a: SparseCOO, *,
                                       maximize: bool = False):
    """Minimum-weight full matching of the bipartite graph whose
    biadjacency matrix is ``a``
    (scipy.sparse.csgraph.min_weight_full_bipartite_matching).

    Only explicitly stored entries are admissible edges (stored zeros ARE
    zero-weight edges). Every vertex on the smaller side must be matched;
    raises :class:`SpSparseError` when no full matching exists (scipy
    raises ValueError).

    Hungarian algorithm with dual potentials, successive shortest
    augmenting paths over the sparse adjacency, on the host; O(R·C·rounds)
    worst case. Returns ``(row_ind, col_ind)`` numpy, sorted by row index.
    Parallel duplicate edges take the minimum weight (maximum under
    ``maximize``)."""
    if a.rank != 2:
        raise SpSparseError("min_weight_full_bipartite_matching needs "
                            "rank 2")
    nr, nc = int(a.shape[0]), int(a.shape[1])
    r, c, w = _host_edges(a)
    w = w.astype(np.float64)
    transposed = nr > nc
    if transposed:
        r, c, nr, nc = c, r, nc, nr
    if maximize:
        w = -w
    # columns shifted +1: column 0 is the virtual root of the
    # alternating tree (classic potentials formulation)
    order = np.lexsort((c, r))
    r, c, w = r[order], c[order] + 1, w[order]
    ptr = np.searchsorted(r, np.arange(nr + 1))
    if nr and (ptr[1:] == ptr[:-1]).any():
        raise SpSparseError("min_weight_full_bipartite_matching: a row "
                            "has no admissible edges — no full matching "
                            "exists")
    INF = np.inf
    u = np.zeros(nr + 1)              # row potentials (u[nr] = virtual)
    v = np.zeros(nc + 1)              # column potentials
    p = np.full(nc + 1, nr, np.int64)  # p[j] = row matched to column j
    way = np.zeros(nc + 1, np.int64)
    for i in range(nr):
        p[0] = i
        j0 = 0
        minv = np.full(nc + 1, INF)
        used = np.zeros(nc + 1, bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            # relax only over the sparse adjacency of i0
            lo, hi = ptr[i0], ptr[i0 + 1]
            js, ws = c[lo:hi], w[lo:hi]
            cur = ws - u[i0] - v[js]
            upd = (~used[js]) & (cur < minv[js])
            minv[js] = np.where(upd, cur, minv[js])
            way[js[upd]] = j0
            minv_masked = np.where(used, INF, minv)
            j1 = int(np.argmin(minv_masked))
            delta = minv_masked[j1]
            if not np.isfinite(delta):
                raise SpSparseError(
                    "min_weight_full_bipartite_matching: no full "
                    "matching exists")
            u[p[used]] += delta
            v[used] -= delta
            minv[~used] -= delta
            j0 = j1
            if p[j0] == nr:
                break
        while j0:                      # augment along the stored path
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    col_of_row = np.full(nr, -1, np.int64)
    for j in range(1, nc + 1):
        if p[j] != nr:
            col_of_row[p[j]] = j - 1
    row_ind = np.arange(nr, dtype=np.int64)
    col_ind = col_of_row
    if transposed:
        row_ind, col_ind = col_ind.copy(), row_ind
        srt = np.argsort(row_ind)
        row_ind, col_ind = row_ind[srt], col_ind[srt]
    return row_ind, col_ind


def structural_rank(a: SparseCOO) -> int:
    """Structural rank = maximum-bipartite-matching cardinality of the
    sparsity pattern (scipy.sparse.csgraph.structural_rank) — an upper
    bound on the numerical rank that depends only on structure."""
    m = maximum_bipartite_matching(a)
    return int((m >= 0).sum())


# ----------------------------------------------------------------------
# Maximum flow (host Dinic)
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MaximumFlowResult:
    """Result of :func:`maximum_flow` — scipy's shape: the flow value and
    the per-edge flow as a :class:`SparseCOO` over the *stored* edges, on
    the operand's device."""

    flow_value: int
    flow: SparseCOO


def maximum_flow(a: SparseCOO, source: int, sink: int) -> MaximumFlowResult:
    """Maximum s-t flow with integer capacities
    (scipy.sparse.csgraph.maximum_flow), via Dinic's algorithm on the
    host — level-graph BFS + blocking-flow DFS are sequential pointer
    chases. Capacities must be non-negative integers (scipy's
    restriction); raises otherwise."""
    if a.rank != 2 or a.shape[0] != a.shape[1]:
        raise SpSparseError(f"maximum_flow needs a square rank-2 array, "
                            f"got {a.shape}")
    n = int(a.shape[0])
    if not (0 <= source < n and 0 <= sink < n and source != sink):
        raise SpSparseError("maximum_flow: bad source/sink")
    t, h, w = _host_edges(a)
    if not np.all(w == np.round(w)) or np.any(w < 0):
        raise SpSparseError(
            "maximum_flow needs non-negative integer capacities "
            "(scipy parity)")
    cap0 = w.astype(np.int64)
    t0, h0 = t, h                       # stored edge list incl. self-loops
    keep = t != h
    t, h, cap0 = t[keep], h[keep], cap0[keep]
    m = len(t)
    # residual edge list: forward edges at 2i, reverse at 2i+1
    eh = np.empty(2 * m, np.int64)
    eh[0::2], eh[1::2] = h, t
    cap = np.zeros(2 * m, np.int64)
    cap[0::2] = cap0
    # CSR over residual edges by tail
    et = np.empty(2 * m, np.int64)
    et[0::2], et[1::2] = t, h
    order = np.argsort(et, kind="stable")
    ptr = np.searchsorted(et[order], np.arange(n + 1))
    adj = order  # adj[ptr[u]:ptr[u+1]] = residual edge ids out of u

    def bfs_levels_():
        level = np.full(n, -1, np.int64)
        level[source] = 0
        q = [source]
        head = 0
        while head < len(q):
            u = q[head]
            head += 1
            for eid in adj[ptr[u]:ptr[u + 1]]:
                v = eh[eid]
                if cap[eid] > 0 and level[v] == -1:
                    level[v] = level[u] + 1
                    q.append(v)
        return level if level[sink] != -1 else None

    total = 0
    while True:
        level = bfs_levels_()
        if level is None:
            break
        it = ptr[:-1].copy()      # per-node next-edge cursor

        # blocking flow via iterative DFS
        while True:
            # find one augmenting path
            path = []
            u = source
            while u != sink:
                advanced = False
                while it[u] < ptr[u + 1]:
                    eid = adj[it[u]]
                    v = eh[eid]
                    if cap[eid] > 0 and level[v] == level[u] + 1:
                        path.append(eid)
                        u = v
                        advanced = True
                        break
                    it[u] += 1
                if not advanced:
                    if not path:
                        u = None
                        break
                    # retreat: dead-end node; pop and advance parent
                    # cursor (eh[eid ^ 1] = the forward edge's tail)
                    level[u] = -1
                    eid = path.pop()
                    u = eh[eid ^ 1]
                    it[u] += 1
            if u is None:
                break
            aug = min(int(cap[e]) for e in path)
            for e in path:
                cap[e] -= aug
                cap[e ^ 1] += aug
            total += aug

    # per-stored-edge flow = reverse residual (what was pushed through).
    # Self-loops carry no s-t flow but ARE stored edges: re-insert them
    # with flow 0 so the output sparsity equals the input's stored edges.
    flow_all = np.zeros(len(t0), np.int64)
    flow_all[keep] = cap[1::2]
    idx = np.stack([t0, h0], axis=1)
    if len(t0):
        flow = SparseCOO.from_arrays(
            idx, flow_all.astype(numpy_dtype(a.dtype)), a.shape,
            device=a.device)
    else:
        flow = SparseCOO.empty(a.shape, cap=1, dtype=a.dtype,
                               device=a.device)
    return MaximumFlowResult(flow_value=int(total), flow=flow)


# ----------------------------------------------------------------------
# Laplacian
# ----------------------------------------------------------------------

def laplacian(a: SparseCOO, *, normed: bool = False,
              return_diag: bool = False):
    """Graph Laplacian of a symmetric adjacency matrix
    (scipy.sparse.csgraph.laplacian): ``L = D - A`` with
    ``D = diag(offdiag-row-sums)`` (the input diagonal is ignored, as in
    scipy). With ``normed=True``: ``L = I - D^-1/2 A D^-1/2`` with unit
    diagonal only at non-isolated nodes. Returns a consolidated
    row-major :class:`SparseCOO` on the operand's device (and the degree
    or sqrt-degree vector with ``return_diag``)."""
    if a.rank != 2 or a.shape[0] != a.shape[1]:
        raise SpSparseError(f"laplacian needs a square rank-2 array, "
                            f"got {a.shape}")
    n = int(a.shape[0])
    off = coo_filter(a, lambda idx, _v: idx[:, 0] != idx[:, 1])
    lv = off.valid_mask()
    zero = torch.zeros((), dtype=off.dtype, device=off.device)
    # padding rows land in the extra slot n, which is cut off
    rid = torch.where(lv, off.indices[:, 0].long(),
                      torch.tensor(n, device=off.device))
    deg = torch.zeros(n + 1, dtype=off.dtype, device=off.device).index_add_(
        0, rid, torch.where(lv, off.vals, zero))[:n]
    if not normed:
        D = _dense_diag_coo(deg, a)
        L = coo_add(D, coo_scale(off, -1.0))
        return (L, deg) if return_diag else L
    pos = deg > 0
    s = torch.sqrt(torch.where(pos, deg, torch.ones_like(deg))).to(off.dtype)
    inv = torch.where(pos, 1 / s, torch.zeros_like(s))
    ri = torch.where(lv, off.indices[:, 0].long(), 0)
    ci = torch.where(lv, off.indices[:, 1].long(), 0)
    scaled = dataclasses.replace(off, vals=off.vals * inv[ri] * inv[ci])
    D = _dense_diag_coo(pos.to(off.dtype), a)
    L = coo_add(D, coo_scale(scaled, -1.0))
    return (L, s) if return_diag else L


def _dense_diag_coo(d: Tensor, like: SparseCOO) -> SparseCOO:
    """diag(d) as a SparseCOO with every diagonal slot present (zero
    diagonal entries are kept; consolidate drops them downstream)."""
    n = int(d.shape[0])
    r = torch.arange(n, dtype=like.index_dtype, device=d.device)
    return SparseCOO(indices=torch.stack([r, r], dim=1),
                     vals=d.to(like.dtype), nnz=n, shape=like.shape,
                     sort_order=(0, 1))


# ----------------------------------------------------------------------
# Path utilities (scipy.sparse.csgraph._tools) + Yen's k-shortest paths
# ----------------------------------------------------------------------

def _host_array(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)


def reconstruct_path(a: SparseCOO, predecessors, *,
                     directed: bool = True) -> SparseCOO:
    """The shortest-path tree encoded by one predecessor row as a sparse
    matrix (scipy.sparse.csgraph.reconstruct_path): entry ``(pred[v],
    v)`` carries the stored edge weight (min of the two orientations when
    ``directed=False``, scipy's convention)."""
    predecessors = _host_array(predecessors)
    if predecessors.shape != (int(a.shape[0]),):
        raise SpSparseError(
            f"reconstruct_path: predecessors must be ({int(a.shape[0])},), "
            f"got {predecessors.shape}")
    return _tree_from_pred(a, predecessors, directed=directed)


def construct_dist_matrix(a: SparseCOO, predecessors, *,
                          directed: bool = True,
                          null_value: float = np.inf):
    """Distance matrix from a full ``(n, n)`` predecessor matrix
    (scipy.sparse.csgraph.construct_dist_matrix): walks each row's
    predecessor chains and sums the stored edge weights; unreachable
    entries get ``null_value``. Host numpy ``(n, n)``."""
    n = int(a.shape[0])
    pred = _host_array(predecessors)
    if pred.shape != (n, n):
        raise SpSparseError(f"construct_dist_matrix: predecessors must be "
                            f"({n}, {n}), got {pred.shape}")
    ptr, h, w = _host_adjacency(a, directed)
    dist = np.full((n, n), np.inf)
    for i in range(n):
        dist[i, i] = 0.0
        # resolve chains iteratively: a node is ready once its
        # predecessor's distance is known
        state = np.zeros(n, np.int8)            # 0 unseen, 1 done
        state[i] = 1
        for j in range(n):
            chain = []
            v = j
            while state[v] == 0 and pred[i, v] != NEG_SENTINEL:
                chain.append(v)
                v = pred[i, v]
                if len(chain) > n:
                    # malformed predecessor matrix (cycle) — raise
                    # instead of walking forever
                    raise SpSparseError(
                        "construct_dist_matrix: cycle detected in "
                        f"predecessor matrix (source row {i})")
            if state[v] == 1:
                for u in reversed(chain):
                    dist[i, u] = dist[i, pred[i, u]] + _edge_weight(
                        ptr, h, w, pred[i, u], u)
                    state[u] = 1
    dist[~np.isfinite(dist)] = null_value
    np.fill_diagonal(dist, 0.0)
    return dist


def _host_dijkstra_masked(ptr, h, w, n, source, sink, blocked_nodes,
                          blocked_edges, undirected):
    """Heap Dijkstra from ``source`` to ``sink`` over the host adjacency,
    skipping ``blocked_nodes`` (bool mask) and ``blocked_edges`` (set of
    (u, v) keys, canonicalized when undirected). Returns (cost, path) or
    (inf, None). Host tier — the sequential spur searches of Yen's
    algorithm."""
    dist = np.full(n, np.inf)
    prev = np.full(n, NEG_SENTINEL, np.int64)
    dist[source] = 0.0
    heap = [(0.0, source)]
    while heap:
        d, v = heapq.heappop(heap)
        if d > dist[v]:
            continue
        if v == sink:
            break
        for k in range(ptr[v], ptr[v + 1]):
            u = int(h[k])
            if blocked_nodes[u]:
                continue
            key = (min(v, u), max(v, u)) if undirected else (v, int(u))
            if key in blocked_edges:
                continue
            nd = d + w[k]
            if nd < dist[u]:
                dist[u] = nd
                prev[u] = v
                heapq.heappush(heap, (nd, u))
    if not np.isfinite(dist[sink]):
        return np.inf, None
    path = [sink]
    while path[-1] != source:
        path.append(int(prev[path[-1]]))
    return float(dist[sink]), path[::-1]


def yen(a: SparseCOO, source: int, sink: int, K: int, *,
        directed: bool = True, unweighted: bool = False,
        return_predecessors: bool = False):
    """Yen's K loopless shortest paths (scipy.sparse.csgraph.yen): returns
    the (at most K) smallest simple-path costs sorted ascending, and
    optionally a ``(k, n)`` predecessor matrix, one row per path. Host
    tier: the spur-node searches are sequential."""
    n = int(a.shape[0])
    source, sink = int(source), int(sink)
    ptr, h, w = _host_adjacency(a, directed)
    if unweighted:
        w = np.ones_like(w)
    undirected = not directed
    no_nodes = np.zeros(n, bool)

    c0, p0 = _host_dijkstra_masked(ptr, h, w, n, source, sink,
                                   no_nodes, frozenset(), undirected)
    found: list = [] if p0 is None else [(c0, p0)]
    candidates: list = []
    seen = {tuple(p0)} if p0 is not None else set()

    while found and len(found) < K:
        _, prev_path = found[-1]
        for i in range(len(prev_path) - 1):
            spur = prev_path[i]
            root = prev_path[:i + 1]
            root_cost = 0.0
            for u, v in zip(root, root[1:]):
                root_cost += _edge_weight(ptr, h, w, u, v)
            blocked_edges = set()
            for _c, p in found + candidates:
                if len(p) > i and p[:i + 1] == root:
                    u, v = p[i], p[i + 1]
                    blocked_edges.add(
                        (min(u, v), max(u, v)) if undirected else (u, v))
            blocked_nodes = no_nodes.copy()
            blocked_nodes[root[:-1]] = True
            sc, sp = _host_dijkstra_masked(ptr, h, w, n, spur, sink,
                                           blocked_nodes,
                                           frozenset(blocked_edges),
                                           undirected)
            if sp is not None:
                cand = root[:-1] + sp
                key = tuple(cand)
                if key not in seen:
                    seen.add(key)
                    candidates.append((root_cost + sc, cand))
        if not candidates:
            break
        candidates.sort(key=lambda cp: cp[0])
        found.append(candidates.pop(0))

    dists = np.array([c for c, _ in found])
    if not return_predecessors:
        return dists
    preds = np.full((len(found), n), NEG_SENTINEL, np.int32)
    for r, (_, p) in enumerate(found):
        for u, v in zip(p, p[1:]):
            preds[r, v] = u
    return dists, preds


# ----------------------------------------------------------------------
# Graph <-> dense/masked conversions (scipy.sparse.csgraph._tools)
# ----------------------------------------------------------------------

def csgraph_from_dense(dense, *, null_value: float = 0.0,
                       device=None) -> SparseCOO:
    """Dense adjacency -> :class:`SparseCOO` graph on ``device`` (the card
    by default) (scipy.sparse.csgraph.csgraph_from_dense): entries equal
    to ``null_value``, ``inf`` or ``nan`` are non-edges; everything else —
    including explicit zeros when ``null_value != 0`` — is a stored
    edge."""
    dense = np.asarray(_host_array(dense), np.float64)
    if dense.ndim != 2:
        raise SpSparseError(f"csgraph_from_dense needs a 2-D array, "
                            f"got {dense.shape}")
    if np.isnan(null_value):
        edge = ~np.isnan(dense)
    else:
        edge = dense != null_value
    edge &= np.isfinite(dense)
    r, c = np.nonzero(edge)
    idx = np.stack([r, c], axis=1).astype(np.int64)
    return SparseCOO.from_arrays(idx, dense[r, c], dense.shape,
                                 device=device)


def csgraph_to_dense(a: SparseCOO, *, null_value: float = 0.0):
    """Graph -> dense adjacency with ``null_value`` at non-edges
    (scipy.sparse.csgraph.csgraph_to_dense): stored entries keep their
    value (explicit zeros stay ``0``, distinct from ``null_value``). Host
    numpy array."""
    r, c, v = _host_edges(a)
    out = np.full(tuple(int(s) for s in a.shape), float(null_value))
    # scipy keeps the minimum on duplicate entries
    order = np.lexsort((-v, c, r))
    out[r[order], c[order]] = v[order]
    return out


def csgraph_from_masked(masked, *, device=None) -> SparseCOO:
    """Masked-array adjacency -> graph on ``device`` (the card by default)
    (scipy.sparse.csgraph.csgraph_from_masked): masked entries are
    non-edges, every unmasked entry (incl. zeros) is stored."""
    masked = np.ma.asarray(masked)
    edge = ~np.ma.getmaskarray(masked)
    r, c = np.nonzero(edge)
    idx = np.stack([r, c], axis=1).astype(np.int64)
    return SparseCOO.from_arrays(
        idx, np.asarray(masked.data, np.float64)[r, c], masked.shape,
        device=device)


def csgraph_to_masked(a: SparseCOO):
    """Graph -> masked-array adjacency (non-edges masked)
    (scipy.sparse.csgraph.csgraph_to_masked)."""
    dense = csgraph_to_dense(a, null_value=np.inf)
    return np.ma.masked_invalid(dense)

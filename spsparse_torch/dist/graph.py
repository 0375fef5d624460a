"""Distributed graph relaxations over the row-partitioned layout.

Counterpart of :mod:`spsparse_tpu.dist.graph`: the single-device graph
tier's relaxations (:mod:`spsparse_torch.graph`) over a
:class:`~.partition.RowPartitionedCSR` on a mesh.

* **Bellman-Ford / BFS** — distances are split like the rows. Each round
  every partition relaxes its local edges (tails are local rows, so the
  distance gather is local) into per-head candidate minima for the whole
  graph; the min-combine across partitions is a reduce-scatter-min built
  from one ``all_to_all`` and a local min.
* **Connected components** — labels are replicated: every edge reads
  labels at both ends each round, so each partition reduces its edges in
  both orientations into a whole label vector and one ``pmin`` combines
  them, then pointer jumping runs on the replicated labels.

The JAX package runs each fixpoint in ``lax.while_loop`` with a reduced
"changed" flag; here each is a Python loop with one host sync a round:
the ``pmax`` of the flag, read by ``.item()`` (every rank leaves on the
same round). Rounds and syncs go to the host event log
(:func:`spsparse_torch.utils.trace.log_event`) as ``graph.dist_*``.
Only live edges are reduced (padding slots all name node 0, whose
atomics would serialize on a card).
"""

from __future__ import annotations

import torch

from ..graph.csgraph import _sources
from ..utils.trace import log_event
from .mesh import check_mesh
from .ops import csr_entries
from .partition import RowPartitionedCSR

__all__ = ["dist_bellman_ford", "dist_bfs_levels",
           "dist_connected_components"]

Tensor = torch.Tensor


def _edges(mesh, part: RowPartitionedCSR):
    """The owned blocks' live edges, flattened: ``(block, local tail,
    global head, weight)``, each ``(E,)``."""
    rows, cols, vals, live = csr_entries(mesh.shard_layout(part))
    n = rows.shape[0]
    blk = torch.arange(n, device=rows.device)[:, None].expand_as(rows)
    keep = torch.nonzero(live.reshape(-1)).squeeze(1)
    return tuple(t.reshape(-1)[keep] for t in (blk, rows, cols, vals))


def _fixpoint(mesh, step, d: Tensor, maxiter: int, what: str) -> Tensor:
    """``d = step(d)`` once, then while ``it < maxiter`` and the last step
    changed some entry on any partition (``step`` returns ``(new,
    changed (n_own,))``)."""
    d, _ = step(d)
    it, changed = 0, True
    while it < maxiter and changed:
        d, ch = step(d)
        changed = bool(mesh.pmax(ch.to(torch.int32)).item())
        it += 1
    log_event(what, rounds=it + 1, syncs=it)
    return d


def dist_bellman_ford(part: RowPartitionedCSR, sources, mesh,
                      axis: str = "x", *, unweighted: bool = False,
                      maxiter: int | None = None) -> Tensor:
    """Multi-source shortest paths on a row-partitioned graph.

    ``sources`` holds ``k`` global node ids. Returns the owned distance
    blocks ``(n, rows_local, k)`` (global view: ``mesh.gather(out)
    .reshape(-1, k)[:nodes]``; rows past the node count are padding);
    ``inf`` marks unreachable nodes. Negative weights are relaxed up to
    ``maxiter`` rounds (default: the node count); detecting a negative
    cycle is the caller's business, as in the JAX package."""
    check_mesh(mesh, part.n_parts, axis, "dist_bellman_ford")
    P, L = mesh.n_parts, part.rows_local
    rounds = int(part.shape[0]) if maxiter is None else int(maxiter)
    dt = part.vals.dtype if part.vals.dtype.is_floating_point \
        else torch.float32
    blk, tails, heads, w = _edges(mesh, part)
    dev = tails.device
    srcs = _sources(sources, dev).long()
    k = srcs.numel()
    n = len(mesh.owned)
    w = (torch.ones_like(w) if unweighted else w).to(dt)
    tail_at = blk * L + tails                # into (k, n * L)
    head_at = blk * (P * L) + heads          # into (k, n * P * L)
    gid = (mesh.axis_index()[:, None] * L
           + torch.arange(L, device=dev)[None, :]).reshape(-1)
    d0 = torch.where(srcs[:, None] == gid[None, :], 0.0,
                     float("inf")).to(dt)    # (k, n * L)

    def step(d):
        c = d[:, tail_at] + w
        y = torch.full((k, n * P * L), float("inf"), dtype=dt, device=dev)
        y.scatter_reduce_(1, head_at.expand(k, -1), c, "amin",
                          include_self=True)
        # reduce-scatter-min: partition p keeps block p of every
        # partition's candidates (all_to_all), then a local min.
        yb = y.reshape(k, n, P, L).permute(1, 2, 0, 3)       # (n, P, k, L)
        mine = mesh.all_to_all(yb.contiguous()).amin(dim=1)  # (n, k, L)
        nd = torch.minimum(d, mine.permute(1, 0, 2).reshape(k, n * L))
        return nd, (nd < d).reshape(k, n, L).any(dim=2).any(dim=0)

    d = _fixpoint(mesh, step, d0, rounds, "graph.dist_bellman_ford")
    return d.reshape(k, n, L).permute(1, 2, 0).contiguous()


def dist_bfs_levels(part: RowPartitionedCSR, sources, mesh,
                    axis: str = "x") -> Tensor:
    """Hop counts from ``sources``: the unweighted
    :func:`dist_bellman_ford` (rounds = eccentricity)."""
    return dist_bellman_ford(part, sources, mesh, axis, unweighted=True)


def dist_connected_components(part: RowPartitionedCSR, mesh,
                              axis: str = "x") -> Tensor:
    """Weak connected-component labels of a row-partitioned graph.

    Returns the replicated ``(n_padded,)`` int32 labels, numbered in order
    of first node occurrence as :func:`spsparse_torch.graph.
    connected_components` numbers them; the padding rows past the node
    count are isolated and take the trailing labels. Min-label
    propagation with pointer jumping: each round a partition relaxes its
    edges in both orientations and one ``pmin`` combines them."""
    check_mesh(mesh, part.n_parts, axis, "dist_connected_components")
    P, L = mesh.n_parts, part.rows_local
    n_pad = P * L
    blk, rows, heads, _ = _edges(mesh, part)
    dev = rows.device
    n = len(mesh.owned)
    tails = mesh.axis_index()[blk] * L + rows
    seg = torch.cat([heads, tails]) + torch.cat([blk, blk]) * n_pad
    src = torch.cat([tails, heads])

    def step(lab):
        inc = torch.full((n * n_pad,), n_pad, dtype=torch.int32, device=dev)
        inc.scatter_reduce_(0, seg, lab[src], "amin", include_self=True)
        inc = mesh.pmin(inc.reshape(n, n_pad))
        nl = torch.minimum(lab, inc)
        nl = torch.minimum(nl, nl[nl.long()])           # pointer jumping
        nl = torch.minimum(nl, nl[nl.long()])
        return nl, (nl != lab).any().reshape(1).expand(n)

    lab0 = torch.arange(n_pad, dtype=torch.int32, device=dev)
    lab = _fixpoint(mesh, step, lab0, n_pad,
                    "graph.dist_connected_components")
    # first-occurrence renumbering (the graph tier's convention)
    is_root = lab == lab0
    return (torch.cumsum(is_root, 0) - 1).to(torch.int32)[lab.long()]

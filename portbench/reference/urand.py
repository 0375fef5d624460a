"""Plain reference of the GAP cells: the graph from the generated arcs
(duplicates removed by ``torch.unique`` over ``row * n + col``), GAP's
PageRank and Bellman-Ford shortest paths, in the dtype asked for.

Numbers compared (the largest over the sampled jobs):

* PageRank, ``score_l1``: ``sum |s - s_ref|`` (the scores sum to 1), and
  ``score_rel``: ``max |s - s_ref| / s_ref``, which one vertex's wrong
  score moves at any scale;
* SSSP, ``dist_rel``: ``max |d - d_ref| / d_ref`` over the vertices,
  infinite where one side reaches a vertex that the other does not or
  the root's distance is not 0 (both read 0 there).
"""

from __future__ import annotations

import torch

from ..gen import urand
from .common import CHUNK, finite

Tensor = torch.Tensor


class Graph:
    """Arcs ``rows -> cols`` (int32, sorted, unique) with float32 ``vals``
    (1, or the pair's weight), on ``n`` vertices."""

    def __init__(self, cfg: dict, seed: int, device, *, weighted: bool):
        self.n = urand.n_vertices(cfg)
        idx, vals = urand.arcs(cfg, seed, device, weighted=weighted)
        key = idx[:, 0].long() * self.n + idx[:, 1].long()
        del idx
        uk, inv = torch.unique(key, sorted=True, return_inverse=True)
        del key
        self.vals = torch.empty(uk.shape[0], dtype=torch.float32,
                                device=device)
        self.vals[inv] = vals          # every duplicate has the same value
        del inv, vals
        self.rows = (uk // self.n).to(torch.int32)
        self.cols = (uk % self.n).to(torch.int32)

    def chunks(self):
        for s in range(0, self.rows.shape[0], CHUNK):
            yield (self.rows[s:s + CHUNK].long(), self.cols[s:s + CHUNK].long(),
                   self.vals[s:s + CHUNK])


def pagerank(g: Graph, mix: dict, dtype) -> Tensor:
    """GAP's ``pr``: ``contrib = score / outdeg``; ``score = (1 - d) / n +
    d * sum of the in-neighbours' contrib``; stop when the L1 change is
    under the tolerance or after ``max_iters`` iterations. An arc ``r ->
    c`` carries ``contrib[r]`` to ``c``."""
    d = mix["damping"]
    deg = torch.bincount(g.rows.long(), minlength=g.n).to(dtype)
    score = torch.full((g.n,), 1.0 / g.n, dtype=dtype, device=deg.device)
    base = (1.0 - d) / g.n
    for _ in range(mix["max_iters"]):
        contrib = torch.where(deg > 0, score / deg, torch.zeros_like(score))
        incoming = torch.zeros_like(score)
        for r, c, _v in g.chunks():
            incoming.index_add_(0, c, contrib[r])
        new = base + d * incoming
        err = float((new - score).abs().sum())
        score = new
        if err < mix["tolerance"]:
            break
    return score


def bellman_ford(g: Graph, root: int, dtype) -> Tensor:
    """Distances from ``root`` (``inf`` where unreachable): relax every arc
    until a round lowers nothing."""
    dist = torch.full((g.n,), float("inf"), dtype=dtype,
                      device=g.rows.device)
    dist[root] = 0
    while True:
        new = dist.clone()
        for r, c, v in g.chunks():
            new.scatter_reduce_(0, c, dist[r] + v.to(dtype), "amin")
        if not bool((new < dist).any()):
            return dist
        dist = new


def check_pr(cfg: dict, mix: dict, seed: int, device, samples: list,
             control: bool = False) -> dict:
    """``samples``: ``(job index, scores)`` the program returned."""
    g = Graph(cfg, seed, device, weighted=False)
    ref = pagerank(g, mix, torch.float64)
    ctl = pagerank(g, mix, torch.bfloat16) if control else None
    out = {"score_l1": 0.0, "score_rel": 0.0}
    for _, s in samples:
        gap = ((ctl if control else s).double() - ref).abs()
        out["score_l1"] = max(out["score_l1"], finite(float(gap.sum())))
        out["score_rel"] = max(out["score_rel"],
                               finite(float((gap / ref).max())))
    return out


def check_sssp(cfg: dict, mix: dict, seed: int, device, samples: list,
               control: bool = False) -> dict:
    """``samples``: ``(root, dist)`` the program returned."""
    g = Graph(cfg, seed, device, weighted=True)
    worst = 0.0
    for root, d in samples:
        ref = bellman_ford(g, root, torch.float64)
        got = bellman_ford(g, root, torch.bfloat16) if control else d
        got = got.double().reshape(-1)
        reached = torch.isfinite(ref)
        if not torch.equal(reached, torch.isfinite(got)):
            return {"dist_rel": float("inf")}
        pos = reached & (ref > 0)
        if bool((got[reached & (ref == 0)] != 0).any()):
            return {"dist_rel": float("inf")}
        if bool(pos.any()):
            gap = float(((got[pos] - ref[pos]).abs() / ref[pos]).max())
            worst = max(worst, finite(gap))
    return {"dist_rel": worst}

"""GAP single-source shortest paths through the port's graph tier:
``bellman_ford`` on the consolidated weighted graph from a root drawn
from the seed among the non-isolated vertices, a new root each job; the
count of vertices reached read on the host."""

from __future__ import annotations

import torch

from spsparse_torch.graph import bellman_ford

from ..gen import urand
from ..reference.urand import check_sssp as check  # noqa: F401
from ._gap import build_graph


class Job:
    def __init__(self, cfg, mix, seed, device, span):
        self.span = span
        idx, vals = urand.arcs(cfg, seed, device, weighted=True)
        # The warm-up's root comes last, apart from the window's.
        self.roots = urand.roots(cfg, idx, int(mix["roots"]) + 1, seed)
        self.graph, self.prepare_s = build_graph(cfg, idx, vals, device, span)

    def warm(self) -> None:
        self._solve(self.roots[-1])

    def _solve(self, root: int):
        with self.span("portbench.bellman_ford"):
            dist = bellman_ford(self.graph, [root])
        with self.span("portbench.host_read"):
            int(torch.isfinite(dist).sum())
        return dist

    def run(self, k: int):
        root = self.roots[k % (len(self.roots) - 1)]
        return root, self._solve(root)

    def close(self) -> None:
        self.graph = None

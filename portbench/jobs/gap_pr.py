"""GAP PageRank trials over the port's unstructured SpMV: the graph is
prepared once with ``prepare_shuffle_spmv`` and each iteration runs
``best_spmv`` (kernel K11 and the ELL row sum); the benchmark's own loop
does GAP's ``pr``: ``contrib = score / outdeg``, ``score = (1 - d) / n +
d * A contrib``, the L1 change read on the host, until it is under the
tolerance or after ``max_iters`` iterations."""

from __future__ import annotations

import time

import torch

from spsparse_torch.ops import best_spmv, prepare_shuffle_spmv

from ..gen import urand
from ..reference.urand import check_pr as check  # noqa: F401
from ._gap import build_graph
from .common import sync


class Job:
    def __init__(self, cfg, mix, seed, device, span):
        self.span = span
        self.n = urand.n_vertices(cfg)
        self.damping = float(mix["damping"])
        self.tol = float(mix["tolerance"])
        self.max_iters = int(mix["max_iters"])
        idx, vals = urand.arcs(cfg, seed, device, weighted=False)
        g, build_s = build_graph(cfg, idx, vals, device, span)
        del idx, vals
        t0 = time.perf_counter()
        with span("portbench.prepare"):
            self.prep = prepare_shuffle_spmv(g)
            del g
            sync(device)
        self.prepare_s = build_s + time.perf_counter() - t0
        # Out-degrees: the adjacency (values 1) times ones, by the port.
        deg = best_spmv(self.prep, torch.ones(self.n, device=device))
        self.deg = deg.clamp(min=1.0)   # an isolated vertex sends nothing

    def warm(self) -> None:
        self.run(0)

    def run(self, k: int):
        d, n = self.damping, self.n
        score = torch.full((n,), 1.0 / n, dtype=torch.float32,
                           device=self.deg.device)
        for _ in range(self.max_iters):
            contrib = score / self.deg
            with self.span("portbench.spmv"):
                incoming = best_spmv(self.prep, contrib)
            new = (1.0 - d) / n + d * incoming
            with self.span("portbench.host_read"):
                err = float((new - score).abs().sum())
            score = new
            if err < self.tol:
                break
        return k, score

    def close(self) -> None:
        self.prep = self.deg = None

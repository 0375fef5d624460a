"""Set-up shared by the GAP jobs: the port builds the graph from the
generated arcs with ``consolidate`` (sorted, one arc per vertex pair)."""

from __future__ import annotations

import time

import spsparse_torch as sp

from ..gen import urand
from .common import sync


def build_graph(cfg: dict, idx, vals, device, span):
    """``(graph, prepare_s)``: the consolidated COO of the arcs, keeping
    the first of duplicate arcs (they carry equal values), and the host
    clock it took, ended by a synchronise."""
    n = urand.n_vertices(cfg)
    sync(device)
    t0 = time.perf_counter()
    with span("portbench.prepare"):
        a = sp.SparseCOO.from_arrays(idx, vals, (n, n), device=device)
        g = sp.consolidate(a, duplicate_policy=sp.DuplicatePolicy.LEAVE_ALONE)
        del a
        sync(device)
    return g, time.perf_counter() - t0

"""Set-up shared by the HPCG jobs: the port's ingest path from the
generated entries to the prepared banded operator, and the right-hand
sides."""

from __future__ import annotations

import time

import torch

import spsparse_torch as sp
from spsparse_torch.ops import prepare_dia

from ..gen import hpcg27
from .common import sync


class HpcgSetup:
    """``prep`` (the float32 :class:`PreparedDIA` the port built from the
    entries), ``prepare_s`` (host clock from the entries on the device to
    ``prep``, ended by a synchronise) and ``pool`` (the right-hand
    sides)."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, span):
        n = hpcg27.n_rows(cfg)
        idx, vals = hpcg27.entries(cfg, device)
        sync(device)
        t0 = time.perf_counter()
        with span("portbench.prepare"):
            a = sp.SparseCOO.from_arrays(idx, vals, (n, n), device=device)
            del idx, vals
            dia = sp.to_dia(a)
            del a
            self.prep = prepare_dia(dia, dtype=torch.float32)
            del dia
            sync(device)
        self.prepare_s = time.perf_counter() - t0
        self.pool = hpcg27.rhs_pool(cfg, mix["rhs_pool"], seed, device)
        self.iters = int(mix["iters"])
        self.span = span

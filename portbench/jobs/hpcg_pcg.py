"""HPCG CG through the solver layer: ``pcg_solve`` with the Jacobi
preconditioner and ``best_spmv`` (kernel K1) on the prepared operator,
the right-hand sides of the pool in turn, the final residual read on the
host. It bypasses K4."""

from __future__ import annotations

import torch

from spsparse_torch.ops import best_spmv
from spsparse_torch.solvers import pcg_solve

from ..reference.hpcg27 import check  # noqa: F401  (the job's reference)
from ._hpcg import HpcgSetup


class Job(HpcgSetup):
    def __init__(self, cfg, mix, seed, device, span):
        super().__init__(cfg, mix, seed, device, span)
        # Jacobi: 1 / diag(A), from the port's own diagonals.
        diag = self.prep.data[self.prep.offsets.index(0)]
        self.minv = 1.0 / diag.to(torch.float32)

    def matvec(self, v):
        with self.span("portbench.spmv"):
            return best_spmv(self.prep, v)

    def warm(self) -> None:
        self.run(0)

    def run(self, k: int):
        slot = k % len(self.pool)
        with self.span("portbench.pcg_solve"):
            x, rr = pcg_solve(self.matvec, self.pool[slot], iters=self.iters,
                              minv=self.minv)
        with self.span("portbench.host_read"):
            float(rr)
        return slot, x

    def close(self) -> None:
        self.prep = self.pool = self.minv = None

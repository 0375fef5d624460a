"""HPCG CG through kernel K4: one ``cg_solve_dia`` a job, the right-hand
sides of the pool in turn, the final residual read on the host."""

from __future__ import annotations

from spsparse_torch.ops import cg_solve_dia

from ..reference.hpcg27 import check  # noqa: F401  (the job's reference)
from ._hpcg import HpcgSetup


class Job(HpcgSetup):
    def warm(self) -> None:
        self.run(0)

    def run(self, k: int):
        slot = k % len(self.pool)
        with self.span("portbench.cg_solve"):
            x, rs = cg_solve_dia(self.prep, self.pool[slot], iters=self.iters)
        with self.span("portbench.host_read"):
            float(rs)
        return slot, x

    def close(self) -> None:
        self.prep = self.pool = None

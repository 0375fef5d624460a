"""Shared pieces of the references: chunked COO products and the
per-sample comparisons."""

from __future__ import annotations

import torch

Tensor = torch.Tensor

# Entries a chunk: bounds the temporaries of a product over ~5e8 entries.
CHUNK = 1 << 26


class CooOperator:
    """``A`` as its entries: ``rows``, ``cols`` (int32) and ``vals``
    (float32, as generated); products run in the dtype asked for, a chunk
    of entries at a time, by ``index_add_``."""

    def __init__(self, rows: Tensor, cols: Tensor, vals: Tensor, n: int):
        self.rows, self.cols, self.vals, self.n = rows, cols, vals, n

    def matvec(self, x: Tensor) -> Tensor:
        y = torch.zeros(self.n, dtype=x.dtype, device=x.device)
        for s in range(0, self.rows.shape[0], CHUNK):
            r = self.rows[s:s + CHUNK].long()
            c = self.cols[s:s + CHUNK].long()
            y.index_add_(0, r, self.vals[s:s + CHUNK].to(x.dtype) * x[c])
        return y

    def diagonal(self) -> Tensor:
        d = torch.zeros(self.n, dtype=torch.float64, device=self.vals.device)
        for s in range(0, self.rows.shape[0], CHUNK):
            r, c = self.rows[s:s + CHUNK], self.cols[s:s + CHUNK]
            on = r == c
            d.index_add_(0, r[on].long(), self.vals[s:s + CHUNK][on].double())
        return d


def finite(v: float) -> float:
    """``v``, or infinity where it is NaN: ``max`` keeps its first argument
    against a NaN, and a NaN answer must never read as a small gap."""
    return v if v == v else float("inf")


def rel_gap(got: Tensor, ref: Tensor) -> float:
    """``||got - ref|| / ||ref||`` in float64."""
    got, ref = got.double(), ref.double()
    den = float(torch.linalg.vector_norm(ref))
    return finite(float(torch.linalg.vector_norm(got - ref)) / max(den, 1e-300))

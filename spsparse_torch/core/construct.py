"""Constructors: the identity.

Counterpart of :func:`spsparse_tpu.core.construct.coo_eye`, the one
function of that module that the SpGEMM slice needs (``coo_matrix_power``
with ``k = 0``); the rest of the module is still to port.
"""

from __future__ import annotations

import numpy as np

from .coo import CooBuilder, SparseCOO

__all__ = ["coo_eye"]


def coo_eye(n: int, m: int | None = None, k: int = 0, dtype=np.float32, *,
            device=None) -> SparseCOO:
    """Identity / shifted-identity matrix (``scipy.sparse.eye``) on
    ``device``, the card by default."""
    m = n if m is None else m
    lo, hi = max(0, -k), min(n, m - k)
    b = CooBuilder((n, m), dtype=dtype)
    if hi > lo:
        r = np.arange(lo, hi)
        b.add_many(np.stack([r, r + k], 1), np.ones(hi - lo))
    return b.build(device=device)

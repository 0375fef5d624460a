"""Norm estimation for implicitly defined operators.

PyTorch counterpart of :mod:`spsparse_tpu.solvers.norms`. ``onenormest`` is
the Higham-Tisseur block 1-norm estimator (scipy.sparse.linalg.onenormest):
a few block products with ``A`` and ``A^T`` instead of materialized
columns, so it works for operator products where the matrix never exists.
The ``t`` probe columns ride one ``(n, t)`` block through ``matmat``, and
the round count is fixed, as in the JAX package: the estimate is a lower
bound that is almost always exact.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.coo import SparseCOO
from ..core.device import DeviceLike, resolve_device
from ..core.errors import SpSparseError
from .linop import LinearOperator, aslinearoperator

__all__ = ["onenormest"]

Tensor = torch.Tensor


def onenormest(A, *, t: int = 2, itmax: int = 5, seed: int = 0,
               device: DeviceLike = None) -> Tensor:
    """Estimate ``||A||_1`` (the largest column abs-sum) of a square
    operator.

    ``A`` is a :class:`LinearOperator` (with ``rmatvec``), a
    :class:`SparseCOO`, or anything :func:`aslinearoperator` accepts. ``t``
    probe columns and ``itmax`` forward/adjoint rounds, both fixed. The
    probe block (ones, then random signs from ``default_rng(seed)``) is the
    JAX package's, made on the COO's device, else on ``device`` (the card
    by default). The next probes are the unit vectors at the ``t`` largest
    unvisited ``max_j |Z[i, j]|``, ties to the lower index, as
    ``jax.lax.top_k`` orders them. Returns a 0-d tensor."""
    op = A if isinstance(A, LinearOperator) else aslinearoperator(A)
    m, n = op.shape
    if m != n:
        raise SpSparseError(f"onenormest needs a square operator, got "
                            f"{op.shape}")
    dev = A.device if isinstance(A, SparseCOO) else resolve_device(device)
    t = max(1, min(int(t), n))
    # Probe block: a ones column and random sign columns (Higham-Tisseur X0).
    rng = np.random.default_rng(seed)
    X0 = np.ones((n, t))
    if t > 1:
        X0[:, 1:] = rng.choice([-1.0, 1.0], size=(n, t - 1))
    X0 /= n
    X = torch.from_numpy(X0).to(dev)
    visited = torch.zeros(n, dtype=torch.bool, device=dev)
    cols = torch.arange(t, device=dev)
    ests = []
    for _ in range(max(1, int(itmax))):
        Y = op.matmat(X)                           # (n, t)
        ests.append(Y.abs().sum(dim=0).max())
        S = torch.where(Y >= 0, 1.0, -1.0).to(Y.dtype)
        Z = op.rmatmat(S)                          # (n, t)
        h = Z.abs().amax(dim=1)
        # Next probes: the t largest h among columns not yet visited
        # (revisiting wastes the round: Higham-Tisseur's rule); a stable
        # descending sort puts the lower index first among ties.
        key = torch.where(visited, torch.full_like(h, -torch.inf), h)
        idx = torch.sort(key, descending=True, stable=True).indices[:t]
        visited[idx] = True
        X = torch.zeros((n, t), dtype=X.dtype, device=dev)
        X[idx, cols] = 1.0
    return torch.stack(ests).max()

"""Bandwidth-reducing reordering — the bridge from scattered matrices to
the DIA kernel K1.

Counterpart of :mod:`spsparse_tpu.core.reorder`. The DIA SpMV kernel needs
a banded matrix; many matrices (regridding meshes, finite-element or
finite-volume couplings) are banded only up to a relabelling of the
unknowns, which reverse Cuthill-McKee recovers from the sparsity pattern
alone. ``rcm_permutation`` + :func:`coo_permute` + ``to_dia`` is therefore
a performance path (scipy's counterpart is
``scipy.sparse.csgraph.reverse_cuthill_mckee``).

The split between host and device is the JAX package's: the BFS ordering
is sequential pointer chasing and runs on the host in numpy, a one-time
planning cost; applying a permutation is two gathers on the array's
device. :func:`bandwidth` reduces on the device and returns one scalar.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .coo import SparseCOO, operand_tensor
from .errors import SpSparseError

__all__ = ["rcm_permutation", "coo_permute", "bandwidth"]


def rcm_permutation(a: SparseCOO) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of a square rank-2 array's
    symmetrised sparsity pattern, on the host.

    Returns ``perm (n,) int64`` such that ``coo_permute(a, perm)`` (that is
    ``A[perm][:, perm]``) has a small bandwidth — scipy's
    ``reverse_cuthill_mckee`` convention, and the JAX package's ordering
    element for element. Each connected component starts from a
    minimum-degree node and is visited breadth first with neighbours in
    increasing (degree, node) order; the whole order is then reversed.
    The neighbour lists are sorted once up front, so the BFS loop does no
    sorting of its own."""
    if a.rank != 2 or a.shape[0] != a.shape[1]:
        raise SpSparseError(
            f"rcm_permutation requires a square rank-2 array, "
            f"got shape {a.shape}")
    n = int(a.shape[0])
    idx = a.indices[: a.nnz].cpu().numpy()
    r, c = idx[:, 0].astype(np.int64), idx[:, 1].astype(np.int64)
    # Symmetrise the pattern; self-loops do not affect the BFS.
    rr = np.concatenate([r, c])
    cc = np.concatenate([c, r])
    keep = rr != cc
    rr, cc = rr[keep], cc[keep]
    # CSR-style adjacency; a node's degree counts parallel edges.
    order = np.lexsort((cc, rr))
    rr, cc = rr[order], cc[order]
    ptr = np.searchsorted(rr, np.arange(n + 1))
    deg = ptr[1:] - ptr[:-1]
    # Each neighbour list once, sorted by (degree, node) and without
    # parallel edges: the order in which the BFS appends a node's
    # unvisited neighbours, so the loop below only filters.
    order = np.lexsort((cc, deg[cc], rr))
    rr, cc = rr[order], cc[order]
    first = np.ones(rr.size, dtype=bool)
    first[1:] = (rr[1:] != rr[:-1]) | (cc[1:] != cc[:-1])
    rr, cc = rr[first], cc[first]
    ptr = np.searchsorted(rr, np.arange(n + 1))

    perm = np.empty(n, dtype=np.int64)
    visited = np.zeros(n, dtype=bool)
    pos = 0
    # Component seeds in minimum-degree order (the classic RCM heuristic).
    for s in np.argsort(deg, kind="stable"):
        if visited[s]:
            continue
        visited[s] = True
        perm[pos] = s
        head, pos = pos, pos + 1
        while head < pos:                      # BFS over this component
            u = perm[head]
            head += 1
            nbr = cc[ptr[u]:ptr[u + 1]]
            nbr = nbr[~visited[nbr]]
            if nbr.size:
                visited[nbr] = True
                perm[pos:pos + nbr.size] = nbr
                pos += nbr.size
    return perm[::-1].copy()                   # the "reverse" in RCM


def coo_permute(a: SparseCOO, perm, col_perm=None) -> SparseCOO:
    """Permute a rank-2 array on both sides: ``B = A[perm][:, col_perm]``,
    ``col_perm`` defaulting to ``perm``, so ``B[i, j] = A[perm[i],
    col_perm[j]]`` (scipy's slicing convention, matching
    :func:`rcm_permutation`).

    Runs on ``a``'s device: the inverse permutations, then one gather per
    index column. Structure, duplicates and values are untouched; the
    sortedness metadata is dropped."""
    if a.rank != 2:
        raise SpSparseError("coo_permute requires a rank-2 array")
    perm = operand_tensor(perm, a.device).long()
    cperm = perm if col_perm is None else operand_tensor(
        col_perm, a.device).long()
    nr, nc = int(a.shape[0]), int(a.shape[1])
    if tuple(perm.shape) != (nr,) or tuple(cperm.shape) != (nc,):
        raise SpSparseError(
            f"permutation shapes {tuple(perm.shape)}/{tuple(cperm.shape)} "
            f"do not match array shape {a.shape}")
    dt = a.index_dtype
    inv_r = torch.empty(nr, dtype=dt, device=a.device)
    inv_r[perm] = torch.arange(nr, dtype=dt, device=a.device)
    inv_c = inv_r
    if col_perm is not None:
        inv_c = torch.empty(nc, dtype=dt, device=a.device)
        inv_c[cperm] = torch.arange(nc, dtype=dt, device=a.device)
    live = a.valid_mask()
    # Padding keeps its sentinel.
    r, c = a.indices[:, 0], a.indices[:, 1]
    new_r = torch.where(live, inv_r[r.long().clamp(max=nr - 1)], r)
    new_c = torch.where(live, inv_c[c.long().clamp(max=nc - 1)], c)
    return dataclasses.replace(a, indices=torch.stack([new_r, new_c], 1),
                               sort_order=None)


def bandwidth(a: SparseCOO) -> int:
    """Largest ``|row - col|`` over the live entries of a rank-2 array (0
    when empty) — what RCM minimises; a matrix of bandwidth ``b`` converts
    to DIA with at most ``2b + 1`` diagonals."""
    if a.rank != 2:
        raise SpSparseError("bandwidth requires a rank-2 array")
    if a.nnz == 0:
        return 0
    idx = a.indices[: a.nnz].long()
    return int((idx[:, 0] - idx[:, 1]).abs().max())

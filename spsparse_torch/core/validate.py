"""Eager structural checks of COO containers and capacities.

Counterpart of :mod:`spsparse_tpu.core.validate`, whose checks are
``checkify`` assertions that travel with a jitted computation. The port
runs eagerly, so the same conditions are checked when called and a failure
raises through the pluggable error handler (:func:`spsparse_error`) with
the JAX check's message. Use them where a container was assembled from raw
arrays (``SparseCOO(indices, vals, nnz, shape)``) or a producer was given a
capacity, where the builder's own checks did not run.

On a CUDA container each call costs one host read (the bounds test is
reduced on the card and its one flag fetched); ``nnz`` is a host integer.
"""

from __future__ import annotations

import torch

from .coo import SparseCOO
from .errors import spsparse_error

__all__ = ["validate_coo", "check_capacity"]


def validate_coo(a: SparseCOO) -> None:
    """Raise unless ``0 <= a.nnz <= a.cap`` and every live index tuple lies
    inside ``a.shape`` (padding slots are not checked).

    Mirrors the reference's ``add()`` bounds contract
    (VectorCooArray.hpp:246-262) for arrays assembled from raw buffers,
    where the eager builder checks did not run. The checks run in the JAX
    package's order, and the first that fails raises.
    """
    nnz = int(a.nnz)
    if nnz < 0:
        spsparse_error(-1, "SparseCOO nnz is negative")
    if nnz > a.cap:
        spsparse_error(-1, "SparseCOO nnz exceeds capacity (overflowed cap)")
    live = a.indices[:nnz]
    shape = torch.tensor(a.shape, dtype=live.dtype, device=live.device)
    if not bool(((live >= 0) & (live < shape)).all()):
        spsparse_error(-1, "Sparse index out of bounds among live entries")


def check_capacity(n_needed, cap: int, what: str = "output") -> None:
    """Raise when ``n_needed`` (an int or a one-element tensor) exceeds the
    static capacity ``cap`` of a producer (consolidate/SpGEMM with
    user-chosen caps)."""
    if int(n_needed) > int(cap):
        spsparse_error(-1, "spsparse %s overflowed static capacity", what)

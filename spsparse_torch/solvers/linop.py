"""``LinearOperator`` — composable matrix-free operators over the port's
formats (the ``scipy.sparse.linalg.LinearOperator`` capability).

PyTorch counterpart of :mod:`spsparse_tpu.solvers.linop`. Every solver
takes a ``matvec`` callable; this class makes those callables algebra:
operators compose with ``@``, combine with ``+``/``-``/scalar ``*`` and
transpose with ``.T``, so a normal-equations solve is

    R = aslinearoperator(A_coo)        # CSR + CSC views built once
    N = R.T @ R + damp**2 * identity_operator(R.shape[1])
    x, _ = cg_solve(N, rhs, iters=...)

(``.T`` needs a transpose product: wrap the COO or a dense tensor, or pass
``rmatvec=``; DIA and prepared operands are forward-only.)
``LinearOperator.__call__`` is ``matvec``, so an operator drops straight
into ``cg_solve`` and the other solvers. Construction is host-side Python;
application is whatever the wrapped format dispatches to
(:func:`spsparse_torch.ops.best_spmv` / :func:`~spsparse_torch.ops.best_spmm`,
so DIA operands run kernel K1 on the card).
"""

from __future__ import annotations

from numbers import Number
from typing import Callable

import torch

from ..core.coo import SparseCOO, as_tensor
from ..core.dia import SparseDIA
from ..core.errors import SpSparseError
from ..core.structure import SparseCSR, SparseELL, to_csc, to_csr

Tensor = torch.Tensor
MatVec = Callable[[Tensor], Tensor]

__all__ = ["LinearOperator", "aslinearoperator", "identity_operator"]

_NO_RMATVEC = ("this LinearOperator has no rmatvec (transpose product); "
               "construct it from a COO/CSR operand or pass rmatvec=")


def _columns(fn: MatVec, X: Tensor) -> Tensor:
    """``fn`` applied to each column of ``X`` (the JAX package's column
    ``vmap``; a kernel behind ctypes cannot be vmapped)."""
    return torch.stack([fn(X[:, c]) for c in range(X.shape[1])], dim=1)


class LinearOperator:
    """A shaped pair of ``matvec``/``rmatvec`` callables with operator
    algebra. ``matmat``/``rmatmat`` default to column loops of the vector
    products (overridable with true multi-RHS kernels; ``rmatmat`` keeps
    the block path alive across ``.T``)."""

    def __init__(self, shape, matvec: MatVec, rmatvec: MatVec | None = None,
                 matmat: MatVec | None = None,
                 rmatmat: MatVec | None = None):
        if len(shape) != 2:
            raise SpSparseError(f"LinearOperator shape must be (m, n), "
                                f"got {shape}")
        self.shape = (int(shape[0]), int(shape[1]))
        self._mv = matvec
        self._rmv = rmatvec
        self._mm = matmat
        self._rmm = rmatmat

    # -- application ----------------------------------------------------
    def matvec(self, x: Tensor) -> Tensor:
        return self._mv(x)

    __call__ = matvec

    def rmatvec(self, u: Tensor) -> Tensor:
        if self._rmv is None:
            raise SpSparseError(_NO_RMATVEC)
        return self._rmv(u)

    def matmat(self, X: Tensor) -> Tensor:
        if self._mm is not None:
            return self._mm(X)
        return _columns(self._mv, X)

    def rmatmat(self, U: Tensor) -> Tensor:
        if self._rmm is not None:
            return self._rmm(U)
        if self._rmv is None:
            raise SpSparseError(_NO_RMATVEC)
        return _columns(self._rmv, U)

    # -- algebra ---------------------------------------------------------
    @property
    def T(self) -> "LinearOperator":
        if self._rmv is None:
            raise SpSparseError("transpose needs rmatvec; see rmatvec()")
        # Swap the vector AND block products so .T keeps the fast matmat
        # and .T.T restores the original exactly.
        return LinearOperator((self.shape[1], self.shape[0]),
                              self._rmv, self._mv,
                              matmat=self._rmm, rmatmat=self._mm)

    def __matmul__(self, other):
        if isinstance(other, LinearOperator):
            if self.shape[1] != other.shape[0]:
                raise SpSparseError(
                    f"operator shapes {self.shape} @ {other.shape} "
                    f"do not chain")
            rmv = rmm = None
            if self._rmv is not None and other._rmv is not None:
                rmv = lambda u: other._rmv(self._rmv(u))  # noqa: E731
                rmm = lambda U: other.rmatmat(self.rmatmat(U))  # noqa: E731
            return LinearOperator(
                (self.shape[0], other.shape[1]),
                lambda x: self._mv(other._mv(x)), rmv,
                matmat=lambda X: self.matmat(other.matmat(X)),
                rmatmat=rmm)
        other = as_tensor(other)
        if other.ndim == 1:
            return self.matvec(other)
        if other.ndim == 2:
            return self.matmat(other)
        raise SpSparseError(f"cannot apply operator to ndim-{other.ndim}")

    def __add__(self, other: "LinearOperator") -> "LinearOperator":
        if not isinstance(other, LinearOperator):
            raise SpSparseError("operator + expects another LinearOperator"
                                " (wrap tensors with aslinearoperator)")
        if self.shape != other.shape:
            raise SpSparseError(
                f"operator shapes {self.shape} + {other.shape} differ")
        rmv = rmm = None
        if self._rmv is not None and other._rmv is not None:
            rmv = lambda u: self._rmv(u) + other._rmv(u)  # noqa: E731
            rmm = lambda U: self.rmatmat(U) + other.rmatmat(U)  # noqa: E731
        return LinearOperator(
            self.shape, lambda x: self._mv(x) + other._mv(x), rmv,
            matmat=lambda X: self.matmat(X) + other.matmat(X),
            rmatmat=rmm)

    def __sub__(self, other: "LinearOperator") -> "LinearOperator":
        return self + (-1.0) * other

    def __mul__(self, c) -> "LinearOperator":
        scalar = (isinstance(c, Number) and not isinstance(c, bool)) or (
            isinstance(c, Tensor) and c.ndim == 0)
        if not scalar:
            # opA * opB is a natural typo for opA @ opB; without this check
            # matvec would silently return an operator object.
            raise SpSparseError(
                "operator * expects a scalar; use @ for composition")
        rmv = rmm = None
        if self._rmv is not None:
            rmv = lambda u: c * self._rmv(u)  # noqa: E731
            rmm = lambda U: c * self.rmatmat(U)  # noqa: E731
        return LinearOperator(self.shape, lambda x: c * self._mv(x), rmv,
                              matmat=lambda X: c * self.matmat(X),
                              rmatmat=rmm)

    __rmul__ = __mul__

    def __neg__(self) -> "LinearOperator":
        return (-1.0) * self

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"LinearOperator(shape={self.shape}, "
                f"rmatvec={'yes' if self._rmv else 'no'})")


def identity_operator(n: int) -> LinearOperator:
    """The ``n x n`` identity as an operator (for shifts/regularisers)."""
    ident = lambda x: x  # noqa: E731
    return LinearOperator((n, n), ident, ident, matmat=ident,
                          rmatmat=ident)


def aslinearoperator(a) -> LinearOperator:
    """Wrap anything the port can multiply by into a
    :class:`LinearOperator`:

    * ``LinearOperator`` — returned as-is.
    * dense 2-D tensor (or host array, which goes to the default device) —
      plain matmuls.
    * :class:`SparseCOO` — CSR + CSC views built once, so both ``matvec``
      and ``rmatvec`` run the sorted kernel paths.
    * :class:`SparseCSR` / :class:`SparseELL` — forward only.
    * :class:`SparseDIA` — ``matvec`` through :func:`ops.best_spmv` (kernel
      K1), ``matmat`` through :func:`ops.best_spmm`.
    * :class:`SparseBSR` / :class:`SparseTiledCOO` — ``matmat`` through
      ``best_spmm``; a vector rides as a one-column block.
    * :class:`~spsparse_torch.ops.PreparedDIA` /
      :class:`~spsparse_torch.ops.PreparedGeneral` /
      :class:`~spsparse_torch.ops.PreparedShuffleSpMV` — ``matvec`` through
      ``best_spmv``; ``matmat`` is the column loop.
    """
    from ..core.bsr import SparseBSR
    from ..core.tiled import SparseTiledCOO
    from ..ops.dia_stream import PreparedDIA, prepare_dia
    from ..ops.general import PreparedGeneral
    from ..ops.spmm import spmm, spmv
    from ..ops.spmv_kernels import best_spmm, best_spmv
    from ..ops.spmv_shuffle import PreparedShuffleSpMV

    if isinstance(a, LinearOperator):
        return a
    if isinstance(a, SparseCOO):
        if a.rank != 2:
            raise SpSparseError("aslinearoperator needs a rank-2 array")
        csr, csc = to_csr(a), to_csc(a)
        return LinearOperator(
            a.shape, lambda x: spmv(csr, x), lambda u: spmv(csc, u),
            matmat=lambda X: spmm(csr, X), rmatmat=lambda U: spmm(csc, U))
    if isinstance(a, (SparseCSR, SparseELL)):
        return LinearOperator(a.shape, lambda x: spmv(a, x), None,
                              matmat=lambda X: spmm(a, X))
    if isinstance(a, SparseDIA):
        # Prepared once: for float32 contiguous diagonals prepare_dia is the
        # identity (the same tensor, so the same values and gradients) and
        # each matvec skips it; other types are cast on every matvec, as
        # best_spmv casts them.
        op = (prepare_dia(a) if a.data.dtype == torch.float32
              and a.data.is_contiguous() else a)
        return LinearOperator(a.shape, lambda x: best_spmv(op, x), None,
                              matmat=lambda X: best_spmm(a, X))
    if isinstance(a, (SparseBSR, SparseTiledCOO)):
        return LinearOperator(
            a.shape, lambda x: best_spmm(a, x[:, None])[:, 0], None,
            matmat=lambda X: best_spmm(a, X))
    if isinstance(a, (PreparedDIA, PreparedGeneral, PreparedShuffleSpMV)):
        return LinearOperator(a.shape, lambda x: best_spmv(a, x), None)
    arr = as_tensor(a)
    if arr.ndim != 2:
        raise SpSparseError(
            f"cannot wrap ndim-{arr.ndim} object as a LinearOperator")
    return LinearOperator(arr.shape, lambda x: arr @ x,
                          lambda u: arr.T @ u, matmat=lambda X: arr @ X)

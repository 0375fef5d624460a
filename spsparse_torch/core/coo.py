"""``SparseCOO`` — the rank-N sparse array at the heart of the library.

PyTorch counterpart of :mod:`spsparse_tpu.core.coo` (the reference's
``VectorCooArray``). The container contract is the JAX package's, so that
the two can be compared like with like:

* ``indices``: ``(cap, rank)`` int32 tensor (int64 when an extent is
  ``>= 2**31``) — index tuples; row ``p`` is live iff ``p < nnz``. Padding
  rows hold the out-of-range sentinel ``shape[d]`` so that lexicographic
  sorts push padding to the end.
* ``vals``: ``(cap,)`` — values; padding entries are 0.
* ``nnz``: live entry count.
* ``shape``: tuple of dense extents.
* ``sort_order``: tuple or ``None`` — sortedness metadata.

Divergence from the JAX package: ``nnz`` is a Python ``int``. PyTorch runs
eagerly and has no ``jit`` to trace, so the count is always concrete, and
keeping it on the host saves a device round trip on every size query.

Capacities computed automatically are rounded up to powers of two
(:func:`round_up_pow2`), as in the JAX package, so the two agree on ``cap``.

Every constructor takes ``device=``. Host data (numpy, lists, a builder's
buffers) goes to ``device``, which defaults to the card
(:func:`spsparse_torch.default_device`); without CUDA that default raises,
so CPU callers pass ``device="cpu"``. Tensors passed in stay where they are
unless ``device`` says otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from .device import resolve_device
from .errors import DuplicatePolicy, SpSparseError, spsparse_error

__all__ = ["SparseCOO", "CooBuilder", "coo_matrix", "coo_vector",
           "default_index_dtype", "round_up_pow2", "as_tensor",
           "operand_tensor", "numpy_dtype"]

Tensor = torch.Tensor
DeviceLike = Any

_NP_OF_TORCH = {
    torch.float16: np.float16, torch.float32: np.float32,
    torch.float64: np.float64, torch.int8: np.int8, torch.int16: np.int16,
    torch.int32: np.int32, torch.int64: np.int64, torch.uint8: np.uint8,
    torch.bool: np.bool_, torch.complex64: np.complex64,
    torch.complex128: np.complex128,
}


def numpy_dtype(dtype) -> np.dtype:
    """A numpy dtype from a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _NP_OF_TORCH:
            raise TypeError(f"no numpy dtype for {dtype}")
        return np.dtype(_NP_OF_TORCH[dtype])
    return np.dtype(dtype)


def as_tensor(x, device: DeviceLike = None) -> Tensor:
    """Tensor view of ``x``: a tensor stays where it is unless ``device``
    is given; host data goes to ``device`` (the card by default)."""
    if isinstance(x, Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def operand_tensor(x, device: DeviceLike) -> Tensor:
    """``x`` for an op whose operand lies on ``device``: a tensor stays
    where it is; host data goes to ``device``, not to the default."""
    if isinstance(x, Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=device)


def default_index_dtype(shape: Sequence[int]) -> torch.dtype:
    """int32 unless an extent (so the sentinel ``extent`` too) overflows it;
    then int64, the reference's on-file ``IndexT``."""
    if shape and max(int(s) for s in shape) >= 2**31:
        return torch.int64
    return torch.int32


def round_up_pow2(n: int) -> int:
    """Round a capacity up to the next power of two (at least 1)."""
    n = int(n)
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class SparseCOO:
    """Padded struct-of-arrays COO sparse array (see module docstring)."""

    indices: Tensor
    vals: Tensor
    nnz: int
    shape: tuple
    sort_order: tuple | None = None

    # ------------------------------------------------------------------
    # Basic properties
    # ------------------------------------------------------------------
    @property
    def rank(self) -> int:
        return len(self.shape)

    @property
    def cap(self) -> int:
        """Padded capacity (number of slots in the buffers)."""
        return self.indices.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def index_dtype(self) -> torch.dtype:
        return self.indices.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def __len__(self) -> int:
        return int(self.nnz)

    @property
    def size(self) -> int:
        """Live entry count."""
        return self.nnz

    def valid_mask(self) -> Tensor:
        """Boolean ``(cap,)`` mask of live entries."""
        return torch.arange(self.cap, device=self.device) < self.nnz

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------
    @staticmethod
    def sentinel_index(shape: Sequence[int], dtype=None,
                       device: DeviceLike = None) -> Tensor:
        """The padding index tuple: one-past-the-end in every dimension."""
        dtype = dtype or default_index_dtype(shape)
        return torch.tensor([int(s) for s in shape], dtype=dtype,
                            device=resolve_device(device))

    @classmethod
    def empty(cls, shape: Sequence[int], cap: int, dtype=torch.float32,
              index_dtype=None, *, device: DeviceLike = None) -> "SparseCOO":
        """An all-padding array with ``nnz == 0`` and the given capacity."""
        shape = tuple(int(s) for s in shape)
        cap = max(int(cap), 1)
        device = resolve_device(device)
        index_dtype = index_dtype or default_index_dtype(shape)
        if not isinstance(dtype, torch.dtype):
            dtype = torch.from_numpy(np.zeros(0, numpy_dtype(dtype))).dtype
        sent = cls.sentinel_index(shape, index_dtype, device)
        indices = sent.expand(cap, len(shape)).contiguous()
        vals = torch.zeros((cap,), dtype=dtype, device=device)
        return cls(indices=indices, vals=vals, nnz=0, shape=shape)

    @classmethod
    def from_arrays(
        cls,
        indices,
        vals,
        shape: Sequence[int],
        *,
        nnz: int | None = None,
        cap: int | None = None,
        sort_order: tuple | None = None,
        check: bool = True,
        device: DeviceLike = None,
    ) -> "SparseCOO":
        """Build from arrays of index tuples and values.

        ``indices`` is ``(n, rank)`` (or ``(n,)`` for rank-1); entries beyond
        ``nnz`` (default: all of ``n``) are ignored and re-padded. With
        ``check``, out-of-bounds live indices raise through the pluggable
        error handler (the reference's ``add()`` bounds check).
        """
        shape = tuple(int(s) for s in shape)
        rank = len(shape)
        indices = as_tensor(indices, device)
        if indices.ndim == 1:
            indices = indices[:, None]
        if indices.ndim != 2 or indices.shape[1] != rank:
            raise SpSparseError(
                f"indices must have shape (n, {rank}); got "
                f"{tuple(indices.shape)}")
        need = default_index_dtype(shape)
        if indices.dtype not in (torch.int32, torch.int64):
            indices = indices.to(need)
        elif indices.dtype == torch.int32 and need == torch.int64:
            indices = indices.to(torch.int64)
        vals = as_tensor(vals, indices.device)
        n = indices.shape[0]
        if tuple(vals.shape) != (n,):
            raise SpSparseError(
                f"vals must have shape ({n},); got {tuple(vals.shape)}")
        nnz = n if nnz is None else int(nnz)

        if check and nnz:
            live = indices[:nnz]
            ext = torch.tensor(shape, dtype=live.dtype, device=live.device)
            bad = ((live < 0) | (live >= ext)).any(dim=1)
            if bool(bad.any()):
                first = int(torch.nonzero(bad)[0, 0])
                spsparse_error(
                    -1, "Sparse index out of bounds: index=%s vs. shape=%s",
                    tuple(indices[first].tolist()), shape)

        cap = round_up_pow2(n) if cap is None else cap
        cap = max(int(cap), 1)
        order = (tuple(int(d) for d in sort_order)
                 if sort_order is not None else None)
        if n == 0:
            # An empty array is trivially sorted: keep the caller's order.
            out = cls.empty(shape, cap, dtype=vals.dtype,
                            index_dtype=indices.dtype,
                            device=indices.device)
            return dataclasses.replace(out, sort_order=order)
        out = cls(indices=indices, vals=vals, nnz=nnz, shape=shape,
                  sort_order=order)
        return out.with_capacity(cap).repad()

    @classmethod
    def from_dense(cls, arr, *, cap: int | None = None,
                   device: DeviceLike = None) -> "SparseCOO":
        """Dense → COO, dropping zeros (reference ``to_sparse``). With
        ``cap``, entries beyond ``cap`` are cut, as in the JAX package."""
        arr = as_tensor(arr, device)
        nz = torch.nonzero(arr)
        idx = nz.to(default_index_dtype(arr.shape))
        vals = arr[tuple(nz.T)] if arr.ndim else arr.reshape(1)[:0]
        if cap is not None and idx.shape[0] > cap:
            idx, vals = idx[:cap], vals[:cap]
        return cls.from_arrays(idx, vals, tuple(arr.shape), cap=cap,
                               check=False)

    # ------------------------------------------------------------------
    # Padding / capacity management
    # ------------------------------------------------------------------
    def repad(self) -> "SparseCOO":
        """Force padding entries to the canonical sentinel/zero form."""
        mask = self.valid_mask()
        sent = self.sentinel_index(self.shape, self.index_dtype, self.device)
        indices = torch.where(mask[:, None], self.indices, sent)
        vals = torch.where(mask, self.vals,
                           torch.zeros((), dtype=self.dtype,
                                       device=self.device))
        return dataclasses.replace(self, indices=indices, vals=vals)

    def with_capacity(self, cap: int) -> "SparseCOO":
        """Grow or shrink the capacity (padding added/removed at the end).
        Shrinking below ``nnz`` raises."""
        cap = max(int(cap), 1)
        cur = self.cap
        if cap == cur:
            return self
        if cap > cur:
            sent = self.sentinel_index(self.shape, self.index_dtype,
                                       self.device)
            pad_idx = sent.expand(cap - cur, self.rank)
            indices = torch.cat([self.indices, pad_idx], dim=0)
            vals = torch.cat([self.vals, torch.zeros(
                (cap - cur,), dtype=self.dtype, device=self.device)])
            return dataclasses.replace(self, indices=indices, vals=vals)
        if cap < self.nnz:
            raise SpSparseError(
                f"with_capacity({cap}) would drop live entries "
                f"(nnz={self.nnz})")
        return dataclasses.replace(self, indices=self.indices[:cap],
                                   vals=self.vals[:cap])

    def compact(self) -> "SparseCOO":
        """Trim capacity to ``nnz`` (at least 1)."""
        return self.with_capacity(self.nnz)

    # ------------------------------------------------------------------
    # Element access (mirrors the reference accessors)
    # ------------------------------------------------------------------
    def index(self, dim: int, i: int | None = None):
        """``index(dim, i)`` scalar or ``index(dim)`` full column."""
        col = self.indices[:, dim]
        return col if i is None else col[i]

    def val(self, i: int):
        return self.vals[i]

    def index_tuple(self, i: int) -> tuple:
        return tuple(self.indices[i].tolist())

    def to_lists(self) -> tuple[list, list]:
        """Host-side ``([(i0,..),...], [v,...])`` of live entries."""
        idx = self.indices[: self.nnz].cpu().numpy()
        vals = self.vals[: self.nnz].cpu()
        vals = (vals.float() if vals.dtype == torch.bfloat16 else vals).numpy()
        return [tuple(row) for row in idx.tolist()], vals.tolist()

    # ------------------------------------------------------------------
    # Dense conversion
    # ------------------------------------------------------------------
    def to_dense(self) -> Tensor:
        """COO → dense by scatter-add of the live entries (duplicates sum)."""
        dense = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        live = self.indices[: self.nnz].long()
        dense.index_put_(tuple(live[:, k] for k in range(self.rank)),
                         self.vals[: self.nnz], accumulate=True)
        return dense

    # ------------------------------------------------------------------
    # Algorithms (functional forms of the reference's member algorithms)
    # ------------------------------------------------------------------
    def consolidate(self, sort_order: Sequence[int] | None = None,
                    duplicate_policy: DuplicatePolicy = DuplicatePolicy.ADD,
                    zero_nan: bool = False, *, cap: int | None = None,
                    force: bool = False) -> "SparseCOO":
        """Sort + merge duplicates + drop structural zeros; a no-op when
        ``sort_order`` already matches (unless ``force``). See
        :func:`spsparse_torch.core.consolidate.consolidate`."""
        from .consolidate import consolidate as _consolidate
        if sort_order is None:
            sort_order = tuple(range(self.rank))
        sort_order = tuple(sort_order)
        if not force and self.sort_order == sort_order:
            return self if cap is None else self.with_capacity(cap)
        return _consolidate(self, sort_order, duplicate_policy, zero_nan,
                            cap=cap)

    def transposed(self, perm: Sequence[int]) -> "SparseCOO":
        """Permute dimensions: ``ret.dim[i] == self.dim[perm[i]]``.

        Shape is permuted and sortedness metadata is relabelled (the entry
        order never changes), as in the JAX package.
        """
        perm = tuple(int(p) for p in perm)
        indices = self.indices[:, list(perm)]
        shape = tuple(self.shape[p] for p in perm)
        new_order = (tuple(perm.index(d) for d in self.sort_order)
                     if self.sort_order is not None else None)
        return SparseCOO(indices=indices, vals=self.vals, nnz=self.nnz,
                         shape=shape, sort_order=new_order)

    @property
    def T(self) -> "SparseCOO":
        """Rank-2 transpose sugar: ``A.T == A.transposed((1, 0))``."""
        if self.rank != 2:
            raise SpSparseError(".T requires a rank-2 array; use "
                                "transposed(perm)")
        return self.transposed((1, 0))

    def __matmul__(self, other):
        """``A @ B``: the sparse-sparse product (the ESC multiply,
        :func:`spsparse_torch.ops.spgemm`) for another :class:`SparseCOO`;
        sparse-dense SpMV/SpMM through the CSR view for a dense operand."""
        if isinstance(other, SparseCOO):
            from ..ops.spgemm import spgemm

            return spgemm(self, other)
        from ..ops.spmm import spmm, spmv
        from .structure import to_csr

        other = operand_tensor(other, self.device)
        csr = to_csr(self)
        return spmv(csr, other) if other.ndim == 1 else spmm(csr, other)

    def transpose_indices_only(self, perm: Sequence[int]) -> "SparseCOO":
        """Reference-quirk transpose: permutes each index tuple but *not*
        ``shape``; sortedness is cleared."""
        perm = tuple(int(p) for p in perm)
        return dataclasses.replace(self, indices=self.indices[:, list(perm)],
                                   sort_order=None)

    def dim_beginnings(self):
        """Present-rows CSR pointers with end sentinel; requires sorted."""
        from .structure import dim_beginnings as _dim_beginnings
        return _dim_beginnings(self)

    def copy(self) -> "SparseCOO":
        """Value copy (fresh buffers)."""
        return dataclasses.replace(self, indices=self.indices.clone(),
                                   vals=self.vals.clone())

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"SparseCOO(shape={self.shape}, nnz={self.nnz}, "
                f"cap={self.cap}, dtype={self.dtype}, device={self.device}, "
                f"sort_order={self.sort_order})")

    def __str__(self) -> str:
        idx, vals = self.to_lists()
        entries = ", ".join(f"({','.join(map(str, i))}: {v:g})"
                            for i, v in zip(idx, vals))
        return f"SparseCOO{list(self.shape)}[{entries}]"


# ----------------------------------------------------------------------
# Host-side incremental builder (reference edit-mode add() protocol)
# ----------------------------------------------------------------------
class CooBuilder:
    """Incremental host-side builder mirroring the reference's edit mode.

    Entries accumulate in amortised-O(1) numpy buffers with vectorised
    bounds checks; ``build(device=...)`` produces a :class:`SparseCOO` on
    the requested device, the card by default.
    """

    def __init__(self, shape: Sequence[int], dtype=np.float32,
                 index_dtype=None):
        self.shape = tuple(int(s) for s in shape)
        self.rank = len(self.shape)
        index_dtype = numpy_dtype(index_dtype
                                  or default_index_dtype(self.shape))
        self._cap = 16
        self._n = 0
        self._idx = np.empty((self._cap, self.rank), dtype=index_dtype)
        self._vals = np.empty((self._cap,), dtype=numpy_dtype(dtype))
        self.dtype = dtype

    def __len__(self) -> int:
        return self._n

    def reserve(self, n: int) -> None:
        if n > self._cap:
            self._idx = np.resize(self._idx, (n, self.rank))
            self._vals = np.resize(self._vals, (n,))
            self._cap = n

    def clear(self) -> None:
        self._n = 0

    def _check(self, indices: np.ndarray) -> None:
        ext = np.asarray(self.shape, indices.dtype)
        bad = ((indices < 0) | (indices >= ext)).any(axis=1)
        if bad.any():
            first = int(np.argmax(bad))
            spsparse_error(
                -1, "Sparse index out of bounds: index=%s vs. shape=%s",
                tuple(indices[first].tolist()), self.shape)

    def add(self, index: Sequence[int], val) -> None:
        """Append one entry, bounds-checked like the reference."""
        index = np.asarray(index, dtype=np.int64).reshape(1, self.rank)
        self._check(index)
        if self._n == self._cap:
            self.reserve(max(16, self._cap * 2))
        self._idx[self._n] = index[0]
        self._vals[self._n] = val
        self._n += 1

    def add_many(self, indices, vals) -> None:
        """Vectorised bulk append with a single bounds check."""
        indices = np.asarray(indices)
        if indices.ndim == 1:
            indices = indices[:, None]
        vals = np.asarray(vals, dtype=self._vals.dtype)
        m = indices.shape[0]
        if m != vals.shape[0]:
            raise SpSparseError("add_many: indices/vals length mismatch")
        if m:
            self._check(indices)
        if self._n + m > self._cap:
            self.reserve(max(self._n + m, self._cap * 2))
        self._idx[self._n:self._n + m] = indices
        self._vals[self._n:self._n + m] = vals
        self._n += m

    def build(self, cap: int | None = None, *,
              device: DeviceLike = None) -> SparseCOO:
        return SparseCOO.from_arrays(
            torch.from_numpy(self._idx[: self._n].copy()),
            torch.from_numpy(self._vals[: self._n].copy()),
            self.shape, cap=cap, check=False, device=resolve_device(device))


def coo_matrix(shape: Sequence[int], dtype=np.float32) -> CooBuilder:
    """Builder for a rank-2 array (reference ``VectorCooMatrix``)."""
    if len(shape) != 2:
        raise SpSparseError(f"coo_matrix needs a rank-2 shape; got {shape}")
    return CooBuilder(shape, dtype)


def coo_vector(shape_or_len, dtype=np.float32) -> CooBuilder:
    """Builder for a rank-1 array (reference ``VectorCooVector``)."""
    if isinstance(shape_or_len, int):
        shape_or_len = (shape_or_len,)
    if len(shape_or_len) != 1:
        raise SpSparseError(
            f"coo_vector needs a rank-1 shape; got {shape_or_len}")
    return CooBuilder(shape_or_len, dtype)

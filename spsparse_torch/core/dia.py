"""DIA (diagonal) storage for banded matrices.

PyTorch counterpart of :mod:`spsparse_tpu.core.dia`. ``data[d, i]`` holds
``A[i, i + offsets[d]]`` (row-oriented DIA), zero where the column is out of
range; ``offsets`` is a tuple of ints.

:func:`to_dia` accumulates all entries with one vectorised
``index_put_(..., accumulate=True)``. The JAX version loops over the entries
in Python, which takes minutes at ten million entries.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .coo import SparseCOO

__all__ = ["SparseDIA", "to_dia", "dia_to_coo"]

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SparseDIA:
    """Diagonal storage: ``data (ndiag, nrows)``, ``offsets`` tuple."""

    data: Tensor
    offsets: tuple
    shape: tuple

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nnz_stored(self) -> int:
        """Stored in-band slots (explicit zeros included)."""
        return sum(max(0, min(self.nrows, self.ncols - off) - max(0, -off))
                   for off in self.offsets)

    def _band(self):
        """``(d, i, j)`` of every in-band slot, diagonal by diagonal."""
        offs = torch.tensor(self.offsets, dtype=torch.int64,
                            device=self.device)
        rows = torch.arange(self.nrows, device=self.device)
        cols = rows[None, :] + offs[:, None]
        ok = (cols >= 0) & (cols < self.ncols)
        d, i = torch.nonzero(ok, as_tuple=True)
        return d, i, cols[d, i]

    def to_dense(self) -> Tensor:
        out = torch.zeros(self.shape, dtype=self.data.dtype,
                          device=self.device)
        d, i, j = self._band()
        return out.index_put_((i, j), self.data[d, i], accumulate=True)


def dia_to_coo(dia: SparseDIA) -> SparseCOO:
    """DIA → COO: the in-band slots with nonzero values, diagonal by
    diagonal (the JAX package's entry order)."""
    d, i, j = dia._band()
    vals = dia.data[d, i]
    nz = vals != 0
    idx = torch.stack([i[nz], j[nz]], dim=1).to(torch.int32)
    return SparseCOO.from_arrays(idx, vals[nz], dia.shape, check=False)


def to_dia(a: SparseCOO, offsets: Sequence[int] | None = None) -> SparseDIA:
    """COO → DIA. ``offsets`` defaults to every diagonal holding at least
    one live entry; an entry off the listed diagonals raises
    ``ValueError``. Duplicates sum."""
    idx = a.indices[: a.nnz].long()
    vals = a.vals[: a.nnz]
    offs = idx[:, 1] - idx[:, 0]
    if offsets is None:
        offsets = tuple(int(o) for o in torch.unique(offs).tolist())
    offsets = tuple(int(o) for o in offsets)
    # Diagonal slot of every entry: binary search in the sorted offsets.
    table = torch.tensor(offsets, dtype=torch.int64, device=a.device)
    sorter = torch.argsort(table)
    slot = torch.searchsorted(table[sorter], offs).clamp_max(
        max(len(offsets) - 1, 0))
    pos = sorter[slot] if offsets else slot
    off_band = (table[pos] != offs) if offsets else torch.ones_like(
        offs, dtype=torch.bool)
    if bool(off_band.any()):
        i, j = idx[torch.nonzero(off_band)[0, 0]].tolist()
        raise ValueError(f"entry ({i},{j}) not on a listed diagonal")
    data = torch.zeros((len(offsets), a.shape[0]), dtype=a.dtype,
                       device=a.device)
    data.index_put_((pos, idx[:, 0]), vals, accumulate=True)
    return SparseDIA(data=data, offsets=offsets, shape=a.shape)

"""NetCDF round-trip I/O for sparse arrays — reference-compatible schema.

Counterpart of :mod:`spsparse_tpu.io.netcdf`, on the exact on-file schema of
the reference's NetCDF layer (``netcdf.hpp:86-138``): per array ``vname``

* dims  ``vname.size`` (= nnz) and ``vname.rank``;
* var   ``vname.indices``: int64 ``[size, rank]``;
* var   ``vname.vals``:    double ``[size]``;
* var   ``vname.info``:    int64 scalar carrying a ``shape`` attribute of
  ``rank`` uint64 values.

Files are classic NetCDF (CDF-1/2/5, CDF-5 by default) through the in-tree
codec :mod:`spsparse_torch.io.cdf`, or NetCDF-4/HDF5 (``version=4``)
through :mod:`spsparse_torch.io.nc4`, which needs ``h5py``; reads detect
the container. Files written by either package load in the other.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.coo import SparseCOO, default_index_dtype, numpy_dtype
from ..core.errors import spsparse_error
from .cdf import NcAttr, NcFile, read_cdf, write_cdf
from .nc4 import is_hdf5, read_nc4, write_nc4

__all__ = ["save_netcdf", "load_netcdf", "NcIO", "ncio_spsparse", "is_hdf5"]


def _read_any(path) -> NcFile:
    """Dispatch on the container: HDF5/NetCDF-4 or classic CDF."""
    return read_nc4(path) if is_hdf5(path) else read_cdf(path)


def _write_any(path, nc: NcFile) -> None:
    if nc.version == 4:
        write_nc4(path, nc)
    else:
        write_cdf(path, nc)


def _write_array(nc: NcFile, A: SparseCOO, vname: str) -> None:
    n, rank = A.nnz, A.rank
    idx = A.indices[:n].cpu().numpy().astype(np.int64).reshape(n, rank)
    vals = A.vals[:n].cpu().double().numpy()
    d_size = nc.add_dim(f"{vname}.size", n)
    d_rank = nc.add_dim(f"{vname}.rank", rank)
    info = nc.add_var(f"{vname}.info", [], np.zeros((), np.int64))
    info.attrs.append(NcAttr("shape", np.asarray(A.shape, np.uint64)))
    nc.add_var(f"{vname}.indices", [d_size, d_rank], idx)
    nc.add_var(f"{vname}.vals", [d_size], vals)


def _read_array(nc: NcFile, vname: str, *, rank: int | None = None,
                shape: Sequence[int] | None = None, alloc: bool = True,
                dtype=np.float64, cap: int | None = None,
                device=None) -> SparseCOO:
    info = nc.var(f"{vname}.info")
    shape_attr = None
    for a in info.attrs:
        if a.name == "shape":
            shape_attr = np.asarray(a.values, np.int64)
    if shape_attr is None:
        spsparse_error(-1, "NetCDF sparse array %s has no shape attribute",
                       vname)
    file_rank = len(shape_attr)
    if rank is not None and file_rank != rank:
        spsparse_error(
            -1,
            "Trying to read NetCDF sparse array of rank %d into SpSparse "
            "array of rank %d", file_rank, rank)
    if alloc or shape is None:
        shape = tuple(int(s) for s in shape_attr)
    else:
        shape = tuple(int(s) for s in shape)
    idx = np.asarray(nc.var(f"{vname}.indices").data, np.int64)
    vals = np.asarray(nc.var(f"{vname}.vals").data, numpy_dtype(dtype))
    idx = idx.reshape(-1, file_rank).astype(
        numpy_dtype(default_index_dtype(shape)))
    return SparseCOO.from_arrays(idx, vals, shape, cap=cap, device=device)


def save_netcdf(path, arrays: dict[str, SparseCOO], *,
                version: int = 5) -> None:
    """Write named sparse arrays to ``path`` in the reference schema
    (``version`` 1/2/5 = classic CDF, 4 = NetCDF-4/HDF5 through h5py)."""
    nc = NcFile(version=version)
    for vname, A in arrays.items():
        _write_array(nc, A, vname)
    _write_any(path, nc)


def load_netcdf(path, vname: str, *, rank: int | None = None,
                shape: Sequence[int] | None = None, alloc: bool = True,
                dtype=np.float64, cap: int | None = None,
                device=None) -> SparseCOO:
    """Read one sparse array written by :func:`save_netcdf`, by the JAX
    package, or by the reference library, classic or NetCDF-4, onto
    ``device`` (the card by default)."""
    return _read_array(_read_any(path), vname, rank=rank, shape=shape,
                       alloc=alloc, dtype=dtype, cap=cap, device=device)


class NcIO:
    """Deferred-action NetCDF session mirroring the reference's ``NcIO``.

    Usage (write)::

        with NcIO(path, 'w') as ncio:
            ncio_spsparse(ncio, A, False, 'A')

    Usage (read)::

        ncio = NcIO(path, 'r')
        out = ncio_spsparse(ncio, None, True, 'A', rank=2)
        ncio.flush()
        A = out['A']
    """

    def __init__(self, path, rw: str, *, device=None):
        if rw not in ("r", "w"):
            raise ValueError(f"NcIO mode must be 'r' or 'w', got {rw!r}")
        self.path = path
        self.rw = rw
        self.device = device
        self.nc = _read_any(path) if rw == "r" else NcFile(version=5)
        self._actions: list = []
        self.results: dict[str, SparseCOO] = {}

    def __iadd__(self, action):
        self._actions.append(action)
        return self

    def flush(self):
        for act in self._actions:
            act()
        self._actions.clear()
        if self.rw == "w":
            _write_any(self.path, self.nc)
        return self.results

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.flush()
        return False


def ncio_spsparse(ncio: NcIO, A: SparseCOO | None, alloc: bool, vname: str,
                  *, rank: int | None = None, dtype=np.float64,
                  cap: int | None = None):
    """Reference-parity entry point: queue a write of ``A``, or a read into
    ``ncio.results[vname]`` (on ``ncio.device``, the card by default)."""
    if ncio.rw == "w":
        ncio += (lambda: _write_array(ncio.nc, A, vname))
        return None
    if rank is None and A is not None:
        rank = A.rank
    shape = A.shape if (A is not None and not alloc) else None

    def _do_read():
        ncio.results[vname] = _read_array(
            ncio.nc, vname, rank=rank, shape=shape, alloc=alloc,
            dtype=dtype, cap=cap, device=ncio.device)

    ncio += _do_read
    return ncio.results

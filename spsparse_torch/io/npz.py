"""scipy.sparse ``.npz`` files — ``save_npz`` / ``load_npz``.

Counterpart of :mod:`spsparse_tpu.io.npz`. Writes and reads the container
``scipy.sparse.save_npz`` uses (a numpy ``.npz`` zip with
``format``/``shape``/``data`` members plus ``row``+``col`` for COO or
``indices``+``indptr`` for CSR/CSC), so files round-trip against scipy and
the JAX package in both directions. Rank 2 only, like scipy; NetCDF
(:mod:`spsparse_torch.io.netcdf`) remains the rank-N format. No scipy
import needed: the container is plain ``numpy.savez``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.coo import SparseCOO
from ..core.errors import SpSparseError

__all__ = ["save_npz", "load_npz"]


def save_npz(path, a: SparseCOO, *, compressed: bool = True) -> None:
    """Write a rank-2 array in scipy's COO ``.npz`` layout
    (scipy.sparse.load_npz reads the result directly). Only live entries
    are written; bfloat16 values are written as float32."""
    if a.rank != 2:
        raise SpSparseError(
            f"save_npz is rank-2 only (scipy's restriction); got rank "
            f"{a.rank} — use io.netcdf for rank-N arrays")
    n = int(a.nnz)
    idx = a.indices[:n].cpu().numpy()
    vals = a.vals[:n].cpu()
    if vals.dtype == torch.bfloat16:
        vals = vals.float()
    fields = dict(
        format=np.bytes_(b"coo"),
        shape=np.asarray(a.shape, np.int64),
        row=idx[:, 0],
        col=idx[:, 1],
        data=vals.numpy(),
    )
    (np.savez_compressed if compressed else np.savez)(path, **fields)


def load_npz(path, *, device=None) -> SparseCOO:
    """Read a scipy ``.npz`` sparse file (coo, csr or csc) into a
    :class:`SparseCOO` on ``device`` (the card by default). CSR/CSC
    pointers are expanded with ``np.repeat`` on the host; entry order —
    and hence scipy's canonical sortedness — is kept, but sort metadata is
    left unset (consolidate to claim it)."""
    with np.load(path) as z:
        try:
            # scipy accepts both bytes and str `format` members on load;
            # third-party writers may store either
            f = np.asarray(z["format"]).item()
            fmt = f.decode() if isinstance(f, bytes) else str(f)
            shape = tuple(int(s) for s in z["shape"])
            data = z["data"]
            if fmt == "coo":
                rows, cols = z["row"], z["col"]
            elif fmt in ("csr", "csc"):
                ptr, minor = z["indptr"], z["indices"]
                major = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
                rows, cols = (major, minor) if fmt == "csr" \
                    else (minor, major)
            else:
                raise SpSparseError(
                    f"load_npz: unsupported sparse format {fmt!r} "
                    f"(coo/csr/csc)")
        except KeyError as e:
            raise SpSparseError(
                f"load_npz: {path} is not a scipy sparse .npz "
                f"(missing member {e})") from e
    return SparseCOO.from_arrays(
        np.stack([np.asarray(rows), np.asarray(cols)], axis=1),
        np.asarray(data), shape, device=device)

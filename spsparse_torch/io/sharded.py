"""Sharded NetCDF checkpoints of row-partitioned matrices.

Counterpart of :mod:`spsparse_tpu.io.sharded`. Each partition's local
block is one reference-schema NetCDF file (readable alone by
:func:`~spsparse_torch.io.load_netcdf`, by the JAX package and by the
reference library), and a small JSON manifest (version 1) ties the shards
together. Writes go a partition at a time, so each rank of a process
group can write only its own partitions (``parts=``).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..core.coo import SparseCOO, round_up_pow2
from ..core.errors import SpSparseError
from ..dist.partition import RowPartitionedCSR, to_device
from .netcdf import load_netcdf, save_netcdf

__all__ = ["save_netcdf_sharded", "load_netcdf_sharded"]

_MANIFEST_VERSION = 1


def _shard_path(prefix: str, p: int) -> str:
    return f"{prefix}.part{p:05d}.nc"


def save_netcdf_sharded(prefix: str, part: RowPartitionedCSR,
                        vname: str = "A", *, parts=None) -> None:
    """Write one reference-schema NetCDF file per partition plus the
    manifest ``prefix.manifest.json``.

    ``parts`` restricts the partitions this process writes (each rank its
    own; every rank may write the manifest, whose contents are the
    same). By default it is every partition ``part`` holds: all of them,
    or a rank's own when ``mesh.shard_layout`` made ``part``."""
    n_parts = part.n_parts
    parts = part.parts if parts is None else parts
    manifest = {
        "version": _MANIFEST_VERSION,
        "vname": vname,
        "n_parts": n_parts,
        "shape": list(part.shape),
        "rows_local": part.rows_local,
        "shards": [os.path.basename(_shard_path(prefix, p))
                   for p in range(n_parts)],
    }
    with open(f"{prefix}.manifest.json", "w") as f:
        json.dump(manifest, f, indent=1)
    for p in parts:
        block = part.local_block(p)  # local rows, global cols
        save_netcdf(_shard_path(prefix, p), {vname: block.to_coo()})


def _row_major(idx: np.ndarray, ncols: int) -> np.ndarray:
    """``np.lexsort((idx[:, 1], idx[:, 0]))`` as one stable argsort of the
    packed key; ``idx`` is int64, and int32 rows and columns fit)."""
    return np.argsort(idx[:, 0] * (ncols + 1) + idx[:, 1], kind="stable")


def load_netcdf_sharded(prefix: str, *, parts=None,
                        cap_local: int | None = None,
                        device=None) -> RowPartitionedCSR:
    """Load a sharded checkpoint into a :class:`RowPartitionedCSR` on
    ``device`` (the card by default); values are float64, as the JAX
    package loads them.

    ``parts`` loads a subset (the other partitions stay empty) for a
    rank's own restore."""
    with open(f"{prefix}.manifest.json") as f:
        manifest = json.load(f)
    if manifest.get("version") != _MANIFEST_VERSION:
        raise SpSparseError(
            f"unsupported sharded-checkpoint manifest version "
            f"{manifest.get('version')}")
    vname = manifest["vname"]
    n_parts = manifest["n_parts"]
    rows_local = manifest["rows_local"]
    shape = tuple(manifest["shape"])
    parts = range(n_parts) if parts is None else parts

    blocks: dict[int, SparseCOO] = {}
    max_nnz = 1
    for p in parts:
        coo = load_netcdf(_shard_path(prefix, p), vname, rank=2,
                          device="cpu")
        blocks[p] = coo
        max_nnz = max(max_nnz, int(coo.nnz))
    if cap_local is None:
        cap_local = round_up_pow2(max(max_nnz, 1))

    ncols = shape[1]
    row_ptr = np.zeros((n_parts, rows_local + 1), np.int32)
    cols = np.full((n_parts, cap_local), ncols, np.int32)
    vals = np.zeros((n_parts, cap_local), np.float64)
    nnz = np.zeros((n_parts,), np.int32)
    for p, coo in blocks.items():
        n = int(coo.nnz)
        if n > cap_local:
            raise SpSparseError(
                f"shard {p} nnz {n} exceeds cap_local {cap_local}")
        idx = coo.indices[:n].long().numpy()
        v = coo.vals[:n].numpy()
        order = _row_major(idx, ncols)
        idx, v = idx[order], v[order]
        row_ptr[p] = np.searchsorted(idx[:, 0], np.arange(rows_local + 1))
        cols[p, :n] = idx[:, 1]
        vals[p, :n] = v
        nnz[p] = n
    return RowPartitionedCSR(
        **to_device(device, dict(row_ptr=row_ptr, cols=cols, vals=vals,
                                 nnz=nnz)), shape=shape)

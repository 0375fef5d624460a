"""NetCDF-4 (HDF5-based) container support via h5py.

Counterpart of :mod:`spsparse_tpu.io.nc4`. The classic-format codec
(:mod:`spsparse_torch.io.cdf`) covers CDF-1/2/5 files. NetCDF-4 files are
HDF5 files that follow the netCDF-4 conventions (dimension scales,
``_Netcdf4Dimid`` attributes, variables attached to dimension scales).
This module reads and writes that flavour with h5py, to and from the same
in-memory :class:`~spsparse_torch.io.cdf.NcFile` model, so the spsparse
schema layer works over either container unchanged; files written by
either package load in the other.

Only the subset the spsparse schema needs is implemented: root-group
dimensions, attributes, and non-record variables. ``h5py`` is imported
when a NetCDF-4 file is read or written, never at module load.
"""

from __future__ import annotations

import numpy as np

from .cdf import NcAttr, NcFile, NcVar, _nc_type_for

__all__ = ["read_nc4", "write_nc4", "is_hdf5"]

_MAGIC_HDF5 = b"\x89HDF\r\n\x1a\n"


def is_hdf5(path) -> bool:
    """True if ``path`` holds an HDF5 superblock. It may sit at offset 0 or
    at 512, 1024, 2048, ... (user-block files), as ``h5py.is_hdf5``
    scans."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        size = f.tell()
        off = 0
        while off < size:
            f.seek(off)
            if f.read(8) == _MAGIC_HDF5:
                return True
            off = 512 if off == 0 else off * 2
    return False


def _h5py():
    try:
        import h5py
        return h5py
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "NetCDF-4 (HDF5) container support requires h5py") from e


def read_nc4(path) -> NcFile:
    """Parse a NetCDF-4/HDF5 file (root group) into an :class:`NcFile`."""
    h5py = _h5py()
    out = NcFile(version=4)
    with h5py.File(path, "r") as f:
        # Dimensions = datasets marked as dimension scales.
        dim_order = []
        for name, ds in f.items():
            if not isinstance(ds, h5py.Dataset):
                continue
            if ds.attrs.get("CLASS", b"") == b"DIMENSION_SCALE":
                dimid = int(ds.attrs.get("_Netcdf4Dimid", len(dim_order)))
                dim_order.append((dimid, name, ds.shape[0]))
        dim_order.sort()
        name_to_id = {}
        for dimid, name, size in dim_order:
            name_to_id[name] = out.add_dim(name, size)

        for aname, aval in f.attrs.items():
            if aname.startswith("_NCProperties"):
                continue
            out.gattrs.append(_attr_from_h5(aname, aval))

        for name, ds in f.items():
            if not isinstance(ds, h5py.Dataset):
                continue
            is_scale = ds.attrs.get("CLASS", b"") == b"DIMENSION_SCALE"
            # A pure dimension scale with no data of interest ("This is a
            # netCDF dimension but not a netCDF variable").
            nc_name = ds.attrs.get("NAME", b"")
            if is_scale and nc_name.startswith(b"This is a netCDF dimension"):
                continue
            dimids = []
            if "DIMENSION_LIST" in ds.attrs:
                for reflist in ds.attrs["DIMENSION_LIST"]:
                    ref = reflist[0]
                    dimids.append(name_to_id[f[ref].name.lstrip("/")])
            elif is_scale:
                dimids = [name_to_id[name]]
            data = np.asarray(ds[()])
            attrs = [_attr_from_h5(a, v) for a, v in ds.attrs.items()
                     if a not in ("CLASS", "NAME", "DIMENSION_LIST",
                                  "_Netcdf4Dimid", "_Netcdf4Coordinates",
                                  "REFERENCE_LIST")]
            out.vars.append(NcVar(name, dimids, _nc_type_for(data.dtype),
                                  attrs, data))
    return out


def _attr_from_h5(name, val) -> NcAttr:
    if isinstance(val, bytes):
        return NcAttr(name, val)
    if isinstance(val, str):
        return NcAttr(name, val.encode())
    arr = np.asarray(val)
    if arr.dtype.kind in ("S", "U", "O"):
        return NcAttr(name, np.asarray(val).astype(bytes).tobytes())
    return NcAttr(name, arr)


def write_nc4(path, nc: NcFile) -> None:
    """Write an :class:`NcFile` as a NetCDF-4-flavored HDF5 file."""
    h5py = _h5py()
    with h5py.File(path, "w") as f:
        scales = []
        for i, d in enumerate(nc.dims):
            # A dimension without a same-named variable gets a stub scale.
            has_var = nc.has_var(d.name)
            if not has_var:
                ds = f.create_dataset(d.name, shape=(d.size,),
                                      dtype=np.float32)
                stub = (b"This is a netCDF dimension but not a netCDF "
                        b"variable. %10d" % d.size)
            else:
                var = nc.var(d.name)
                ds = f.create_dataset(d.name, data=np.asarray(var.data))
                stub = None
            ds.attrs["CLASS"] = np.bytes_(b"DIMENSION_SCALE")
            ds.attrs["_Netcdf4Dimid"] = np.int32(i)
            ds.make_scale(d.name)
            if stub is not None:
                # AFTER make_scale — it overwrites NAME with the scale
                # name, which used to erase the stub marker and make
                # readers surface phantom float32 variables for pure
                # dimensions.
                ds.attrs["NAME"] = np.bytes_(stub)
            scales.append(ds)
        for a in nc.gattrs:
            _write_attr(f, a)
        for var in nc.vars:
            if any(d.name == var.name for d in nc.dims):
                ds = f[var.name]
            else:
                ds = f.create_dataset(var.name, data=np.asarray(var.data))
                for k, dimid in enumerate(var.dimids):
                    ds.dims[k].attach_scale(scales[dimid])
            for a in var.attrs:
                _write_attr(ds, a)


def _write_attr(obj, a: NcAttr) -> None:
    if isinstance(a.values, (bytes, str)):
        val = a.values if isinstance(a.values, bytes) else a.values.encode()
        obj.attrs[a.name] = np.bytes_(val)
    else:
        obj.attrs[a.name] = np.asarray(a.values)

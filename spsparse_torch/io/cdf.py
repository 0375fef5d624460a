"""Self-contained NetCDF classic-format container codec (CDF-1/2/5).

A copy of :mod:`spsparse_tpu.io.cdf`, which imports only the standard
library and numpy. The reference serializes arrays with the netCDF-C
library (``slib/spsparse/netcdf.hpp``); this module implements the on-disk *classic NetCDF
format* directly — CDF-1 (``CDF\\x01``), CDF-2 / 64-bit-offset
(``CDF\\x02``), and CDF-5 / 64-bit-data (``CDF\\x05``) — following the
public file-format specification. CDF-5 is required because the spsparse
schema stores ``int64`` index variables and ``uint64`` shape attributes
(reference ``netcdf.hpp:102-106``), which predate-CDF-5 variants cannot
represent.

Scope: non-record variables only (the spsparse schema has none), all
reads/writes bulk-vectorized via numpy (the reference's one-element-per-call
putVar/getVar loop, ``netcdf.hpp:34-42,65-75``, is exactly the kind of
pathology a bulk codec removes).

Everything is big-endian per the format. Layout summary::

    header  = magic numrecs dim_list gatt_list var_list
    dim     = name length
    attr    = name nc_type nelems values(padded to 4)
    var     = name ndims dimids vatt_list nc_type vsize begin
    data    = per-variable contiguous blocks at 'begin' offsets

In CDF-5 every count (``NON_NEG``) widens to int64 and ``begin`` is int64;
in CDF-2 only ``begin`` widens; CDF-1 is all 32-bit.
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import Any, BinaryIO

import numpy as np

__all__ = ["NcDim", "NcAttr", "NcVar", "NcFile", "read_cdf", "write_cdf",
           "NC_TYPES"]

_MAGIC = b"CDF"

_ABSENT = 0
_NC_DIMENSION = 0x0A
_NC_VARIABLE = 0x0B
_NC_ATTRIBUTE = 0x0C

# nc_type -> (numpy dtype (big-endian), size in bytes)
NC_TYPES = {
    1: np.dtype(">i1"),    # NC_BYTE
    2: np.dtype("S1"),     # NC_CHAR
    3: np.dtype(">i2"),    # NC_SHORT
    4: np.dtype(">i4"),    # NC_INT
    5: np.dtype(">f4"),    # NC_FLOAT
    6: np.dtype(">f8"),    # NC_DOUBLE
    7: np.dtype(">u1"),    # NC_UBYTE   (CDF-5)
    8: np.dtype(">u2"),    # NC_USHORT  (CDF-5)
    9: np.dtype(">u4"),    # NC_UINT    (CDF-5)
    10: np.dtype(">i8"),   # NC_INT64   (CDF-5)
    11: np.dtype(">u8"),   # NC_UINT64  (CDF-5)
}
_DTYPE_TO_NC = {
    np.dtype("i1"): 1, np.dtype("S1"): 2, np.dtype("i2"): 3,
    np.dtype("i4"): 4, np.dtype("f4"): 5, np.dtype("f8"): 6,
    np.dtype("u1"): 7, np.dtype("u2"): 8, np.dtype("u4"): 9,
    np.dtype("i8"): 10, np.dtype("u8"): 11,
}


def _nc_type_for(dtype) -> int:
    dt = np.dtype(dtype).newbyteorder("=")
    if dt not in _DTYPE_TO_NC:
        raise ValueError(f"dtype {dtype} not representable in NetCDF classic")
    return _DTYPE_TO_NC[dt]


@dataclasses.dataclass
class NcDim:
    name: str
    size: int  # 0 = record dimension (unsupported for variables here)


@dataclasses.dataclass
class NcAttr:
    name: str
    values: np.ndarray | bytes  # bytes => NC_CHAR


@dataclasses.dataclass
class NcVar:
    name: str
    dimids: list[int]
    nc_type: int
    attrs: list[NcAttr]
    data: np.ndarray | None = None  # native-endian on read


@dataclasses.dataclass
class NcFile:
    """In-memory model of a classic NetCDF file."""

    dims: list[NcDim] = dataclasses.field(default_factory=list)
    gattrs: list[NcAttr] = dataclasses.field(default_factory=list)
    vars: list[NcVar] = dataclasses.field(default_factory=list)
    version: int = 5

    def dim(self, name: str) -> NcDim:
        for d in self.dims:
            if d.name == name:
                return d
        raise KeyError(name)

    def var(self, name: str) -> NcVar:
        for v in self.vars:
            if v.name == name:
                return v
        raise KeyError(name)

    def has_var(self, name: str) -> bool:
        return any(v.name == name for v in self.vars)

    def add_dim(self, name: str, size: int) -> int:
        for i, d in enumerate(self.dims):
            if d.name == name:
                if d.size != size:
                    raise ValueError(
                        f"dimension {name} exists with size {d.size} != {size}")
                return i
        self.dims.append(NcDim(name, int(size)))
        return len(self.dims) - 1

    def add_var(self, name: str, dimids: list[int], data: np.ndarray,
                attrs: list[NcAttr] | None = None, nc_type: int | None = None):
        data = np.asarray(data)
        v = NcVar(name=name, dimids=list(dimids),
                  nc_type=nc_type or _nc_type_for(data.dtype),
                  attrs=list(attrs or []), data=data)
        self.vars.append(v)
        return v


# ----------------------------------------------------------------------
# Reader
# ----------------------------------------------------------------------
class _Reader:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.version = 1

    def u4(self) -> int:
        return struct.unpack(">i", self.f.read(4))[0]

    def u8(self) -> int:
        return struct.unpack(">q", self.f.read(8))[0]

    def nonneg(self) -> int:
        return self.u8() if self.version == 5 else self.u4()

    def offset(self) -> int:
        return self.u8() if self.version >= 2 else self.u4()

    def name(self) -> str:
        n = self.nonneg()
        s = self.f.read(n)
        self.f.read((4 - n % 4) % 4)
        return s.decode("utf-8")

    def attr(self) -> NcAttr:
        name = self.name()
        nc_type = self.u4()
        n = self.nonneg()
        dt = NC_TYPES[nc_type]
        raw = self.f.read(dt.itemsize * n)
        self.f.read((4 - (dt.itemsize * n) % 4) % 4)
        if nc_type == 2:
            return NcAttr(name, raw)
        return NcAttr(name, np.frombuffer(raw, dt).astype(dt.newbyteorder("=")))

    def tagged_list(self, expected_tag):
        tag = self.u4()
        n = self.nonneg()
        if tag == _ABSENT and n == 0:
            return 0
        if tag != expected_tag:
            raise ValueError(f"bad tag {tag:#x}, expected {expected_tag:#x}")
        return n


def read_cdf(path_or_file) -> NcFile:
    """Parse a CDF-1/2/5 file into an :class:`NcFile` (data eagerly read)."""
    f = (open(path_or_file, "rb")
         if not hasattr(path_or_file, "read") else path_or_file)
    close = not hasattr(path_or_file, "read")
    try:
        magic = f.read(4)
        if (len(magic) < 4 or magic[:3] != _MAGIC
                or magic[3] not in (1, 2, 5)):
            raise ValueError(f"not a classic NetCDF file (magic={magic!r})")
        r = _Reader(f)
        r.version = magic[3]
        out = NcFile(version=r.version)
        numrecs = r.nonneg()
        ndims = r.tagged_list(_NC_DIMENSION)
        for _ in range(ndims):
            nm = r.name()
            out.dims.append(NcDim(nm, r.nonneg()))
        ngatt = r.tagged_list(_NC_ATTRIBUTE)
        for _ in range(ngatt):
            out.gattrs.append(r.attr())
        nvars = r.tagged_list(_NC_VARIABLE)
        metas = []
        for _ in range(nvars):
            nm = r.name()
            nd = r.nonneg()
            dimids = [r.nonneg() for _ in range(nd)]
            natt = r.tagged_list(_NC_ATTRIBUTE)
            attrs = [r.attr() for _ in range(natt)]
            nc_type = r.u4()
            _vsize = r.nonneg()
            begin = r.offset()
            metas.append((nm, dimids, attrs, nc_type, begin))
        # Classic-format record vars (a size-0 dim = THE record dimension)
        # are supported only at numrecs == 0 — the case the spsparse
        # schema produces for an EMPTY array. Nonzero-record files need
        # the interleaved record-section layout this codec does not
        # implement; refuse loudly rather than misparse.
        if numrecs not in (0, 0xFFFFFFFF) and any(
                d.size == 0 for d in out.dims):
            raise NotImplementedError(
                f"record variables with numrecs={numrecs} are not "
                "supported (only empty record dims, numrecs=0)")
        for nm, dimids, attrs, nc_type, begin in metas:
            shape = tuple(out.dims[d].size for d in dimids)
            dt = NC_TYPES[nc_type]
            count = int(np.prod(shape, dtype=np.int64)) if shape else 1
            f.seek(begin)
            raw = f.read(dt.itemsize * count)
            arr = np.frombuffer(raw, dt, count=count).reshape(shape)
            arr = arr.astype(dt.newbyteorder("="))
            out.vars.append(NcVar(nm, dimids, nc_type, attrs, arr))
        return out
    finally:
        if close:
            f.close()


# ----------------------------------------------------------------------
# Writer
# ----------------------------------------------------------------------
class _Writer:
    def __init__(self, f: BinaryIO, version: int):
        self.f = f
        self.version = version

    def u4(self, v: int):
        self.f.write(struct.pack(">i", v))

    def u8(self, v: int):
        self.f.write(struct.pack(">q", v))

    def nonneg(self, v: int):
        (self.u8 if self.version == 5 else self.u4)(v)

    def offset(self, v: int):
        (self.u8 if self.version >= 2 else self.u4)(v)

    def name(self, s: str):
        b = s.encode("utf-8")
        self.nonneg(len(b))
        self.f.write(b)
        self.f.write(b"\x00" * ((4 - len(b) % 4) % 4))

    def attr(self, a: NcAttr):
        self.name(a.name)
        if isinstance(a.values, (bytes, str)):
            raw = a.values.encode() if isinstance(a.values, str) else a.values
            self.u4(2)
            self.nonneg(len(raw))
            self.f.write(raw)
            self.f.write(b"\x00" * ((4 - len(raw) % 4) % 4))
        else:
            arr = np.asarray(a.values)
            nc_type = _nc_type_for(arr.dtype)
            be = arr.astype(NC_TYPES[nc_type])
            self.u4(nc_type)
            self.nonneg(be.size)
            raw = be.tobytes()
            self.f.write(raw)
            self.f.write(b"\x00" * ((4 - len(raw) % 4) % 4))


def _name_bytes(s: str, v: int) -> int:
    b = len(s.encode("utf-8"))
    return (8 if v == 5 else 4) + b + ((4 - b % 4) % 4)


def _attr_bytes(a: NcAttr, v: int) -> int:
    w = 8 if v == 5 else 4
    if isinstance(a.values, (bytes, str)):
        # Size by ENCODED bytes — str values with non-ASCII characters
        # have len(str) < len(utf-8 bytes), which used to desync the
        # computed header size from what _Writer.attr emits (silently
        # corrupt begin offsets under python -O).
        n = (len(a.values) if isinstance(a.values, bytes)
             else len(a.values.encode("utf-8")))
        item = 1
    else:
        arr = np.asarray(a.values)
        n = arr.size
        item = arr.dtype.itemsize
    raw = n * item
    return _name_bytes(a.name, v) + 4 + w + raw + ((4 - raw % 4) % 4)


def write_cdf(path_or_file, nc: NcFile) -> None:
    """Serialize an :class:`NcFile` (version from ``nc.version``)."""
    v = nc.version
    if v not in (1, 2, 5):
        raise ValueError(f"unsupported CDF version {v}")
    for var in nc.vars:
        if var.data is None:
            raise ValueError(f"variable {var.name} has no data")
        if var.nc_type in (7, 8, 9, 10, 11) and v != 5:
            raise ValueError(
                f"variable {var.name}: nc_type {var.nc_type} needs CDF-5")

    # Classic-format rule: a dimension of size 0 IS the (single) record
    # dimension. The spsparse schema hits this exactly when an array is
    # empty; we emit a correct 0-record file for that case (netCDF-C and
    # scipy read it back as zero records). Two empty arrays would need
    # two record dims — invalid classic; netCDF-4 has no such limit.
    rec_dims = [i for i, d in enumerate(nc.dims) if d.size == 0]
    if len(rec_dims) > 1:
        raise ValueError(
            "classic NetCDF allows a single record (size-0) dimension; "
            f"got {len(rec_dims)} — write with version=4 instead")
    rec_dim = rec_dims[0] if rec_dims else None
    for var in nc.vars:
        if rec_dim is not None and rec_dim in var.dimids[1:]:
            raise ValueError(
                f"variable {var.name}: the record dimension must be the "
                "first dimension (classic format)")

    w_nonneg = 8 if v == 5 else 4
    w_off = 8 if v >= 2 else 4

    # ---- compute header size to place variable data
    hdr = 4 + w_nonneg                       # magic + numrecs
    hdr += 4 + w_nonneg                      # dim_list tag+count
    for d in nc.dims:
        hdr += _name_bytes(d.name, v) + w_nonneg
    hdr += 4 + w_nonneg                      # gatt_list
    for a in nc.gattrs:
        hdr += _attr_bytes(a, v)
    hdr += 4 + w_nonneg                      # var_list
    for var in nc.vars:
        hdr += _name_bytes(var.name, v)
        hdr += w_nonneg + w_nonneg * len(var.dimids)
        hdr += 4 + w_nonneg                  # vatt_list
        for a in var.attrs:
            hdr += _attr_bytes(a, v)
        hdr += 4 + w_nonneg + w_off          # nc_type + vsize + begin

    begins, sizes, is_rec = [], [], []
    pos = hdr
    for var in nc.vars:                      # fixed variables first
        rec = rec_dim is not None and bool(var.dimids) \
            and var.dimids[0] == rec_dim
        is_rec.append(rec)
        if rec:
            begins.append(None)
            # vsize of a record var = bytes of ONE record (padded).
            dt = NC_TYPES[var.nc_type]
            per_rec = int(np.prod([nc.dims[d].size
                                   for d in var.dimids[1:]],
                                  dtype=np.int64))
            raw = per_rec * dt.itemsize
            sizes.append(raw + ((4 - raw % 4) % 4))
            continue
        dt = NC_TYPES[var.nc_type]
        count = int(np.prod([nc.dims[d].size for d in var.dimids],
                            dtype=np.int64)) if var.dimids else 1
        raw = count * dt.itemsize
        padded = raw + ((4 - raw % 4) % 4)
        begins.append(pos)
        sizes.append(padded)
        pos += padded
    # Record section begins after the fixed data; with numrecs = 0 it is
    # empty, but the begins must still be laid out interleaved.
    rec_pos = pos
    for k, var in enumerate(nc.vars):
        if is_rec[k]:
            begins[k] = rec_pos
            rec_pos += sizes[k]

    f = (open(path_or_file, "wb")
         if not hasattr(path_or_file, "write") else path_or_file)
    close = not hasattr(path_or_file, "write")
    try:
        w = _Writer(f, v)
        f.write(_MAGIC + bytes([v]))
        w.nonneg(0)  # numrecs
        if nc.dims:
            w.u4(_NC_DIMENSION)
            w.nonneg(len(nc.dims))
            for d in nc.dims:
                w.name(d.name)
                w.nonneg(d.size)
        else:
            w.u4(_ABSENT)
            w.nonneg(0)
        if nc.gattrs:
            w.u4(_NC_ATTRIBUTE)
            w.nonneg(len(nc.gattrs))
            for a in nc.gattrs:
                w.attr(a)
        else:
            w.u4(_ABSENT)
            w.nonneg(0)
        if nc.vars:
            w.u4(_NC_VARIABLE)
            w.nonneg(len(nc.vars))
            for var, begin, size in zip(nc.vars, begins, sizes):
                w.name(var.name)
                w.nonneg(len(var.dimids))
                for d in var.dimids:
                    w.nonneg(d)
                if var.attrs:
                    w.u4(_NC_ATTRIBUTE)
                    w.nonneg(len(var.attrs))
                    for a in var.attrs:
                        w.attr(a)
                else:
                    w.u4(_ABSENT)
                    w.nonneg(0)
                w.u4(var.nc_type)
                w.nonneg(size)
                w.offset(begin)
        else:
            w.u4(_ABSENT)
            w.nonneg(0)
        assert f.tell() == hdr, (f.tell(), hdr)
        for k, (var, begin) in enumerate(zip(nc.vars, begins)):
            if is_rec[k]:
                # numrecs = 0: the record section holds no bytes; the
                # data (shape has a 0 extent) is necessarily empty.
                continue
            dt = NC_TYPES[var.nc_type]
            shape = tuple(nc.dims[d].size for d in var.dimids)
            data = np.asarray(var.data).reshape(shape).astype(dt)
            f.seek(begin)
            raw = data.tobytes()
            f.write(raw)
            f.write(b"\x00" * ((4 - len(raw) % 4) % 4))
    finally:
        if close:
            f.close()

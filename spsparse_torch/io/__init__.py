"""I/O layer: NetCDF round trip with the reference schema, in classic CDF
or NetCDF-4/HDF5 files; scipy ``.npz`` files; sharded NetCDF checkpoints of
row-partitioned matrices."""

from .netcdf import save_netcdf, load_netcdf, NcIO, ncio_spsparse
from .cdf import NcFile, NcDim, NcAttr, NcVar, read_cdf, write_cdf
from .nc4 import read_nc4, write_nc4, is_hdf5
from .npz import save_npz, load_npz
from .sharded import save_netcdf_sharded, load_netcdf_sharded

__all__ = [
    "save_netcdf", "load_netcdf", "NcIO", "ncio_spsparse", "is_hdf5",
    "NcFile", "NcDim", "NcAttr", "NcVar", "read_cdf", "write_cdf",
    "read_nc4", "write_nc4",
    "save_npz", "load_npz", "save_netcdf_sharded", "load_netcdf_sharded",
]

"""I/O layer: NetCDF round trip with the reference schema."""

from .netcdf import save_netcdf, load_netcdf, NcIO, ncio_spsparse, is_hdf5
from .cdf import NcFile, NcDim, NcAttr, NcVar, read_cdf, write_cdf

__all__ = [
    "save_netcdf", "load_netcdf", "NcIO", "ncio_spsparse", "is_hdf5",
    "NcFile", "NcDim", "NcAttr", "NcVar", "read_cdf", "write_cdf",
]

"""netCDF access without the netCDF4 library — the port's copy of
lisflood_tpu/io/ncdf.py.

The reference reads netCDF through the netCDF4 C library
(global_modules/add1.py and netcdf.py). Here `NcFile` reads both formats
that library reads, with the interface of the JAX package's NcFile, and
chooses its backend by the file's first bytes:

- netCDF-4 (HDF5, `\\x89HDF`) through h5py, imported here and nowhere else;
- netCDF classic (`CDF\\x01`, `CDF\\x02`) through `scipy.io.netcdf_file`.

A netCDF-4 file on a machine without h5py raises LisfloodError naming the
package. The writers (`create_nc` / `add_variable` and the rest) write
netCDF-4 with h5py, which they import when called; `write_classic` writes a
classic file with SciPy.
"""
from __future__ import annotations

import numpy as np

from .nctime import date_to_num, num_to_date
from ..utils.errors import LisfloodError, LisfloodFileError

_COORD_NAMES = ("x", "y", "lon", "lat", "time", "string1", "wgs_1984", "crs")
_PROJ_HINTS = ("lambert_azimuthal_equal_area", "laea", "wgs_1984", "crs", "spatial_ref")
_HDF5_MAGIC = b"\x89HDF"
_CLASSIC_MAGIC = (b"CDF\x01", b"CDF\x02")


def _decode(v):
    return v.decode() if isinstance(v, bytes) else v


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise LisfloodError("reading or writing a netCDF-4 (HDF5) file needs the h5py "
                            "package, which is not installed; netCDF classic files are "
                            "read without it") from e
    return h5py


def _native(a):
    """`a` as a NumPy array in native byte order (classic files are
    big-endian)."""
    a = np.asarray(a)
    return a.astype(a.dtype.newbyteorder("=")) if not a.dtype.isnative else a


class _Hdf5:
    """netCDF-4 through h5py."""

    def __init__(self, path):
        h5py = _h5py()
        self._dataset = h5py.Dataset
        self._f = h5py.File(path, "r")

    def close(self):
        self._f.close()

    def names(self):
        return list(self._f.keys())

    def ndim(self, name):
        """Dimensions of variable `name`, None when it is no variable."""
        obj = self._f[name]
        return obj.ndim if isinstance(obj, self._dataset) else None

    def attrs(self, name):
        obj = self._f if name is None else self._f[name]
        return dict(obj.attrs.items())

    def read(self, name, index=None):
        ds = self._f[name]
        return np.asarray(ds[index] if index is not None else ds[:])


class _Classic:
    """netCDF classic (CDF-1 and CDF-2) through scipy.io.netcdf_file. The
    file is memory-mapped; every read is copied out of the map."""

    def __init__(self, path):
        from scipy.io import netcdf_file
        self._f = netcdf_file(path, "r", mmap=True)

    def close(self):
        self._f.close()

    def names(self):
        return list(self._f.variables)

    def ndim(self, name):
        return len(self._f.variables[name].dimensions)

    def attrs(self, name):
        return dict((self._f if name is None else self._f.variables[name])._attributes)

    def read(self, name, index=None):
        data = self._f.variables[name].data
        return _native(np.array(data[index] if index is not None else data[:]))


def _open(path):
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic == _HDF5_MAGIC:
        return _Hdf5(path)
    if magic in _CLASSIC_MAGIC:
        return _Classic(path)
    raise LisfloodError(f"{path}: neither a netCDF-4 nor a netCDF classic file")


class NcFile:
    """Read-only view of a netCDF file (netCDF-4 or classic)."""

    def __init__(self, path):
        if not str(path).endswith(".nc"):
            path = str(path) + ".nc"
        # bounded-retry open for flaky network filesystems
        # (reference iterOpenNetcdf, zusatz.py:407-410)
        from ..utils.retry import remote_input_access
        try:
            self._f = remote_input_access(_open, path)
        except (IOError, OSError) as e:
            raise LisfloodFileError(path, str(e))
        self.path = path

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def variables(self):
        return self._f.names()

    def has(self, name):
        return name in self._f.names()

    def attrs(self, name=None):
        return {k: _decode(v) for k, v in self._f.attrs(name).items()}

    # -- coordinates ------------------------------------------------------
    @property
    def spatial_dims(self):
        """('x', 'y') or ('lon', 'lat')."""
        if self.has("x"):
            return ("x", "y")
        if self.has("lon"):
            return ("lon", "lat")
        raise LisfloodError(f"{self.path}: no x/y or lon/lat coordinates")

    def coord(self, name):
        return self._f.read(name)

    # -- data variable ----------------------------------------------------
    def main_variable(self):
        """The single data variable: 3-D if a time dim exists, else 2-D
        (reference add1.py:403-404)."""
        num_dims = 3 if self.has("time") else 2
        names = self._f.names()
        for name in names:
            if self._f.ndim(name) == num_dims and name not in _COORD_NAMES:
                if any(h in name.lower() for h in _PROJ_HINTS):
                    continue
                return name
        # fall back: accept coordinate-named vars only if nothing else matches
        for name in names:
            if self._f.ndim(name) == num_dims:
                return name
        raise LisfloodError(f"{self.path}: no {num_dims}-D data variable found")

    def fill_value(self, name):
        at = self._f.attrs(name)
        for key in ("_FillValue", "missing_value"):
            if key in at:
                v = at[key]
                return np.asarray(v).ravel()[0]
        return None

    def read(self, name=None, index=None):
        """Read the variable (or a time slice of it), fill values -> NaN."""
        name = name or self.main_variable()
        data = self._f.read(name, index)
        if np.issubdtype(data.dtype, np.floating):
            fv = self.fill_value(name)
            if fv is not None and not np.isnan(fv):
                data = np.where(data == fv, np.nan, data)
        return data

    # -- time -------------------------------------------------------------
    @property
    def has_time(self):
        return self.has("time")

    def time_values(self):
        return self._f.read("time")

    def time_units(self):
        return _decode(self._f.attrs("time").get("units", b""))

    def time_calendar(self):
        return _decode(self._f.attrs("time").get("calendar", b"proleptic_gregorian"))

    def time_dates(self):
        units, cal = self.time_units(), self.time_calendar()
        return [num_to_date(v, units, cal) for v in self.time_values()]

    def date_to_index(self, date):
        return date_to_num(date, self.time_units(), self.time_calendar())


# ---------------------------------------------------------------------------
# writing


def create_nc(path):
    return _h5py().File(path, "w")


def add_dimension(f, name, values, attrs=None):
    """Create a coordinate variable and register it as a netCDF dimension
    scale (h5py's make_scale writes the attributes netCDF-4 expects)."""
    ds = f.create_dataset(name, data=np.asarray(values))
    ds.make_scale(name)
    for k, v in (attrs or {}).items():
        ds.attrs[k] = v
    return ds


def add_unlimited_time(f, units, calendar="proleptic_gregorian", attrs=None):
    ds = f.create_dataset("time", shape=(0,), maxshape=(None,), dtype="f8")
    ds.make_scale("time")
    ds.attrs["units"] = units
    ds.attrs["calendar"] = calendar
    ds.attrs["standard_name"] = "time"
    for k, v in (attrs or {}).items():
        ds.attrs[k] = v
    return ds


def add_variable(f, name, dims, dtype, fill_value=None, chunks=None, attrs=None,
                 compression=4):
    """Create a data variable attached to existing dimension scales. If the
    first dim is the unlimited time dim, the variable grows with it."""
    shape = tuple(f[d].shape[0] for d in dims)
    maxshape = tuple(None if d == "time" else f[d].shape[0] for d in dims)
    kwargs = {}
    if compression and chunks:
        kwargs.update(compression="gzip", compression_opts=compression, shuffle=True)
    ds = f.create_dataset(
        name, shape=shape, maxshape=maxshape, dtype=dtype,
        chunks=chunks, fillvalue=fill_value, **kwargs,
    )
    if fill_value is not None:
        ds.attrs["_FillValue"] = np.array([fill_value], dtype=dtype)
    for i, d in enumerate(dims):
        ds.dims[i].attach_scale(f[d])
    for k, v in (attrs or {}).items():
        ds.attrs[k] = v
    return ds


def append_time_step(f, varname, date, data2d):
    """Append one time slice to an unlimited-time variable."""
    time_ds = f["time"]
    n = time_ds.shape[0]
    time_ds.resize((n + 1,))
    time_ds[n] = date_to_num(date, _decode(time_ds.attrs["units"]),
                             _decode(time_ds.attrs.get("calendar", "proleptic_gregorian")))
    var = f[varname]
    var.resize(n + 1, axis=0)
    var[n] = data2d


def add_grid_mapping(f, name, attrs):
    """A scalar grid-mapping variable `name` (CF's `grid_mapping`) with its
    attributes, in a netCDF-4 file open for writing."""
    ds = f.create_dataset(name, data=np.int32(0))
    for k, v in attrs.items():
        ds.attrs[k] = v
    return ds


def write_classic(path, coords, name, data, fill_value=None, attrs=None, grid_mapping=None):
    """Write one variable `name` with its coordinate variables as a netCDF
    classic file (CDF-2, 64-bit offsets). `coords` lists (dimension name,
    values, attributes) in the order of `data`'s axes; `grid_mapping`
    (name, attributes) adds a scalar grid-mapping variable that `name`
    names in its `grid_mapping` attribute."""
    from scipy.io import netcdf_file
    data = np.asarray(data)
    if grid_mapping is not None:
        attrs = {**(attrs or {}), "grid_mapping": grid_mapping[0]}
    with netcdf_file(path, "w", version=2) as f:
        if grid_mapping is not None:
            gm = f.createVariable(grid_mapping[0], np.int32, ())
            gm[...] = 0
            for k, v in grid_mapping[1].items():
                setattr(gm, k, v)
        for dim, values, dim_attrs in coords:
            values = np.asarray(values)
            f.createDimension(dim, values.size)
            var = f.createVariable(dim, values.dtype, (dim,))
            var[:] = values
            for k, v in (dim_attrs or {}).items():
                setattr(var, k, v)
        var = f.createVariable(name, data.dtype, tuple(d for d, _, _ in coords))
        var[:] = data
        if fill_value is not None:
            var._FillValue = np.asarray(fill_value, data.dtype)
        for k, v in (attrs or {}).items():
            setattr(var, k, v)

"""Model grid: clone geometry, land mask, compressed-vector codec.

The fundamental data layout (shared with the reference, add1.py:168-315):
the 2-D raster is masked to land pixels — a cell is modelled iff it is
inside the MaskMap AND has a valid local drain direction — and all model
state lives as dense 1-D vectors over those pixels in row-major order
(`compress`/`decompress`): dense vectors, no ragged masking in compute.
The port's copy of lisflood_tpu/io/grid.py.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from . import csf
from .ncdf import NcFile
from ..utils.errors import LisfloodError


@dataclass
class Grid:
    west: float
    north: float
    cell: float
    nrows: int
    ncols: int
    mask2d: np.ndarray          # bool (rows, cols); True = excluded from model
    maskmap_area: np.ndarray | None = None  # the raw MaskMap area (pre-Ldd) mask
    land_flat: np.ndarray = field(init=False)   # flat bool, True = land
    num_pixels: int = field(init=False)

    def __post_init__(self):
        self.land_flat = ~self.mask2d.ravel()
        self.num_pixels = int(self.land_flat.sum())

    # -- codec ------------------------------------------------------------
    def compress(self, arr2d, check_name=None):
        """2-D raster -> (P,) land-pixel vector (reference add1.py:268-282)."""
        arr2d = np.asarray(arr2d)
        vec = arr2d.reshape(arr2d.shape[:-2] + (-1,))[..., self.land_flat]
        if check_name is not None and np.issubdtype(vec.dtype, np.floating) and np.isnan(vec).any():
            raise LisfloodError(f"{check_name} has less valid pixels than area or ldd")
        return vec

    def decompress(self, vec, fill=np.nan):
        """(…, P) vector -> 2-D raster with `fill` outside land
        (reference add1.py:285-305)."""
        vec = np.asarray(vec)
        lead = vec.shape[:-1]
        out = np.full(lead + (self.nrows * self.ncols,), fill,
                      dtype=vec.dtype if np.issubdtype(vec.dtype, np.floating) else float)
        out[..., self.land_flat] = vec
        return out.reshape(lead + (self.nrows, self.ncols))

    def in_zero(self, *lead):
        return np.zeros(lead + (self.num_pixels,))

    # -- geometry ---------------------------------------------------------
    def cut_window(self, x_coords, y_coords):
        """Crop window of this grid inside a (possibly larger) netCDF grid:
        returns (col0, col1, row0, row1) so data[row0:row1, col0:col1]
        aligns with the clone (reference add1.py:135-165). Coordinates must
        already be normalized to x ascending / y descending."""
        cell_x = abs(float(x_coords[1]) - float(x_coords[0])) if len(x_coords) > 1 else self.cell
        cell_y = abs(float(y_coords[1]) - float(y_coords[0])) if len(y_coords) > 1 else self.cell
        if abs(self.cell - cell_x) > 1e-5 or abs(self.cell - cell_y) > 1e-5:
            raise LisfloodError(
                f"Cell size mismatch: mask {self.cell} vs input {cell_x}x{cell_y}")
        x_left = min(float(x_coords[0]), float(x_coords[-1]))
        y_top = max(float(y_coords[0]), float(y_coords[-1]))
        half = self.cell / 2.0
        x_edge = x_left - half
        y_edge = y_top + half
        # the offsets are whole cells: rounded, not truncated, so that a
        # quotient such as 1.9999999999999 on a 0.05 degree grid is 2 (the
        # JAX package truncates, ROADMAP.md Queue 3)
        cut0 = int(round(abs(self.west - x_edge) / cell_x))
        cut2 = int(round(abs(self.north - y_edge) / cell_y))
        return cut0, cut0 + self.ncols, cut2, cut2 + self.nrows

    def coords_x(self):
        return self.west + self.cell * (np.arange(self.ncols) + 0.5)

    def coords_y(self):
        return self.north - self.cell * (np.arange(self.nrows) + 0.5)


def _area_mask_from_file(filename):
    """Load the MaskMap area (True = inside area) + geometry."""
    if os.path.splitext(filename)[1] not in (".nc", "") or filename.endswith(".map"):
        try:
            m = csf.read_map(filename)
            area = (~m.mv_mask) & (np.nan_to_num(m.data) != 0)
            return area, m.west, m.north, m.cell_size, m.nrows, m.ncols
        except (ValueError, OSError):
            pass
    with NcFile(os.path.splitext(filename)[0] + ".nc") as nc:
        xd, yd = nc.spatial_dims
        x = nc.coord(xd)
        y = nc.coord(yd)
        data = nc.read(nc.main_variable())
        if y[0] < y[-1]:
            data = np.flipud(data)
            y = y[::-1]
        if x[0] > x[-1]:
            data = np.fliplr(data)
            x = x[::-1]
        nrows, ncols = data.shape
        cell = abs(float(x[-1]) - float(x[0])) / (ncols - 1)
        west = float(min(x[0], x[-1])) - cell / 2
        north = float(max(y[0], y[-1])) + cell / 2
        area = np.isfinite(data) & (np.nan_to_num(data) != 0)
        return area, west, north, cell, nrows, ncols


def build_grid(maskmap_value, ldd2d=None):
    """Build the Grid from the MaskMap binding value. The binding may be a
    'col row cellsize xupleft yupleft' coordinate string, a PCRaster map, or
    a netCDF map (reference add1.py:168-265). If `ldd2d` (the local drain
    direction raster cut to the clone) is given, cells without a valid LDD
    (codes 1..9) are excluded from the model mask."""
    parts = str(maskmap_value).split()
    if len(parts) == 5:
        ncols, nrows = int(parts[0]), int(parts[1])
        cell = float(parts[2])
        west, north = float(parts[3]), float(parts[4])
        area = np.ones((nrows, ncols), dtype=bool)
    elif len(parts) == 1:
        area, west, north, cell, nrows, ncols = _area_mask_from_file(parts[0])
    else:
        raise LisfloodError(f"MaskMap {maskmap_value!r} is not a valid mask map nor coordinates")

    if ldd2d is not None:
        valid_ldd = np.isfinite(ldd2d) & (np.nan_to_num(ldd2d) >= 1) & (np.nan_to_num(ldd2d) <= 9)
        mask2d = ~(area & valid_ldd)
    else:
        mask2d = ~area
    return Grid(west=west, north=north, cell=cell, nrows=nrows, ncols=ncols,
                mask2d=mask2d, maskmap_area=area)

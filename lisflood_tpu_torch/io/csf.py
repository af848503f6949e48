"""PCRaster CSF (.map) raster format reader/writer.

Self-contained re-implementation of the CSF-2 on-disk format (the reference
delegates to the PCRaster C++ library: `iterReadPCRasterMap`,
zusatz.py:413, and `report` for PCRaster-format outputs). Layout verified
against the test data files (mask.map, avgdis.map, inflow_new3.map):

 main header:   0: char[32] signature "RUU CROSS SYSTEM MAP FORMAT"
               32: u16 version (2)     34: u32 gisFileId
               38: u16 projection (1 = y increases downward)
               40: u32 attrTable       44: u16 mapType    46: u32 byteOrder
 raster header:64: u16 valueScale      66: u16 cellRepr
               68: f64 minVal          76: f64 maxVal
               84: f64 xUL             92: f64 yUL
              100: u32 nrRows         104: u32 nrCols
              108: f64 cellSize       116: f64 cellSize(dup) 124: f64 angle
 cell data:   256: row-major grid

The port's copy of lisflood_tpu/io/csf.py.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

SIGNATURE = b"RUU CROSS SYSTEM MAP FORMAT\x00\x00\x00\x00\x00"

# valueScale codes
VS_BOOLEAN = 0xE0
VS_NOMINAL = 0xE2
VS_ORDINAL = 0xF2
VS_SCALAR = 0xEB
VS_DIRECTION = 0xFB
VS_LDD = 0xF0

# cellRepr codes -> numpy dtype and missing value
_CELL_REPR = {
    0x00: (np.uint8, 255),                      # CR_UINT1
    0x26: (np.int32, np.int32(-2147483648)),    # CR_INT4
    0x15: (np.int16, np.int16(-32768)),         # CR_INT2
    0x5A: (np.float32, None),                   # CR_REAL4 (MV = all-ones bits)
    0xDB: (np.float64, None),                   # CR_REAL8
}
_REPR_OF_DTYPE = {np.dtype(np.uint8): 0x00, np.dtype(np.int32): 0x26,
                  np.dtype(np.int16): 0x15, np.dtype(np.float32): 0x5A,
                  np.dtype(np.float64): 0xDB}


@dataclass
class CsfMap:
    """A decoded PCRaster map: data (np.ndarray with np.nan for MV on float,
    masked ints kept as `mv` sentinel) + geometry."""

    data: np.ndarray        # (rows, cols); float maps have NaN at MV
    mv_mask: np.ndarray     # bool (rows, cols), True where missing
    value_scale: int
    x_ul: float
    y_ul: float
    cell_size: float

    @property
    def nrows(self):
        return self.data.shape[0]

    @property
    def ncols(self):
        return self.data.shape[1]

    @property
    def west(self):
        return self.x_ul

    @property
    def north(self):
        return self.y_ul


def is_csf(path):
    """Whether `path` is a file that starts with the CSF signature, whatever
    its name (a member of a PCRaster map stack, lz000000.003, has no .map)."""
    if not os.path.isfile(path):
        return False
    with open(path, "rb") as f:
        return f.read(27) == SIGNATURE[:27]


def read_map(path) -> CsfMap:
    # bounded-retry read for flaky network filesystems
    # (reference iterReadPCRasterMap, zusatz.py:413-415)
    from ..utils.retry import remote_input_access

    def _read(p):
        with open(p, "rb") as f:
            return f.read()

    raw = remote_input_access(_read, path)
    if raw[:27] != SIGNATURE[:27]:
        raise ValueError(f"{path} is not a PCRaster CSF map")
    value_scale, cell_repr = struct.unpack_from("<HH", raw, 64)
    x_ul, y_ul = struct.unpack_from("<dd", raw, 84)
    nrows, ncols = struct.unpack_from("<II", raw, 100)
    cell_size, = struct.unpack_from("<d", raw, 108)
    if cell_repr not in _CELL_REPR:
        raise ValueError(f"{path}: unsupported cell representation {cell_repr:#x}")
    dtype, mv = _CELL_REPR[cell_repr]
    grid = np.frombuffer(raw, dtype=dtype, count=nrows * ncols, offset=256)
    grid = grid.reshape(nrows, ncols).copy()
    if np.issubdtype(dtype, np.floating):
        # CSF float MV is the all-ones bit pattern (a NaN); any NaN is missing
        mv_mask = ~np.isfinite(grid)
        grid[mv_mask] = np.nan
    else:
        mv_mask = grid == mv
    return CsfMap(data=grid, mv_mask=mv_mask, value_scale=value_scale,
                  x_ul=float(x_ul), y_ul=float(y_ul), cell_size=float(cell_size))


def write_map(path, data, x_ul, y_ul, cell_size, value_scale=VS_SCALAR, mv_mask=None):
    """Write a CSF-2 map. Float data: NaN cells are written as MV."""
    data = np.asarray(data)
    if value_scale == VS_SCALAR and data.dtype != np.float32:
        data = data.astype(np.float32)
    if value_scale in (VS_NOMINAL, VS_ORDINAL) and data.dtype not in (np.int32,):
        data = data.astype(np.int32)
    if value_scale in (VS_BOOLEAN, VS_LDD) and data.dtype != np.uint8:
        data = data.astype(np.uint8)
    cell_repr = _REPR_OF_DTYPE[data.dtype]
    _, mv = _CELL_REPR[cell_repr]
    grid = data.copy()
    if np.issubdtype(grid.dtype, np.floating):
        valid = np.isfinite(grid)
        if mv_mask is not None:
            valid &= ~mv_mask
        vmin = float(grid[valid].min()) if valid.any() else 0.0
        vmax = float(grid[valid].max()) if valid.any() else 0.0
        # all-ones bit pattern for MV
        flat = grid.ravel()
        mvbits = np.array([-1], dtype=np.int32 if grid.dtype == np.float32 else np.int64)
        mv_value = mvbits.view(grid.dtype)[0]
        flat[~np.isfinite(flat)] = mv_value
        if mv_mask is not None:
            flat[mv_mask.ravel()] = mv_value
    else:
        if mv_mask is not None:
            grid[mv_mask] = mv
        valid = grid != mv
        vmin = float(grid[valid].min()) if valid.any() else 0.0
        vmax = float(grid[valid].max()) if valid.any() else 0.0

    nrows, ncols = grid.shape
    hdr = bytearray(256)
    hdr[0:32] = SIGNATURE
    struct.pack_into("<H", hdr, 32, 2)          # version
    struct.pack_into("<I", hdr, 34, 0)          # gisFileId
    struct.pack_into("<H", hdr, 38, 1)          # projection: y top-down
    struct.pack_into("<I", hdr, 40, 0)          # attrTable
    struct.pack_into("<H", hdr, 44, 1)          # mapType T_RASTER
    struct.pack_into("<I", hdr, 46, 1)          # byteOrder little-endian
    struct.pack_into("<HH", hdr, 64, value_scale, cell_repr)
    struct.pack_into("<dd", hdr, 68, vmin, vmax)
    struct.pack_into("<dd", hdr, 84, x_ul, y_ul)
    struct.pack_into("<II", hdr, 100, nrows, ncols)
    struct.pack_into("<ddd", hdr, 108, cell_size, cell_size, 0.0)
    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(grid.tobytes())

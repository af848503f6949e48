from .grid import Grid, build_grid
from .loadmap import MapLoader, defsoil
from .ncdf import NcFile
from . import csf

__all__ = ["Grid", "build_grid", "MapLoader", "defsoil", "NcFile", "csf"]

"""Inverse map projection for latitude extraction.

The reference reads per-pixel latitude (for snow-season hemisphere and
seasonality) by inverse-projecting the template grid's x/y coordinates with
pyproj (netcdf.py:356-408). pyproj is not available here, so the inverse
Lambert Azimuthal Equal-Area projection (the projection used by the
LISFLOOD European ETRS89 grids) is implemented directly from Snyder (1987,
"Map Projections — A Working Manual", pp. 187-190, authalic-sphere form).
Geographic (lat/lon) grids need no projection.

The port's copy of lisflood_tpu/io/projection.py.
"""
from __future__ import annotations

import numpy as np

from ..utils.errors import LisfloodError

_ELLIPSOIDS = {
    "GRS80": (6378137.0, 1 / 298.257222101),
    "WGS84": (6378137.0, 1 / 298.257223563),
    "sphere": (6370997.0, 0.0),
}


def parse_proj4(proj4: str) -> dict:
    params = {}
    for tok in proj4.split():
        tok = tok.lstrip("+")
        if "=" in tok:
            k, v = tok.split("=", 1)
            params[k] = v
        else:
            params[tok] = True
    return params


def _authalic_q(sin_phi, e):
    if e == 0:
        return 2 * sin_phi
    esin = e * sin_phi
    return (1 - e**2) * (sin_phi / (1 - esin**2) - (1 / (2 * e)) * np.log((1 - esin) / (1 + esin)))


def laea_inverse(x, y, proj_params):
    """Inverse LAEA: projected metres -> (lon_deg, lat_deg)."""
    p = proj_params
    lat0 = np.radians(float(p.get("lat_0", 0.0)))
    lon0 = np.radians(float(p.get("lon_0", 0.0)))
    x0 = float(p.get("x_0", 0.0))
    y0 = float(p.get("y_0", 0.0))
    ellps = p.get("ellps", "GRS80")
    if "a" in p:
        a = float(p["a"])
        f = 1.0 / float(p["rf"]) if "rf" in p else 0.0
    else:
        a, f = _ELLIPSOIDS.get(ellps, _ELLIPSOIDS["GRS80"])
    e = np.sqrt(f * (2 - f))

    x = np.asarray(x, dtype=np.float64) - x0
    y = np.asarray(y, dtype=np.float64) - y0

    qp = _authalic_q(1.0, e)
    q0 = _authalic_q(np.sin(lat0), e)
    beta0 = np.arcsin(np.clip(q0 / qp, -1, 1))
    Rq = a * np.sqrt(qp / 2)
    if e == 0:
        D = 1.0
    else:
        m0 = np.cos(lat0) / np.sqrt(1 - (e * np.sin(lat0)) ** 2)
        D = a * m0 / (Rq * np.cos(beta0))

    rho = np.sqrt((x / D) ** 2 + (D * y) ** 2)
    with np.errstate(invalid="ignore"):
        ce = 2 * np.arcsin(np.clip(rho / (2 * Rq), -1, 1))
        q = qp * (np.cos(ce) * np.sin(beta0) + np.where(rho == 0, 0.0, D * y * np.sin(ce) * np.cos(beta0) / np.where(rho == 0, 1.0, rho)))
    # iterate for latitude (Snyder eq. 3-16)
    phi = np.arcsin(np.clip(q / 2, -1, 1))
    if e > 0:
        for _ in range(6):
            sin_phi = np.sin(phi)
            esin = e * sin_phi
            phi = phi + ((1 - esin**2) ** 2 / (2 * np.cos(phi))) * (
                q / (1 - e**2) - sin_phi / (1 - esin**2) + (1 / (2 * e)) * np.log((1 - esin) / (1 + esin))
            )
    with np.errstate(invalid="ignore"):
        lon = lon0 + np.arctan2(x * np.sin(ce), D * rho * np.cos(beta0) * np.cos(ce) - D**2 * y * np.sin(beta0) * np.sin(ce))
    lat_at_pole = np.where(y >= 0, 90.0, -90.0)
    lat = np.where(rho == 0, np.where(np.zeros_like(rho) == 0, np.degrees(lat0), lat_at_pole), np.degrees(phi))
    return np.degrees(lon), lat


def read_lat_from_template(binding, grid):
    """Per-land-pixel latitude in degrees (reference netcdf.py:344-408)."""
    from .ncdf import NcFile
    import os

    template = binding.get("netCDFtemplate") or binding.get("E0Maps")
    path = os.path.splitext(template)[0] + ".nc"
    with NcFile(path) as nc:
        xd, yd = nc.spatial_dims
        x = np.sort(nc.coord(xd))
        y = np.sort(nc.coord(yd))[::-1]
    cut0, cut1, cut2, cut3 = grid.cut_window(x, y)
    xx, yy = np.meshgrid(x[cut0:cut1], y[cut2:cut3])
    if xd == "x":
        proj4 = binding.get("proj4_params")
        if not proj4:
            raise LisfloodError(
                "Projected grid (x, y) requires proj4_params in the settings file")
        params = parse_proj4(proj4)
        if params.get("proj") != "laea":
            raise LisfloodError(f"Unsupported projection {params.get('proj')!r} (only laea)")
        _, lat = laea_inverse(xx, yy, params)
    else:
        lat = yy
    return grid.compress(lat)

"""The catchment read from maps: files written from the seed, read by the
program as a user's run reads them.

`make_inputs` is a frozen copy of lisflood_tpu_torch/models/synthetic.py::
write_catchment (commit c77b93b) with its defaults and the options of
CATCHMENT_OPTIONS (split routing, lakes, reservoirs, open-water
evaporation, the mass-balance reports), classic netCDF and PCRaster meteo
stacks of the traffic's `ring_days` days, with its own writers of the two
formats. It draws the same numbers from the same seed and keeps what it
wrote in memory (`raw`). The program reads the files (`build_program`:
load_settings, build_model and the meteo stacks, timed as set-up); the
reference works its model out again from `raw` (`reference_model`, a
frozen copy of the arithmetic of the program's build_model on the main
path, models/initial.py).
"""
from __future__ import annotations

import datetime
import os
import struct

import numpy as np

from ..reference.graph import accuflux, catchment_labels, upstream_sum
from .continental import lai_interval, mualem, synthetic_drainage

CELL, WEST, NORTH = 5000.0, 2_500_000.0, 5_500_000.0
OPTIONS = {"InitLisflood": False, "SplitRouting": True, "simulateLakes": True,
           "simulateReservoirs": True, "openwaterevapo": True, "repMBTs": True}
LAEA_PROJ4 = ("+proj=laea +lat_0=52 +lon_0=10 +x_0=4321000 +y_0=3210000 +ellps=GRS80 "
              "+units=m +no_defs")
# write_catchment's stacks but ES0Maps, which the program never reads (the
# step takes ESRef = (EWRef + ETRef) / 2): it is the last draw, so leaving it
# out changes no other number, and saves a fifth of the meteo's bytes
METEO_STACKS = {"PrecipitationMaps": ("pr", 0.0, 15.0), "TavgMaps": ("ta", -5.0, 20.0),
                "ET0Maps": ("et", 0.0, 5.0), "E0Maps": ("e0", 0.0, 6.0)}
METEO_KEYS = {"PrecipitationMaps": "Precipitation", "TavgMaps": "Tavg", "ET0Maps": "ETRef",
              "E0Maps": "EWRef"}
VS_BOOLEAN, VS_NOMINAL, VS_SCALAR, VS_LDD = 0xE0, 0xE2, 0xEB, 0xF0
_REPR = {np.dtype(np.uint8): (0x00, 255), np.dtype(np.int32): (0x26, -2147483648),
         np.dtype(np.float32): (0x5A, None)}
# the scalar bindings the settings give (write_catchment's)
BINDING = {
    "GwLoss": 0.0, "GwPercValue": 0.5, "PrScaling": 1.0, "CalEvaporation": 1.0,
    "TemperatureLapseRate": 0.0065, "SnowSeasonAdj": 1.0, "TempSnow": 1.0, "SnowFactor": 1.0,
    "SnowMeltCoef": 4.0, "TempMelt": 0.0, "Kfrost": 0.57, "Afrost": 0.97,
    "FrostIndexThreshold": 56.0, "SnowWaterEquivalent": 0.45, "kdf": 0.72, "CourantCrit": 0.4,
    "LeafDrainageTimeConstant": 0.1, "AvWaterRateThreshold": 5.0,
    "MapCropCoef": 1.0, "MapForestCropCoef": 1.1, "MapIrrigationCropCoef": 1.05,
    "MapCropGroupNumber": 4.0, "MapForestCropGroupNumber": 4.5, "MapIrrigationCropGroupNumber": 3.0,
    "MapN": 0.2, "MapForestN": 0.4, "MapKSat1Forest": 200.0, "MapKSat2Forest": 60.0,
    "MapLambda1": 0.25, "MapLambda1Forest": 0.3, "MapLambda2": 0.2, "MapLambda2Forest": 0.25,
    "MapLambda3": 0.15, "MapGenuAlpha1": 0.03, "MapGenuAlpha1Forest": 0.04,
    "MapGenuAlpha2": 0.02, "MapGenuAlpha2Forest": 0.03, "MapGenuAlpha3": 0.01,
    "MapThetaSat1": 0.45, "MapThetaSat1Forest": 0.5, "MapThetaSat2": 0.42,
    "MapThetaSat2Forest": 0.45, "MapThetaSat3": 0.4, "MapThetaRes1": 0.05,
    "MapThetaRes1Forest": 0.06, "MapThetaRes2": 0.04, "MapThetaRes2Forest": 0.05,
    "MapThetaRes3": 0.03, "b_Xinanjiang": 0.7, "PowerPrefFlow": 3.5, "SMaxSealed": 1.0,
    "UpperZoneTimeConstant": 10.0, "LowerZoneTimeConstant": 100.0, "beta": 0.6,
    "ChanGradMin": 0.0001, "CalChanMan": 1.0, "ChanSdXdY": 1.0, "CalChanMan2": 3.0,
    "QSplitMult": 2.0, "GradMin": 0.001, "OFDepRef": 5.0, "LakeMultiplier": 1.0,
    "adjust_Normal_Flood": 0.8, "ReservoirRnormqMult": 1.0, "maxNoEva": 5,
    "DtSec": 86400.0, "DtSecChannel": 3600.0}


def write_map(path, data, value_scale=VS_SCALAR, mv_mask=None):
    """A PCRaster CSF-2 map of the grid; float NaN cells are missing."""
    data = np.asarray(data)
    if value_scale == VS_SCALAR:
        data = data.astype(np.float32)
    elif value_scale == VS_NOMINAL:
        data = data.astype(np.int32)
    else:
        data = data.astype(np.uint8)
    repr_, mv = _REPR[data.dtype]
    grid = data.copy()
    if grid.dtype == np.float32:
        valid = np.isfinite(grid)
        if mv_mask is not None:
            valid &= ~mv_mask
        flat = grid.ravel()
        flat[~np.isfinite(flat)] = np.array([-1], np.int32).view(np.float32)[0]
        if mv_mask is not None:
            flat[mv_mask.ravel()] = np.array([-1], np.int32).view(np.float32)[0]
    else:
        if mv_mask is not None:
            grid[mv_mask] = mv
        valid = grid != mv
    vmin = float(data[valid].min()) if valid.any() else 0.0
    vmax = float(data[valid].max()) if valid.any() else 0.0
    nrows, ncols = grid.shape
    hdr = bytearray(256)
    hdr[0:32] = b"RUU CROSS SYSTEM MAP FORMAT\x00\x00\x00\x00\x00"
    struct.pack_into("<H", hdr, 32, 2)
    struct.pack_into("<I", hdr, 34, 0)
    struct.pack_into("<H", hdr, 38, 1)
    struct.pack_into("<I", hdr, 40, 0)
    struct.pack_into("<H", hdr, 44, 1)
    struct.pack_into("<I", hdr, 46, 1)
    struct.pack_into("<HH", hdr, 64, value_scale, repr_)
    struct.pack_into("<dd", hdr, 68, vmin, vmax)
    struct.pack_into("<dd", hdr, 84, WEST, NORTH)
    struct.pack_into("<II", hdr, 100, nrows, ncols)
    struct.pack_into("<ddd", hdr, 108, CELL, CELL, 0.0)
    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(grid.tobytes())


def write_classic(path, coords, name, data, fill_value):
    """One variable and its coordinates as a netCDF classic file (CDF-2)."""
    from scipy.io import netcdf_file
    data = np.asarray(data)
    with netcdf_file(path, "w", version=2) as f:
        for dim, values, attrs in coords:
            values = np.asarray(values)
            f.createDimension(dim, values.size)
            var = f.createVariable(dim, values.dtype, (dim,))
            var[:] = values
            for k, v in attrs.items():
                setattr(var, k, v)
        var = f.createVariable(name, data.dtype, tuple(d for d, _, _ in coords))
        var[:] = data
        var._FillValue = np.asarray(fill_value, data.dtype)


def make_inputs(config, seed, workdir, traffic):
    """Write the catchment of `config` (nrows, ncols) with `traffic`'s
    ring_days days of meteo under `workdir`; return its settings file and
    what was written (`raw`: the mask, the maps on the grid, the tables, the
    meteo)."""
    nrows, ncols = config["nrows"], config["ncols"]
    n_steps = int(traffic["ring_days"])
    rng = np.random.default_rng([seed, 11])
    root = os.path.abspath(os.path.join(workdir, "catchment"))
    dirs = {k: os.path.join(root, k) for k in ("maps", "tables", "meteo", "out")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    P = nrows * ncols
    rows, cols = np.divmod(np.arange(P, dtype=np.int64), ncols)
    land = (rows / nrows) ** 2 + (cols / ncols) ** 2 >= 0.04
    ldd, down = synthetic_drainage(nrows, ncols, seed)
    codes = np.zeros(P, np.int8)
    valid = down >= 0
    codes[valid] = ldd[valid]
    codes[codes == 0] = 5
    ups = accuflux(down, np.ones(P))
    channel = land & (ups >= np.quantile(ups[land], 0.8))
    order = np.argsort(np.where(channel, ups, -1.0), kind="stable")[::-1]
    lakes, reservoirs, gauge_cells = order[4:6], order[8:10], order[:3]
    up_area = ups * CELL * CELL
    binding, maps = {}, {}

    def write(name, values, scale=VS_SCALAR, missing=None):
        values = np.asarray(values)
        write_map(os.path.join(dirs["maps"], name + ".map"), values.reshape(nrows, ncols), scale,
                  None if missing is None else missing.reshape(nrows, ncols))
        binding[name] = f"$(PathMaps)/{name}.map"
        maps[name] = values if missing is None else np.where(missing, 0, values)

    def field(lo, hi):
        return np.where(land, rng.uniform(lo, hi, P), np.nan).astype(np.float32)

    def sites(name, cells):
        ids = np.zeros(P, np.int32)
        ids[cells] = np.arange(1, len(cells) + 1)
        write(name, ids, VS_NOMINAL, missing=ids == 0)

    write("MaskMap", land.astype(np.uint8), VS_BOOLEAN)
    write("Ldd", codes.astype(np.uint8), VS_LDD)
    write("Channels", channel.astype(np.uint8), VS_BOOLEAN)
    sites("LakeSites", lakes)
    sites("ReservoirSites", reservoirs)
    sites("Gauges", gauge_cells)
    lake_mask = np.isin(np.arange(P), lakes) | np.isin(down, lakes)
    write("LakeMask", lake_mask.astype(np.uint8), VS_BOOLEAN)
    fr = rng.dirichlet(np.ones(5), P).T * 0.2      # water, direct, forest, irrigated, rice
    fractions = {"WaterFraction": fr[0], "DirectRunoffFraction": fr[1],
                 "ForestFraction": fr[2], "IrrigationFraction": fr[3], "RiceFraction": fr[4]}
    fractions["OtherFraction"] = 1 - fr.sum(0)
    for name, v in fractions.items():
        write(name, np.where(land, v, np.nan).astype(np.float32))
    size = np.log1p(ups) / np.log1p(ups.max())
    for name, lo, hi in (("ElevationStD", 0, 300), ("Grad", 1e-3, 0.1),
                         ("SoilDepth1", 50, 150), ("SoilDepth1Forest", 60, 200),
                         ("SoilDepth2", 100, 400), ("SoilDepth2Forest", 150, 500),
                         ("SoilDepth3", 200, 800), ("SoilDepth3Forest", 300, 1000),
                         ("MapKSat1", 10, 300), ("MapKSat2", 5, 100), ("MapKSat3", 1, 50),
                         ("ChanGrad", 1e-4, 0.01), ("ChanMan", 0.02, 0.06),
                         ("LZAvInflowMap", 0.1, 1.0)):
        write(name, field(lo, hi))
    write("ChanLength", np.where(land, CELL * (1 + 0.4 * rng.random(P)), np.nan).astype(np.float32))
    write("ChanBottomWidth", np.where(land, 2 + 98 * size, np.nan).astype(np.float32))
    write("ChanDepthThreshold", np.where(land, 0.5 + 7.5 * size, np.nan).astype(np.float32))
    write("AvgDis", np.where(land, up_area * 1e-3 / 86400.0, np.nan).astype(np.float32))

    tables = {
        "TabLakeArea": rng.uniform(1e7, 1e8, 2), "TabLakeA": rng.uniform(30, 150, 2),
        "TabLakeAvNetInflowEstimate": rng.uniform(10, 50, 2),
        "TabTotStorage": rng.uniform(1e8, 1e9, 2),
        "TabConservativeStorageLimit": np.full(2, 0.1), "TabNormalStorageLimit": np.full(2, 0.45),
        "TabFloodStorageLimit": np.full(2, 0.9),
        "TabNonDamagingOutflowQ": rng.uniform(100, 300, 2),
        "TabNormalOutflowQ": rng.uniform(20, 80, 2), "TabMinOutflowQ": rng.uniform(1, 5, 2)}
    for name, values in tables.items():
        with open(os.path.join(dirs["tables"], name + ".txt"), "w") as fh:
            fh.writelines(f"{i} {float(v)!r}\n" for i, v in enumerate(values, 1))
        binding[name] = f"$(PathTables)/{name}.txt"

    x = WEST + CELL * (np.arange(ncols) + 0.5)
    y = NORTH - CELL * (np.arange(nrows) + 0.5)
    xy = [("y", y, {"standard_name": "projection_y_coordinate", "units": "m"}),
          ("x", x, {"standard_name": "projection_x_coordinate", "units": "m"})]
    days = ("time", np.arange(36, dtype=np.float64) * 10.0,
            {"units": "days since 2000-01-01", "calendar": "proleptic_gregorian"})

    def write_map_nc(name, coords, var, data):
        write_classic(os.path.join(dirs["maps"], name + ".nc"), coords, var, data, -9999.0)
        binding[name] = f"$(PathMaps)/{name}.nc"

    write_map_nc("netCDFtemplate", xy, "template",
                 np.where(land, 1.0, -9999.0).reshape(nrows, ncols).astype(np.float32))
    season = 1 + 0.5 * np.sin(2 * np.pi * np.arange(36) / 36)
    lai = {}
    for name, lo, hi in (("LAIOtherMaps", 0.5, 3), ("LAIForestMaps", 2, 6),
                         ("LAIIrrigationMaps", 0.5, 4)):
        base = rng.uniform(lo, hi, P).reshape(nrows, ncols)
        lai[name] = (season[:, None, None] * base).astype(np.float32)
        write_map_nc(name, [days] + xy, "lai", lai[name])

    meteo = {}
    for key, (prefix, lo, hi) in METEO_STACKS.items():
        stack = [field(lo, hi).reshape(nrows, ncols) for _ in range(n_steps)]
        for step, data in enumerate(stack, 1):
            nr = str(step)
            name = f"{prefix}{'0' * (11 - len(prefix) - len(nr))}{nr}"
            write_map(os.path.join(dirs["meteo"], f"{name[:8]}.{name[8:]}"), data)
        binding[key] = f"$(PathMeteo)/{prefix}"
        meteo[key] = np.stack(stack)

    start = datetime.datetime(2000, 1, 1)
    end = start + datetime.timedelta(days=n_steps - 1)
    words = {k: repr(float(v)) if isinstance(v, float) else str(v) for k, v in BINDING.items()}
    binding.update({
        "CalendarDayStart": start.strftime("%d/%m/%Y %H:%M"),
        "StepStart": start.strftime("%d/%m/%Y %H:%M"), "StepEnd": end.strftime("%d/%m/%Y %H:%M"),
        "PathOut": "$(PathOut)", "proj4_params": LAEA_PROJ4, **words,
        "DtSec": "86400", "DtSecChannel": "3600", "maxNoEva": "5",
        "SnowCoverAInitValue": "0", "SnowCoverBInitValue": "0", "SnowCoverCInitValue": "0",
        "FrostIndexInitValue": "0",
        **{k: "-9999" for k in ("ThetaInit1Value", "ThetaForestInit1Value",
                                "ThetaIrrigationInit1Value", "ThetaInit2Value",
                                "ThetaForestInit2Value", "ThetaIrrigationInit2Value",
                                "ThetaInit3Value", "ThetaForestInit3Value",
                                "ThetaIrrigationInit3Value")},
        "DSLRInitValue": "1", "DSLRForestInitValue": "1", "DSLRIrrigationInitValue": "1",
        "CumIntInitValue": "0", "CumIntForestInitValue": "0", "CumIntIrrigationInitValue": "0",
        "CumIntSealedInitValue": "0", "LZInitValue": "-9999", "LZThreshold": "0",
        "UZInitValue": "0", "UZForestInitValue": "0", "UZIrrigationInitValue": "0",
        "TotalCrossSectionAreaInitValue": "-9999", "PrevDischarge": "-9999",
        "CrossSection2AreaInitValue": "-9999", "PrevSideflowInitValue": "-9999",
        "OFOtherInitValue": "0", "OFForestInitValue": "0", "OFDirectInitValue": "0",
        "LakeInitialLevelValue": "-9999", "LakePrevInflowValue": "-9999",
        "LakePrevOutflowValue": "-9999", "ReservoirInitialFillValue": "-9999",
    })
    user = {"PathRoot": root, "PathMaps": f"{root}/maps", "PathTables": f"{root}/tables",
            "PathMeteo": f"{root}/meteo", "PathOut": dirs["out"]}
    lines = ["<?xml version=\"1.0\" encoding=\"UTF-8\"?>", "<lfsettings>", "<lfuser>"]
    lines += [f'  <textvar name="{k}" value="{v}"/>' for k, v in user.items()]
    lines += ["</lfuser>", "<lfoptions>"]
    lines += [f'  <setoption choice="{int(v)}" name="{k}"/>' for k, v in OPTIONS.items()]
    lines += ["</lfoptions>", "<lfbinding>"]
    lines += [f'  <textvar name="{k}" value="{v}"/>' for k, v in binding.items()]
    lines += ["</lfbinding>", "</lfsettings>"]
    settings = os.path.join(root, "settings.xml")
    with open(settings, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    raw = {"land": land, "maps": maps, "tables": tables, "lai": lai, "meteo": meteo,
           "nrows": nrows, "ncols": ncols, "lakes": lakes, "reservoirs": reservoirs,
           "start": start.date()}
    return {"settings": settings, "raw": raw, "no_rout_steps": config["no_rout_steps"]}


def build_program(torch, inputs, traffic, dtype, device):
    """The program's model, as a user's run builds it: the settings read,
    build_model, the days' meteo read from the stacks (kept for
    forcing_ring). Returns (cfg, params, state, aux)."""
    import dataclasses
    from lisflood_tpu_torch.config import load_settings
    from lisflood_tpu_torch.models.initial import build_model, meteo_forcing
    settings = load_settings(inputs["settings"])
    cfg, params, state, aux = build_model(settings)
    cfg = dataclasses.replace(cfg, routing_kernel=traffic["router"])
    inputs["read_forcing"] = meteo_forcing(settings, cfg, aux)
    return cfg, params, state, aux


def forcing_ring(torch, inputs, days, seed, device, dtype):
    """The days the program read, stacked on the device."""
    from lisflood_tpu_torch.device import to_device
    fs = inputs.pop("read_forcing")[:days]
    if len(fs) != days:
        raise ValueError(f"{len(fs)} days read, {days} wanted")
    return to_device({k: np.stack([np.asarray(f[k]) for f in fs]) for k in fs[0]}, device, dtype)


def reference_forcing(inputs, day, ring_forcing):
    """Day `day` of the ring from what was written: the meteo maps on the
    land cells, the calendar day and its LAI interval."""
    raw = inputs["raw"]
    land = raw["land"]
    f = {key: raw["meteo"][name][day].reshape(-1)[land].astype(np.float64)
         for name, key in METEO_KEYS.items()}
    date = raw["start"] + datetime.timedelta(days=int(day))
    cal_day = int(date.strftime("%j"))
    f["CalendarDay"] = np.float64(cal_day)
    f["LAIInterval"] = np.int64(lai_interval(cal_day))
    return f


def reference_model(inputs):
    """The reference's model worked out from what was written: a frozen copy
    of build_model's arithmetic on the main path (models/initial.py), on the
    land cells in row-major order."""
    raw = inputs["raw"]
    land = raw["land"]
    P = int(land.sum())
    b = BINDING
    full = lambda v: np.full(P, float(v))
    mp = lambda name: raw["maps"][name].reshape(-1)[land].astype(np.float64)
    stack3 = lambda a, bb=None, c=None: np.stack([_val(a, mp, full), _val(bb or a, mp, full),
                                                  _val(c or a, mp, full)])
    dt_sec = b["DtSec"]
    dt_day = dt_sec / 86400.0
    T = int(round(dt_sec / b["DtSecChannel"]))
    dt_routing = dt_sec / T
    p, s = {}, {}
    pixel_length, pixel_area = full(CELL), full(CELL * CELL)
    p["PixelLength"], p["PixelArea"] = pixel_length, pixel_area
    p["MMtoM3"] = 0.001 * pixel_area
    p["M3toMM"] = 1.0 / p["MMtoM3"]
    gw_loss = full(b["GwLoss"])
    gw_perc = np.maximum(full(b["GwPercValue"]), gw_loss)
    p["GwPercStep"], p["GwLossStep"] = gw_perc * dt_day, gw_loss * dt_day
    p["PrScaling"], p["CalEvaporation"] = full(b["PrScaling"]), full(b["CalEvaporation"])
    # only the hemisphere enters the step (snow): the laea grid (lat_0 52 N)
    # spans under 3,000 km north and south of its centre, all north
    rows, _ = np.divmod(np.flatnonzero(land), raw["ncols"])
    y = NORTH - CELL * (rows + 0.5)
    p["lat_rad"] = np.radians(52.0 + (y - 3_210_000.0) / 111_195.0)

    fr = {k: mp(k) for k in ("ForestFraction", "DirectRunoffFraction", "WaterFraction",
                             "IrrigationFraction", "RiceFraction", "OtherFraction")}
    p.update(fr)
    p["SoilFraction"] = np.stack([fr["OtherFraction"] + fr["RiceFraction"], fr["ForestFraction"],
                                  fr["IrrigationFraction"]])
    p["PermeableFraction"] = 1 - fr["DirectRunoffFraction"] - fr["WaterFraction"]

    p["DeltaTSnow"] = 0.9674 * mp("ElevationStD") * full(b["TemperatureLapseRate"])
    p["SnowSeason"] = full(b["SnowSeasonAdj"]) * 0.5
    for k in ("TempSnow", "SnowFactor", "SnowMeltCoef", "TempMelt", "Kfrost", "Afrost",
              "FrostIndexThreshold", "SnowWaterEquivalent"):
        p[k] = full(b[k])
    s["SnowCoverS"] = np.zeros((3, P))
    s["FrostIndex"] = np.zeros(P)
    p["kgb"] = 0.75 * full(b["kdf"])
    laix = np.zeros((36, 3, P))
    for i, name in enumerate(("LAIOtherMaps", "LAIForestMaps", "LAIIrrigationMaps")):
        laix[:, i] = raw["lai"][name].reshape(36, -1)[:, land]
    p["LAIX"] = laix

    sd1a = stack3("SoilDepth1", "SoilDepth1Forest")
    sd1b = stack3("SoilDepth2", "SoilDepth2Forest")
    sd2 = stack3("SoilDepth3", "SoilDepth3Forest")
    p["SoilDepth1a"], p["SoilDepth1b"], p["SoilDepth2"] = sd1a, sd1b, sd2
    p["SoilDepthTotal"] = sd1a + sd1b + sd2
    p["CourantCrit"] = b["CourantCrit"]
    p["LeafDrainageK"] = min(dt_day * (1 / b["LeafDrainageTimeConstant"]), 1.0)
    p["AvWaterThreshold"] = b["AvWaterRateThreshold"] * dt_day
    p["CropCoef"] = stack3("MapCropCoef", "MapForestCropCoef", "MapIrrigationCropCoef")
    p["CropGroupNumber"] = stack3("MapCropGroupNumber", "MapForestCropGroupNumber",
                                  "MapIrrigationCropGroupNumber")
    p["NManning"] = np.stack([full(b["MapN"]), full(b["MapForestN"]), full(0.02)])
    ksat1a = stack3("MapKSat1", "MapKSat1Forest")
    ksat1b = stack3("MapKSat2", "MapKSat2Forest")
    ksat2 = stack3("MapKSat3")
    lam = [stack3("MapLambda1", "MapLambda1Forest"), stack3("MapLambda2", "MapLambda2Forest"),
           stack3("MapLambda3")]
    alpha = [stack3("MapGenuAlpha1", "MapGenuAlpha1Forest"),
             stack3("MapGenuAlpha2", "MapGenuAlpha2Forest"), stack3("MapGenuAlpha3")]
    ths = [stack3("MapThetaSat1", "MapThetaSat1Forest"),
           stack3("MapThetaSat2", "MapThetaSat2Forest"), stack3("MapThetaSat3")]
    thr = [stack3("MapThetaRes1", "MapThetaRes1Forest"),
           stack3("MapThetaRes2", "MapThetaRes2Forest"), stack3("MapThetaRes3")]
    p["KSat1a"], p["KSat1b"], p["KSat2"] = ksat1a, ksat1b, ksat2
    wfc, wwp = {}, {}
    for i, (layer, sd) in enumerate((("1a", sd1a), ("1b", sd1b), ("2", sd2))):
        n = 1 + lam[i]
        m = lam[i] / n
        p[f"GenuM{layer}"], p[f"GenuInvM{layer}"] = m, 1 / m
        ws, wres = ths[i] * sd, thr[i] * sd
        p[f"WS{layer}"], p[f"WRes{layer}"] = ws, wres
        wfc[layer] = mualem(wres, ws, alpha[i], n, m, 100.0)
        wwp[layer] = mualem(wres, ws, alpha[i], n, m, 15000.0)
        if layer == "1a":
            p["WPF3a"] = mualem(wres, ws, alpha[i], n, m, 1000.0)
        p[f"PoreSpaceNotZero{layer}"] = (sd != 0) & (ws != 0)
    p["WS1"] = p["WS1a"] + p["WS1b"]
    p["WRes1"] = p["WRes1a"] + p["WRes1b"]
    p["WFC1a"], p["WFC1b"], p["WFC2"] = wfc["1a"], wfc["1b"], wfc["2"]
    p["WFC1"] = wfc["1a"] + wfc["1b"]
    p["WWP1a"], p["WWP1b"], p["WWP2"] = wwp["1a"], wwp["1b"], wwp["2"]
    p["WWP1"] = wwp["1a"] + wwp["1b"]
    for layer in ("1a", "1b", "2"):
        s[{"1a": "W1a", "1b": "W1b", "2": "W2"}[layer]] = np.where(
            p[f"PoreSpaceNotZero{layer}"], wfc[layer], 0)
    p["b_Xinanjiang"] = full(b["b_Xinanjiang"])
    p["PowerInfPot"] = (p["b_Xinanjiang"] + 1) / p["b_Xinanjiang"]
    p["StoreMaxPervious"] = p["WS1"] / (p["b_Xinanjiang"] + 1)
    p["PowerPrefFlow"] = full(b["PowerPrefFlow"])
    s["DSLR"] = np.ones((3, P))
    s["CumInterception"] = np.zeros((3, P))
    s["CumInterSealed"] = np.zeros(P)
    p["SMaxSealed"] = full(b["SMaxSealed"])
    for k in ("TotalPrecipitation", "TaCUM", "TaInterceptionCUM", "ESActCUM", "GwLossCUM",
              "LZInflowCUM"):
        s[k] = np.zeros(P)
    uz_tc, lz_tc = full(b["UpperZoneTimeConstant"]), full(b["LowerZoneTimeConstant"])
    p["UpperZoneK"] = np.minimum(dt_day / uz_tc, 1)
    p["LowerZoneK"] = np.minimum(dt_day / lz_tc, 1)
    s["LZ"] = np.minimum(mp("LZAvInflowMap"), gw_perc - gw_loss) * lz_tc
    p["LZThreshold"] = np.zeros(P)
    s["UZ"] = np.zeros((3, P))

    # the graphs on the land cells (the whole grid drains inside the mask)
    index = -np.ones(land.size, np.int64)
    index[land] = np.arange(P)
    down_grid = _grid_down(raw["maps"]["Ldd"], raw["nrows"], raw["ncols"])
    down_full = np.where(down_grid[land] >= 0, index[np.maximum(down_grid[land], 0)], -1)
    is_channel = raw["maps"]["Channels"].reshape(-1)[land] > 0
    down_chan = np.where(is_channel, down_full, -1)
    down_tochan = np.where(is_channel, -1, down_full)
    beta = b["beta"]
    p["Beta"] = beta
    chan_length = mp("ChanLength")
    p["ChanLength"] = chan_length
    p["IsChannel"], p["IsChannelKinematic"] = is_channel, is_channel.copy()
    p["AtLastPointC"] = down_full < 0
    catchments = catchment_labels(down_full)
    p["Catchments"] = catchments
    p["CatchArea"] = np.bincount(catchments, weights=pixel_area)[catchments]
    downstruct = np.where(down_chan >= 0, down_chan, P).astype(np.int64)
    p["downstruct"] = downstruct

    chan_grad = np.maximum(mp("ChanGrad"), full(b["ChanGradMin"]))
    chan_man = full(b["CalChanMan"]) * mp("ChanMan")
    chan_bw, depth = mp("ChanBottomWidth"), mp("ChanDepthThreshold")
    sdxdy = full(b["ChanSdXdY"])
    upper = chan_bw + 2 * sdxdy * depth
    p["ChanBottomWidth"], p["ChanUpperWidth"] = chan_bw, upper
    bankfull = 0.5 * depth * (upper + chan_bw)
    p["TotalCrossSectionAreaBankFull"] = bankfull
    total_csa = 0.5 * bankfull
    wd_alpha = np.where(is_channel, 0.5 * depth, 0.0)
    wetted = chan_bw + 2 * np.sqrt(np.square(wd_alpha) + np.square(wd_alpha * sdxdy))
    alp_pow = 2.0 / 3.0 * beta
    alpha1 = (chan_man / np.sqrt(chan_grad)) ** beta * wetted ** alp_pow
    p["ChannelAlpha"] = alpha1
    chan_m3 = total_csa * chan_length
    chan_q_kin = np.where(alpha1 > 0, (total_csa / alpha1) ** (1 / beta), 0)
    for k in ("CumQ", "avgdis", "DischargeM3Out", "TotalQInM3", "sumDis", "sumInWB", "EvaCumM3",
              "PaddyRiceWaterAbstractionFromSurfaceWaterM3"):
        s[k] = np.zeros(P)
    s["CrossSection2Area"], s["Sideflow1Chan"] = np.zeros(P), np.zeros(P)
    s["ChanQ"] = chan_q_kin

    for k in ("OFM3Other", "OFM3Forest", "OFM3Direct", "OFQDirect", "OFQOther", "OFQForest"):
        s[k] = np.zeros(P)
    grad = np.maximum(mp("Grad"), full(b["GradMin"]))
    of_wetted = pixel_length + 2 * 0.001 * full(b["OFDepRef"])
    p["OFAlpha"] = (p["NManning"] / np.sqrt(grad)) ** beta * of_wetted ** alp_pow

    is_structure = np.zeros(P, bool)
    tab = raw["tables"]
    lake_sites = raw["maps"]["LakeSites"].reshape(-1)[land] * is_channel
    lake_index = np.flatnonzero(lake_sites >= 1)
    lake_ids = lake_sites[lake_index].astype(np.int64) - 1
    is_structure[lake_index] = True
    p["LakeIndex"] = lake_index
    area = tab["TabLakeArea"][lake_ids]
    lake_a = tab["TabLakeA"][lake_ids] * b["LakeMultiplier"]
    p["LakeAreaCC"] = area
    avnet = tab["TabLakeAvNetInflowEstimate"][lake_ids]
    storage = area * np.sqrt(avnet / lake_a)
    factor = area / (dt_routing * np.sqrt(lake_a))
    p["LakeFactor"], p["LakeFactorSqr"] = factor, factor ** 2
    si = storage / dt_routing + avnet / 2
    s["LakeStorageM3CC"], s["LakeStorageM3BalanceCC"] = storage.copy(), storage.copy()
    s["LakeInflowOldCC"] = np.bincount(downstruct, weights=s["ChanQ"], minlength=P + 1)[lake_index]
    s["LakeOutflowCC"] = np.square(-factor + np.sqrt(factor ** 2 + 2 * si))
    s["LakeLevelCC"] = storage / area
    lake_m3 = np.zeros(P)
    lake_m3[lake_index] = storage
    s["LakeStorageM3"] = lake_m3.copy()
    s["EWLakeCUMM3"] = np.zeros(P)

    res_sites = raw["maps"]["ReservoirSites"].reshape(-1)[land] * is_channel
    res_index = np.flatnonzero(res_sites >= 1)
    res_ids = res_sites[res_index].astype(np.int64) - 1
    is_structure[res_index] = True
    p["ReservoirIndex"] = res_index
    tot = tab["TabTotStorage"][res_ids]
    cons = tab["TabConservativeStorageLimit"][res_ids]
    normal = tab["TabNormalStorageLimit"][res_ids]
    flood = tab["TabFloodStorageLimit"][res_ids]
    nondam = tab["TabNonDamagingOutflowQ"][res_ids]
    normal_q = tab["TabNormalOutflowQ"][res_ids] * b["ReservoirRnormqMult"]
    min_q = tab["TabMinOutflowQ"][res_ids]
    normal_flood = normal + b["adjust_Normal_Flood"] * (flood - normal)
    normal_q = np.where(normal_q > min_q, normal_q, min_q + 0.01)
    normal_q = np.where(normal_q < nondam, normal_q, nondam - 0.01)
    p.update(TotalReservoirStorageM3CC=tot, ConservativeStorageLimitCC=cons,
             NormalStorageLimitCC=normal, FloodStorageLimitCC=flood,
             Normal_FloodStorageLimitCC=normal_flood, NonDamagingReservoirOutflowCC=nondam,
             NormalReservoirOutflowCC=normal_q, MinReservoirOutflowCC=min_q,
             DeltaO=normal_q - min_q, DeltaLN=normal - 2 * cons, DeltaNFL=flood - normal_flood)
    s["ReservoirFillCC"] = normal.copy()
    s["ReservoirStorageM3CC"] = normal * tot
    res_m3 = np.zeros(P)
    res_m3[res_index] = normal * tot
    s["ReservoirStorageM3"] = res_m3.copy()

    is_ups = np.zeros(P, bool)
    ok = down_chan >= 0
    is_ups[ok] = is_structure[down_chan[ok]]
    p["IsUpsOfStructureKinematicC"] = is_ups
    down_kin = np.where(is_ups, -1, down_chan)

    alpha2 = (chan_man / full(b["CalChanMan"]) * full(b["CalChanMan2"]) / np.sqrt(chan_grad)) \
        ** beta * wetted ** alp_pow
    p["ChannelAlpha2"] = alpha2
    qlimit = mp("AvgDis") * full(b["QSplitMult"])
    p["QLimit"] = qlimit
    p["M3Limit"] = alpha1 * chan_length * qlimit ** beta
    chan2_start = alpha2 * chan_length * qlimit ** beta
    p["Chan2M3Start"] = chan2_start
    p["Chan2QStart"] = qlimit - upstream_sum(down_kin, qlimit)
    chan2_m3 = s["CrossSection2Area"] * chan_length + chan2_start
    chan_m3_kin = chan_m3 - chan2_m3 + chan2_start
    chan_m3_kin = np.where((chan_m3_kin < 0.0) & (chan_m3_kin > -0.0000001), 0.0, chan_m3_kin)
    s["Chan2M3Kin"], s["ChanM3Kin"] = chan2_m3, chan_m3_kin
    s["Chan2QKin"] = (chan2_m3 / chan_length / alpha2) ** (1 / beta)
    s["ChanQKin"] = (chan_m3_kin / chan_length / alpha1) ** (1 / beta)

    lake_mask = raw["maps"]["LakeMask"].reshape(-1)[land] != 0
    p["downEva"] = np.where(lake_mask & (down_chan >= 0), down_chan, P)
    p["maxNoEva"] = int(b["maxNoEva"])

    # the mass balance's carried terms at the start (waterbalance.py:44-112,
    # routing.py split-routing balance)
    ct = lambda v: np.bincount(catchments, weights=v, minlength=catchments.max() + 1)[catchments]
    hill1 = (p["SoilFraction"] * (s["CumInterception"] + s["W1a"] + s["W1b"] + s["W2"]
                                   + s["UZ"])).sum(0) + s["LZ"]
    hillslope = (0.0 + hill1 + p["DirectRunoffFraction"] * s["CumInterSealed"]) * p["MMtoM3"]
    s["WaterInit"] = ct(chan_m3 + lake_m3 + res_m3) + ct(hillslope)
    s["StorageStepINIT"] = ct(s["ChanM3Kin"] + s["Chan2M3Kin"] - chan2_start + res_m3 + lake_m3)
    s["DischargeM3StructuresIni"] = ct(np.where(is_ups, s["ChanQ"] * dt_routing, 0))
    s["TimeSinceStart"] = np.float64(0.0)
    cfg = {"no_rout_steps": T, "dt_sec": dt_sec, "num_lakes": lake_index.size,
           "num_reservoirs": res_index.size, "num_catchments": int(catchments.max()) + 1,
           "open_water_evapo": True, "rep_mbts": True, "max_no_eva": int(b["maxNoEva"]),
           "max_soil_substeps": 100}
    return {"cfg": cfg, "params": p, "state": s, "down_kin": down_kin, "down_order": down_chan,
            "downstruct": down_chan, "down_tochan": down_tochan}


def _val(name, mp, full):
    """A binding's value on every cell: its map where it names one."""
    return full(BINDING[name]) if name in BINDING else mp(name)


def _grid_down(codes, nrows, ncols):
    """The downstream cell of every grid cell from its LDD keypad code, -1
    at a pit or where it would leave the grid."""
    from ..reference.graph import LDD_OFFSETS
    codes = np.asarray(codes).reshape(-1)
    r, c = np.divmod(np.arange(codes.size), ncols)
    down = -np.ones(codes.size, np.int64)
    for code, (dr, dc) in LDD_OFFSETS.items():
        sel = codes == code
        r2, c2 = r[sel] + dr, c[sel] + dc
        inside = (r2 >= 0) & (r2 < nrows) & (c2 >= 0) & (c2 < ncols)
        down[np.flatnonzero(sel)[inside]] = r2[inside] * ncols + c2[inside]
    return down

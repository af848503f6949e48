"""Model initialisation: load every static parameter and the initial state.

The port's copy of lisflood_tpu/models/initial.py: for the same settings it
returns the same NumPy (config, params, state, aux), key for key and bit for
bit, with the port's ModelConfig. This is the equivalent of the reference's
LisfloodModel_ini and the per-module initial() chain (Lisflood_initial.py:83-250); each section
below cites the reference module it reproduces. The result is three plain
dicts — `params` (static arrays), `state` (prognostic variables) — plus
the routing graphs/schedules; all arrays are NumPy here and converted to
device arrays by the step builder.

Data layout: per-pixel (P,), per-vegetation / per-landuse (3, P) with
vegetation order [Rainfed, Forest, Irrigated] matching landuse order
(Lisflood_initial.py:108-113), per-runoff-lane (3, P) [Other, Forest,
Direct], and dense per-object vectors for lakes / reservoirs.
"""
from __future__ import annotations

import warnings
from types import SimpleNamespace

import numpy as np
import torch

from ..config.calendar import parse_date_or_step
from ..graph import (build_flow_graph, build_schedule, cut_structures, direction_codes,
                     ldd_mask, ldd_to_channel)
from ..io import MapLoader, NcFile, build_grid
from ..io.forcing import ForcingReader, run_dates
from ..io.loadmap import _normalize_xy
from ..io.projection import read_lat_from_template
from ..io.tables import lookup_scalar
from ..ops.indicators import indicator_state_zero
from ..utils.errors import LisfloodError, LisfloodWarning
from .config import ModelConfig

VEG_ORDER = ("Rainfed", "Forest", "Irrigated")       # vegetation == landuse index
RUNOFF_ORDER = ("Other", "Forest", "Direct")

# Days delimiting the 36 prescribed-LAI intervals (leafarea.py:50-51)
LAI_INTERVAL_STARTS = [1, 11, 21, 32, 42, 52, 60, 70, 80, 91, 101, 111, 121, 131,
                       141, 152, 162, 172, 182, 192, 202, 213, 223, 233, 244, 254,
                       264, 274, 284, 294, 305, 315, 325, 335, 345, 355, 370]


def _field(value, P):
    """Broadcast a loadmap result (python float or (P,)) to (P,) float64."""
    if np.isscalar(value):
        return np.full(P, float(value), dtype=np.float64)
    return np.asarray(value, dtype=np.float64)


def _stack3(loader, name1, name2=None, name3=None, P=None):
    """defsoil: per-landuse (3, P) parameter, missing names fall back to the
    first (reference add1.py:64-88)."""
    v1 = loader.load(name1)
    v2 = loader.load(name2) if name2 is not None and isinstance(name2, str) else (name2 if name2 is not None else v1)
    v3 = loader.load(name3) if name3 is not None and isinstance(name3, str) else (name3 if name3 is not None else v1)
    return np.stack([_field(v1, P), _field(v2, P), _field(v3, P)])


def _stack_slices(path, grid, n):
    """The first `n` maps of the netCDF stack `path`, each turned to x
    ascending and y descending and cut to the grid's window. The JAX
    package cuts them as stored, so that a stack with x descending (or y
    ascending) is read mirrored (ROADMAP.md Queue 3)."""
    with NcFile(path) as nc:
        varname = nc.main_variable()
        xd, yd = nc.spatial_dims
        x, y = nc.coord(xd), nc.coord(yd)
        c0, c1, c2, c3 = grid.cut_window(np.sort(x), np.sort(y)[::-1])
        for i in range(n):
            yield _normalize_xy(nc.read(varname, index=i), x, y)[0][c2:c3, c0:c1]


def mualem(residual, sat, alpha, n, m, pressure):
    """Soil moisture at a pressure head (van Genuchten / Mualem;
    reference soil.py:30-35)."""
    return residual + (sat - residual) / ((1 + (alpha * pressure) ** n) ** m)


def build_model(settings, dtype=np.float64):
    """Build (config, params, state, aux) from parsed settings."""
    binding = settings.binding
    option = settings.options

    # ---------------- grid / mask (add1.py:168-265) ----------------------
    grid0 = build_grid(binding["MaskMap"])
    loader0 = MapLoader(settings, grid0)
    ldd2d = loader0.load_2d("Ldd")
    grid = build_grid(binding["MaskMap"], ldd2d=ldd2d)
    loader = MapLoader(settings, grid)
    P = grid.num_pixels

    params = {}
    state = {}
    aux = {"grid": grid, "loader": loader}

    # ---------------- misc (miscInitial.py:44-181) ------------------------
    dt_sec = float(loader.load("DtSec"))
    dt_day = dt_sec / 86400.0
    if option["gridSizeUserDefined"]:
        pixel_length = _field(loader.load("PixelLengthUser"), P)
        pixel_area = _field(loader.load("PixelAreaUser"), P)
    else:
        pixel_length = np.full(P, grid.cell)
        pixel_area = np.full(P, grid.cell**2)
    params["PixelLength"] = pixel_length
    params["PixelArea"] = pixel_area
    params["MMtoM3"] = 0.001 * pixel_area
    params["M3toMM"] = 1.0 / params["MMtoM3"]

    gw_loss = _field(loader.load("GwLoss"), P)
    gw_perc = np.maximum(_field(loader.load("GwPercValue"), P), gw_loss)
    params["GwLoss"] = gw_loss
    params["GwPerc"] = gw_perc
    params["GwPercStep"] = gw_perc * dt_day
    params["GwLossStep"] = gw_loss * dt_day
    params["PrScaling"] = _field(loader.load("PrScaling"), P)
    params["CalEvaporation"] = _field(loader.load("CalEvaporation"), P)
    aux["CalendarDayStart"] = parse_date_or_step(binding["CalendarDayStart"], binding["calendar_type"])
    lat_deg = read_lat_from_template(binding, grid)
    params["lat_rad"] = np.radians(lat_deg)

    # ---------------- land use fractions (landusechange.py:53-92) ---------
    if option.get("TransientLandUseChange"):
        # initial fractions come from the yearly stacks at the first model
        # step (landusechange.py:70-78); they are re-read every step by the
        # driver and override these inside the jitted step
        first_date = run_dates(settings)[0]

        def _stack_first(map_key):
            r = ForcingReader(binding[map_key], grid, [first_date],
                              indexer="closest", prefetch=0)
            try:
                return r[0]
            finally:
                r.close()

        forest_frac = _stack_first("ForestFractionMaps")
        direct_frac = _stack_first("DirectRunoffFractionMaps")
        water_frac = _stack_first("WaterFractionMaps")
        irrig_frac = _stack_first("IrrigationFractionMaps")
        rice_frac = _stack_first("RiceFractionMaps")
        other_frac = _stack_first("OtherFractionMaps")
    else:
        forest_frac = _field(loader.load("ForestFraction", timestampflag="closest"), P)
        direct_frac = _field(loader.load("DirectRunoffFraction", timestampflag="closest"), P)
        water_frac = _field(loader.load("WaterFraction", timestampflag="closest"), P)
        irrig_frac = _field(loader.load("IrrigationFraction", timestampflag="closest"), P)
        rice_frac = _field(loader.load("RiceFraction", timestampflag="closest"), P)
        other_frac = _field(loader.load("OtherFraction", timestampflag="closest"), P)
    soil_fraction = np.stack([other_frac, forest_frac, irrig_frac])
    # rice treated as part of the Rainfed soil fraction (soil.py:92-93)
    soil_fraction[0] = soil_fraction[0] + rice_frac
    params["SoilFraction"] = soil_fraction
    params["ForestFraction"] = forest_frac
    params["DirectRunoffFraction"] = direct_frac
    params["WaterFraction"] = water_frac
    params["IrrigationFraction"] = irrig_frac
    params["RiceFraction"] = rice_frac
    params["OtherFraction"] = other_frac
    params["PermeableFraction"] = 1 - direct_frac - water_frac

    # ---------------- snow (snow.py:54-93) --------------------------------
    params["DeltaTSnow"] = 0.9674 * _field(loader.load("ElevationStD"), P) * _field(loader.load("TemperatureLapseRate"), P)
    params["SnowSeason"] = _field(loader.load("SnowSeasonAdj"), P) * 0.5
    params["TempSnow"] = _field(loader.load("TempSnow"), P)
    params["SnowFactor"] = _field(loader.load("SnowFactor"), P)
    params["SnowMeltCoef"] = _field(loader.load("SnowMeltCoef"), P)
    params["TempMelt"] = _field(loader.load("TempMelt"), P)
    snow_init = np.stack([
        _field(loader.load("SnowCoverAInitValue"), P),
        _field(loader.load("SnowCoverBInitValue"), P),
        _field(loader.load("SnowCoverCInitValue"), P),
    ])
    state["SnowCoverS"] = snow_init
    aux["SnowCoverInit"] = snow_init.sum(0) / 3

    # ---------------- frost (frost.py:43-57) ------------------------------
    params["Kfrost"] = _field(loader.load("Kfrost"), P)
    params["Afrost"] = _field(loader.load("Afrost"), P)
    params["FrostIndexThreshold"] = _field(loader.load("FrostIndexThreshold"), P)
    params["SnowWaterEquivalent"] = _field(loader.load("SnowWaterEquivalent"), P)
    state["FrostIndex"] = _field(loader.load("FrostIndexInitValue"), P)

    # ---------------- leaf area (leafarea.py:44-71) -----------------------
    params["kgb"] = 0.75 * _field(loader.load("kdf"), P)
    lai_maps = {"Rainfed": "LAIOtherMaps", "Forest": "LAIForestMaps", "Irrigated": "LAIIrrigationMaps"}
    laix = np.zeros((36, 3, P))
    for iveg, veg in enumerate(VEG_ORDER):
        path = binding[lai_maps[veg]]
        for i, data in enumerate(_stack_slices(path, grid, 36)):
            laix[i, iveg] = grid.compress(data, check_name=path)
    params["LAIX"] = laix
    # calendar day -> interval lookup (leafarea.py:65-70)
    lai_day_to_interval = np.zeros(367, dtype=np.int32)
    j = 0
    for i in range(367):
        if i >= LAI_INTERVAL_STARTS[j + 1]:
            j += 1
        lai_day_to_interval[i] = j
    aux["lai_day_to_interval"] = lai_day_to_interval

    # ---------------- soil hydraulics (soil.py:71-470) --------------------
    sd1a = _stack3(loader, "SoilDepth1", "SoilDepth1Forest", P=P)
    sd1b = _stack3(loader, "SoilDepth2", "SoilDepth2Forest", P=P)
    sd2 = _stack3(loader, "SoilDepth3", "SoilDepth3Forest", P=P)
    params["SoilDepth1a"], params["SoilDepth1b"], params["SoilDepth2"] = sd1a, sd1b, sd2
    params["SoilDepthTotal"] = sd1a + sd1b + sd2

    params["CourantCrit"] = float(loader.load("CourantCrit"))
    params["LeafDrainageK"] = min(dt_day * (1 / float(loader.load("LeafDrainageTimeConstant"))), 1.0)
    params["AvWaterThreshold"] = float(loader.load("AvWaterRateThreshold")) * dt_day

    params["CropCoef"] = _stack3(loader, "MapCropCoef", "MapForestCropCoef", "MapIrrigationCropCoef", P=P)
    params["CropGroupNumber"] = _stack3(loader, "MapCropGroupNumber", "MapForestCropGroupNumber", "MapIrrigationCropGroupNumber", P=P)
    params["NManning"] = _stack3(loader, "MapN", "MapForestN", 0.02, P=P)  # runoff lanes [Other, Forest, Direct]

    ksat1a = _stack3(loader, "MapKSat1", "MapKSat1Forest", P=P)
    ksat1b = _stack3(loader, "MapKSat2", "MapKSat2Forest", P=P)
    ksat2 = _stack3(loader, "MapKSat3", P=P)
    lam1a = _stack3(loader, "MapLambda1", "MapLambda1Forest", P=P)
    lam1b = _stack3(loader, "MapLambda2", "MapLambda2Forest", P=P)
    lam2 = _stack3(loader, "MapLambda3", P=P)
    alpha1a = _stack3(loader, "MapGenuAlpha1", "MapGenuAlpha1Forest", P=P)
    alpha1b = _stack3(loader, "MapGenuAlpha2", "MapGenuAlpha2Forest", P=P)
    alpha2 = _stack3(loader, "MapGenuAlpha3", P=P)
    thetas1a = _stack3(loader, "MapThetaSat1", "MapThetaSat1Forest", P=P)
    thetas1b = _stack3(loader, "MapThetaSat2", "MapThetaSat2Forest", P=P)
    thetas2 = _stack3(loader, "MapThetaSat3", P=P)
    thetar1a = _stack3(loader, "MapThetaRes1", "MapThetaRes1Forest", P=P)
    thetar1b = _stack3(loader, "MapThetaRes2", "MapThetaRes2Forest", P=P)
    thetar2 = _stack3(loader, "MapThetaRes3", P=P)

    params["KSat1a"], params["KSat1b"], params["KSat2"] = ksat1a, ksat1b, ksat2
    n1a, n1b, n2 = 1 + lam1a, 1 + lam1b, 1 + lam2
    m1a, m1b, m2 = lam1a / n1a, lam1b / n1b, lam2 / n2
    params["GenuM1a"], params["GenuM1b"], params["GenuM2"] = m1a, m1b, m2
    params["GenuInvM1a"], params["GenuInvM1b"], params["GenuInvM2"] = 1 / m1a, 1 / m1b, 1 / m2
    params["GenuInvN1a"], params["GenuInvN1b"], params["GenuInvN2"] = 1 / n1a, 1 / n1b, 1 / n2
    params["GenuInvAlpha1a"], params["GenuInvAlpha1b"], params["GenuInvAlpha2"] = 1 / alpha1a, 1 / alpha1b, 1 / alpha2
    if option.get("simulatePF"):
        # pF diagnostics cap (soil.py:466; used by suctionUnsaturatedSoilPF,
        # soilloop.py:673-704)
        params["HeadMax"] = float(np.asarray(loader.load("HeadMax")).ravel()[0])

    ws1a, ws1b, ws2 = thetas1a * sd1a, thetas1b * sd1b, thetas2 * sd2
    wres1a, wres1b, wres2 = thetar1a * sd1a, thetar1b * sd1b, thetar2 * sd2
    params["WS1a"], params["WS1b"], params["WS2"] = ws1a, ws1b, ws2
    params["WS1"] = ws1a + ws1b
    params["WRes1a"], params["WRes1b"], params["WRes2"] = wres1a, wres1b, wres2
    params["WRes1"] = wres1a + wres1b

    wfc1a = mualem(wres1a, ws1a, alpha1a, n1a, m1a, 100.0)
    wfc1b = mualem(wres1b, ws1b, alpha1b, n1b, m1b, 100.0)
    wfc2 = mualem(wres2, ws2, alpha2, n2, m2, 100.0)
    params["WFC1a"], params["WFC1b"], params["WFC2"] = wfc1a, wfc1b, wfc2
    params["WFC1"] = wfc1a + wfc1b
    wpf3a = mualem(wres1a, ws1a, alpha1a, n1a, m1a, 1000.0)
    wpf3b = mualem(wres1b, ws1b, alpha1b, n1b, m1b, 1000.0)
    params["WPF3a"], params["WPF3b"] = wpf3a, wpf3b
    wwp1a = mualem(wres1a, ws1a, alpha1a, n1a, m1a, 15000.0)
    wwp1b = mualem(wres1b, ws1b, alpha1b, n1b, m1b, 15000.0)
    wwp2 = mualem(wres2, ws2, alpha2, n2, m2, 15000.0)
    params["WWP1a"], params["WWP1b"], params["WWP2"] = wwp1a, wwp1b, wwp2
    params["WWP1"] = wwp1a + wwp1b

    psnz1a = (sd1a != 0) & (ws1a != 0)
    psnz1b = (sd1b != 0) & (ws1b != 0)
    psnz2 = (sd2 != 0) & (ws2 != 0)
    params["PoreSpaceNotZero1a"], params["PoreSpaceNotZero1b"], params["PoreSpaceNotZero2"] = psnz1a, psnz1b, psnz2

    # initial soil moisture: -9999 -> field capacity (soil.py:230-277)
    theta_init = {
        "Rainfed": ("ThetaInit1Value", "ThetaInit2Value", "ThetaInit3Value"),
        "Forest": ("ThetaForestInit1Value", "ThetaForestInit2Value", "ThetaForestInit3Value"),
        "Irrigated": ("ThetaIrrigationInit1Value", "ThetaIrrigationInit2Value", "ThetaIrrigationInit3Value"),
    }
    w1a = np.zeros((3, P))
    w1b = np.zeros((3, P))
    w2 = np.zeros((3, P))
    for i, veg in enumerate(VEG_ORDER):
        k1, k2, k3 = theta_init[veg]
        t1 = _field(loader.load(k1), P)
        t2 = _field(loader.load(k2), P)
        t3 = _field(loader.load(k3), P)
        w1a[i] = np.where(psnz1a[i], np.where(t1 == -9999, wfc1a[i], t1 * sd1a[i]), 0)
        w1b[i] = np.where(psnz1b[i], np.where(t2 == -9999, wfc1b[i], t2 * sd1b[i]), 0)
        w2[i] = np.where(psnz2[i], np.where(t3 == -9999, wfc2[i], t3 * sd2[i]), 0)
    state["W1a"], state["W1b"], state["W2"] = w1a, w1b, w2

    params["b_Xinanjiang"] = _field(loader.load("b_Xinanjiang"), P)
    params["PowerInfPot"] = (params["b_Xinanjiang"] + 1) / params["b_Xinanjiang"]
    params["StoreMaxPervious"] = params["WS1"] / (params["b_Xinanjiang"] + 1)
    params["PowerPrefFlow"] = _field(loader.load("PowerPrefFlow"), P)

    dslr = np.stack([
        _field(loader.load("DSLRInitValue"), P),
        _field(loader.load("DSLRForestInitValue"), P),
        _field(loader.load("DSLRIrrigationInitValue"), P),
    ])
    state["DSLR"] = np.maximum(dslr, 1.0)
    state["CumInterception"] = np.stack([
        _field(loader.load("CumIntInitValue"), P),
        _field(loader.load("CumIntForestInitValue"), P),
        _field(loader.load("CumIntIrrigationInitValue"), P),
    ])
    state["CumInterSealed"] = _field(loader.load("CumIntSealedInitValue"), P)
    params["SMaxSealed"] = _field(loader.load("SMaxSealed"), P)
    params["DrainedFraction"] = float(loader.load("DrainedFraction")) if option["drainedIrrigation"] else 0.0

    # cumulative water-balance accumulators (soil.py:410-417)
    for key in ("TotalPrecipitation", "TaCUM", "TaInterceptionCUM", "ESActCUM"):
        state[key] = np.zeros(P)

    # ---------------- groundwater (groundwater.py:44-132) -----------------
    uz_tc = _field(loader.load("UpperZoneTimeConstant"), P)
    lz_tc = _field(loader.load("LowerZoneTimeConstant"), P)
    params["UpperZoneK"] = np.minimum(dt_day / uz_tc, 1)
    params["LowerZoneK"] = np.minimum(dt_day / lz_tc, 1)
    if option["InitLisflood"]:
        lz_av_inflow_guess = gw_perc - gw_loss
    else:
        lz_av_inflow_guess = np.minimum(_field(loader.load("LZAvInflowMap"), P), gw_perc - gw_loss)
    lz_steady = lz_av_inflow_guess * lz_tc
    lz_init = _field(loader.load("LZInitValue"), P)
    state["LZ"] = np.where(lz_init == -9999, lz_steady, lz_init)
    params["LZThreshold"] = _field(loader.load("LZThreshold"), P)
    state["UZ"] = np.stack([
        _field(loader.load("UZInitValue"), P),
        _field(loader.load("UZForestInitValue"), P),
        _field(loader.load("UZIrrigationInitValue"), P),
    ])
    state["GwLossCUM"] = np.zeros(P)
    state["LZInflowCUM"] = np.zeros(P)

    # ---------------- routing graph + channel (routing.py:61-339) ---------
    beta = float(loader.load("beta"))
    params["Beta"] = beta
    chan_length = _field(loader.load("ChanLength"), P)
    params["ChanLength"] = chan_length
    no_rout_steps = max(1, int(round(dt_sec / float(loader.load("DtSecChannel")))))
    if option["InitLisflood"]:
        no_rout_steps = 1
    dt_routing = dt_sec / no_rout_steps

    ldd = loader.load("Ldd")
    graph_full = build_flow_graph(ldd, grid)
    params["UpArea"] = graph_full.accuflux(pixel_area)
    is_channel = _field(loader.load("Channels"), P) > 0
    params["IsChannel"] = is_channel
    params["IsChannelKinematic"] = is_channel.copy()
    ldd_chan = ldd_mask(ldd, is_channel)

    ldd_tochan = ldd_to_channel(ldd, is_channel)
    graph_tochan = build_flow_graph(ldd_tochan, grid)

    at_last_point = graph_full.is_pit
    params["AtLastPointC"] = at_last_point
    catchments = graph_full.catchment_labels()
    params["Catchments"] = catchments
    catch_area = np.bincount(catchments, weights=pixel_area)[catchments]
    params["CatchArea"] = catch_area

    graph_chan = build_flow_graph(ldd_chan, grid)
    # downstream index on the *uncut* channel ldd: feeds structure inflow
    # (routing.py:159-164; structures keep LddStructuresKinematic)
    downstruct = np.full(P + 1, P, dtype=np.int32)
    valid = graph_chan.downstream >= 0
    downstruct[:P][valid] = graph_chan.downstream[valid]
    params["downstruct"] = downstruct[:P]

    # channel geometry (routing.py:184-250)
    chan_grad = np.maximum(_field(loader.load("ChanGrad"), P), _field(loader.load("ChanGradMin"), P))
    cal_chan_man = _field(loader.load("CalChanMan"), P)
    chan_man = cal_chan_man * _field(loader.load("ChanMan"), P)
    chan_bw = _field(loader.load("ChanBottomWidth"), P)
    chan_depth_th = _field(loader.load("ChanDepthThreshold"), P)
    chan_sdxdy = _field(loader.load("ChanSdXdY"), P)
    chan_upper_w = chan_bw + 2 * chan_sdxdy * chan_depth_th
    params["ChanBottomWidth"] = chan_bw
    params["ChanUpperWidth"] = chan_upper_w
    params["TotalCrossSectionAreaBankFull"] = 0.5 * chan_depth_th * (chan_upper_w + chan_bw)
    tcsa_half = 0.5 * params["TotalCrossSectionAreaBankFull"]
    tcsa_init = _field(loader.load("TotalCrossSectionAreaInitValue"), P)
    total_csa = np.where(tcsa_init == -9999, tcsa_half, tcsa_init)

    chan_wd_alpha = np.where(is_channel, 0.5 * chan_depth_th, 0.0)
    wetted_perimeter = chan_bw + 2 * np.sqrt(np.square(chan_wd_alpha) + np.square(chan_wd_alpha * chan_sdxdy))
    params["ChanWettedPerimeterAlpha"] = wetted_perimeter
    alp_pow = 2.0 / 3.0 * beta
    channel_alpha = ((chan_man / np.sqrt(chan_grad)) ** beta * wetted_perimeter ** alp_pow).astype(float)
    params["ChannelAlpha"] = channel_alpha
    params["AlpPow"] = alp_pow
    params["ChanGrad"] = chan_grad
    params["ChanMan"] = chan_man
    params["CalChanMan"] = cal_chan_man

    chan_m3 = total_csa * chan_length
    aux["ChanIniM3"] = chan_m3.copy()
    state["ChanM3Kin"] = chan_m3.copy()
    chan_q_kin = np.where(channel_alpha > 0, (total_csa / channel_alpha) ** (1 / beta), 0).astype(float)
    state["ChanQKin"] = chan_q_kin
    state["CumQ"] = np.zeros(P)
    state["avgdis"] = np.zeros(P)

    if option["SplitRouting"]:
        cs2_init = _field(loader.load("CrossSection2AreaInitValue"), P)
        state["CrossSection2Area"] = np.where(cs2_init == -9999, 0.0, cs2_init)
        prev_side = _field(loader.load("PrevSideflowInitValue"), P)
        state["Sideflow1Chan"] = np.where(prev_side == -9999, 0.0, prev_side)

    prev_discharge = _field(loader.load("PrevDischarge"), P)
    state["ChanQ"] = np.where(prev_discharge == -9999, chan_q_kin, prev_discharge)
    state["DischargeM3Out"] = np.zeros(P)
    state["TotalQInM3"] = np.zeros(P)
    state["sumDis"] = np.zeros(P)
    state["sumInWB"] = np.zeros(P)

    # ---------------- surface routing (surface_routing.py:44-113) ---------
    state["OFM3Other"] = _field(loader.load("OFOtherInitValue"), P)
    state["OFM3Forest"] = _field(loader.load("OFForestInitValue"), P)
    state["OFM3Direct"] = _field(loader.load("OFDirectInitValue"), P)
    grad = np.maximum(_field(loader.load("Grad"), P), _field(loader.load("GradMin"), P))
    of_wetted_p = pixel_length + 2 * 0.001 * _field(loader.load("OFDepRef"), P)
    of_alpha = ((params["NManning"] / np.sqrt(grad)) ** beta) * (of_wetted_p**alp_pow)
    params["OFAlpha"] = of_alpha.astype(float)  # (3, P) lanes [Other, Forest, Direct]
    iO, iF, iD = RUNOFF_ORDER.index("Other"), RUNOFF_ORDER.index("Forest"), RUNOFF_ORDER.index("Direct")
    state["OFQDirect"] = (state["OFM3Direct"] / pixel_length / of_alpha[iD]) ** (1 / beta)
    state["OFQOther"] = (state["OFM3Other"] / pixel_length / of_alpha[iO]) ** (1 / beta)
    state["OFQForest"] = (state["OFM3Forest"] / pixel_length / of_alpha[iF]) ** (1 / beta)

    # ---------------- structures: lakes (lakes.py:48-197) -----------------
    is_structure = np.zeros(P, dtype=bool)
    num_lakes = 0
    num_res = 0
    if option["simulateLakes"] and not option["InitLisflood"]:
        lake_sites = _field(loader.load("LakeSites"), P)
        lake_sites[np.isnan(lake_sites)] = 0
        lake_sites[lake_sites < 1] = 0
        lake_sites[~is_channel] = 0
        lake_index = np.nonzero(lake_sites)[0]
        if lake_index.size == 0:
            warnings.warn(LisfloodWarning("There are no lakes. Lakes simulation won't run"))
            option["simulateLakes"] = False
            option["repsimulateLakes"] = False
        else:
            num_lakes = lake_index.size
            is_structure[lake_index] = True
            params["LakeIndex"] = lake_index
            params["LakeSitesC"] = lake_sites
            lake_ids = lake_sites.astype(int)
            params["LakeAreaCC"] = lookup_scalar(binding["TabLakeArea"], lake_ids)[lake_index]
            lake_a = lookup_scalar(binding["TabLakeA"], lake_ids) * _field(loader.load("LakeMultiplier"), P)
            params["LakeACC"] = lake_a[lake_index]
            lake_init_level = _field(loader.load("LakeInitialLevelValue"), P)
            if np.max(lake_init_level) == -9999:
                lake_avnet = lookup_scalar(binding["TabLakeAvNetInflowEstimate"], lake_ids)[lake_index]
                lake_storage_ini = params["LakeAreaCC"] * np.sqrt(lake_avnet / params["LakeACC"])
                lake_level = lake_storage_ini / params["LakeAreaCC"]
            else:
                lake_level = lake_init_level[lake_index]
                lake_storage_ini = params["LakeAreaCC"] * lake_level
                lake_avnet = prev_discharge[lake_index]
            lake_prev_inflow = _field(loader.load("LakePrevInflowValue"), P)
            if np.max(lake_init_level) == -9999:
                seg = np.bincount(params["downstruct"], weights=state["ChanQ"], minlength=P + 1)
                lake_inflow_old = seg[lake_index]
            else:
                lake_inflow_old = lake_prev_inflow[lake_index]
            lake_factor = params["LakeAreaCC"] / (dt_routing * np.sqrt(params["LakeACC"]))
            params["LakeFactor"] = lake_factor
            params["LakeFactorSqr"] = lake_factor**2
            lake_si = lake_storage_ini / dt_routing + lake_avnet / 2
            lake_prev_out = _field(loader.load("LakePrevOutflowValue"), P)
            if np.max(lake_prev_out) == -9999:
                lake_outflow = np.square(-lake_factor + np.sqrt(params["LakeFactorSqr"] + 2 * lake_si))
            else:
                lake_outflow = lake_prev_out[lake_index]
            state["LakeStorageM3CC"] = lake_storage_ini.copy()
            state["LakeStorageM3BalanceCC"] = lake_storage_ini.copy()
            state["LakeInflowOldCC"] = lake_inflow_old
            state["LakeOutflowCC"] = lake_outflow
            state["LakeLevelCC"] = lake_level
            lake_storage_ini_m3 = np.zeros(P)
            lake_storage_ini_m3[lake_index] = lake_storage_ini
            params["LakeStorageIniM3"] = lake_storage_ini_m3
            state["LakeStorageM3"] = lake_storage_ini_m3.copy()
            state["EWLakeCUMM3"] = np.zeros(P)

    # ---------------- structures: reservoirs (reservoir.py:52-171) --------
    if option["simulateReservoirs"] and not option["InitLisflood"]:
        res_sites = _field(loader.load("ReservoirSites"), P)
        res_sites[np.isnan(res_sites)] = 0
        res_sites[res_sites < 1] = 0
        res_sites[~is_channel] = 0
        res_index = np.nonzero(res_sites)[0]
        if res_index.size == 0:
            warnings.warn(LisfloodWarning("There are no reservoirs. Reservoirs simulation won't run"))
            option["simulateReservoirs"] = False
            option["repsimulateReservoirs"] = False
        else:
            num_res = res_index.size
            is_structure[res_index] = True
            params["ReservoirIndex"] = res_index
            params["ReservoirSitesC"] = res_sites
            res_ids = res_sites.astype(int)

            def _res_table(key):
                vals = lookup_scalar(binding[key], res_ids)
                return vals[res_index]

            tot_storage = lookup_scalar(binding["TabTotStorage"], res_ids)
            tot_storage = np.where(np.isnan(tot_storage), 0, tot_storage)
            params["TotalReservoirStorageM3C"] = tot_storage
            params["TotalReservoirStorageM3CC"] = tot_storage[res_index]
            conservative = _res_table("TabConservativeStorageLimit")
            normal = _res_table("TabNormalStorageLimit")
            flood = _res_table("TabFloodStorageLimit")
            non_damaging_q = _res_table("TabNonDamagingOutflowQ")
            normal_q = _res_table("TabNormalOutflowQ")
            min_q = _res_table("TabMinOutflowQ")
            adjust_nf = _field(loader.load("adjust_Normal_Flood"), P)[res_index]
            normal_flood = normal + adjust_nf * (flood - normal)
            rnormq_mult = _field(loader.load("ReservoirRnormqMult"), P)[res_index]
            normal_q = normal_q * rnormq_mult
            normal_q = np.where(normal_q > min_q, normal_q, min_q + 0.01)
            normal_q = np.where(normal_q < non_damaging_q, normal_q, non_damaging_q - 0.01)
            params["ConservativeStorageLimitCC"] = conservative
            params["NormalStorageLimitCC"] = normal
            params["FloodStorageLimitCC"] = flood
            params["Normal_FloodStorageLimitCC"] = normal_flood
            params["NonDamagingReservoirOutflowCC"] = non_damaging_q
            params["NormalReservoirOutflowCC"] = normal_q
            params["MinReservoirOutflowCC"] = min_q
            params["DeltaO"] = normal_q - min_q
            params["DeltaLN"] = normal - 2 * conservative
            params["DeltaLF"] = flood - normal
            params["DeltaNFL"] = flood - normal_flood
            res_fill_init = _field(loader.load("ReservoirInitialFillValue"), P)
            if np.max(res_fill_init) == -9999:
                fill = normal.copy()
            else:
                fill = res_fill_init[res_index]
            res_storage_ini = fill * params["TotalReservoirStorageM3CC"]
            state["ReservoirFillCC"] = fill
            state["ReservoirStorageM3CC"] = res_storage_ini.copy()
            res_storage_ini_m3 = np.zeros(P)
            res_storage_ini_m3[res_index] = res_storage_ini
            params["ReservoirStorageIniM3"] = res_storage_ini_m3
            state["ReservoirStorageM3"] = res_storage_ini_m3.copy()

    # polders (polder.py:43-70): initial() parity — sites restricted to the
    # channel network, storage from the area lookup table; the reference's
    # dynamic parts are a no-op skeleton, so storage is carried unchanged
    # and PolderLevel is a pure diagnostic
    if option.get("simulatePolders") and not option["InitLisflood"]:
        # sparse nominal map: undefined cells are simply "no polder", like
        # pcraster.defined(PolderSites) in the reference
        polder_sites = grid.compress(loader.load_2d("PolderSites"))
        polder_sites = np.where(
            np.isnan(polder_sites) | ~params["IsChannel"].astype(bool), 0, polder_sites
        ).astype(np.int64)
        polder_area = np.zeros(P)
        on = polder_sites > 0
        if on.any():
            polder_area[on] = lookup_scalar(binding["TabPolderArea"], polder_sites[on])
        polder_level0 = float(binding.get("PolderInitialLevelValue", 0.0))
        params["PolderArea"] = polder_area
        params["IsPolder"] = on
        params["PolderStorageIniM3"] = np.where(on, polder_level0 * polder_area, 0.0)
        state["PolderStorageM3"] = params["PolderStorageIniM3"].copy()

    # structure pit-cutting (structures.py:43-61)
    params["IsStructureKinematic"] = is_structure
    if not option["InitLisflood"]:
        ldd_struct_cut, is_ups_of_structure = cut_structures(ldd_chan, graph_chan, is_structure)
        params["IsUpsOfStructureKinematicC"] = is_ups_of_structure
        if option["simulateLakes"] and num_lakes:
            is_lake = np.zeros(P, dtype=bool)
            is_lake[params["LakeIndex"]] = True
            down_ok = graph_chan.downstream >= 0
            is_ups_lake = np.zeros(P, dtype=bool)
            is_ups_lake[down_ok] = is_lake[graph_chan.downstream[down_ok]]
            params["IsUpsOfStructureLake"] = is_ups_lake
        ldd_kinematic = ldd_struct_cut
    else:
        params["IsUpsOfStructureKinematicC"] = np.zeros(P, dtype=bool)
        ldd_kinematic = ldd_chan
    graph_kin = build_flow_graph(ldd_kinematic, grid)
    aux["graph_full"] = graph_full
    aux["graph_chan"] = graph_chan
    aux["graph_kin"] = graph_kin
    aux["graph_tochan"] = graph_tochan
    # structure (lake/reservoir) cells must be chunked after their pre-cut
    # upstream feeders for the pipelined sub-step loop — order against the
    # pre-cut channel graph
    aux["schedule_kin"] = build_schedule(graph_kin, order_graph=graph_chan)
    aux["schedule_tochan"] = build_schedule(graph_tochan)

    # ---------------- split routing initialSecond (routing.py:341-431) ----
    if option["SplitRouting"]:
        chan_man2 = (chan_man / cal_chan_man) * _field(loader.load("CalChanMan2"), P)
        channel_alpha2 = ((chan_man2 / np.sqrt(chan_grad)) ** beta * wetted_perimeter**alp_pow).astype(float)
        params["ChannelAlpha2"] = channel_alpha2
        if not option["InitLisflood"]:
            qlimit = _field(loader.load("AvgDis"), P) * _field(loader.load("QSplitMult"), P)
            params["QLimit"] = qlimit
            params["M3Limit"] = channel_alpha * chan_length * qlimit**beta
            chan2_m3_start = channel_alpha2 * chan_length * qlimit**beta
            params["Chan2M3Start"] = chan2_m3_start
            ups_qlimit = graph_kin.upstream_sum(qlimit)
            params["Chan2QStart"] = qlimit - ups_qlimit
            chan2_m3_kin = state["CrossSection2Area"] * chan_length + chan2_m3_start
            chan_m3_kin = chan_m3 - chan2_m3_kin + chan2_m3_start
            chan_m3_kin = np.where((chan_m3_kin < 0.0) & (chan_m3_kin > -0.0000001), 0.0, chan_m3_kin)
            state["Chan2M3Kin"] = chan2_m3_kin
            state["ChanM3Kin"] = chan_m3_kin
            state["Chan2QKin"] = (chan2_m3_kin / chan_length / channel_alpha2) ** (1 / beta)
            state["ChanQKin"] = (chan_m3_kin / chan_length / channel_alpha) ** (1 / beta)

    # ---------------- evapowater (evapowater.py:46-94) --------------------
    if option["openwaterevapo"]:
        lake_mask = _field(loader.load("LakeMask"), P)
        lake_mask = np.nan_to_num(lake_mask, nan=0.0)
        ldd_eva = np.where(lake_mask != 0, ldd_chan, 5.0)
        graph_eva = build_flow_graph(ldd_eva, grid)
        down_eva = np.full(P, P, dtype=np.int32)
        valid = graph_eva.downstream >= 0
        down_eva[valid] = graph_eva.downstream[valid]
        params["downEva"] = down_eva
        params["maxNoEva"] = int(loader.load("maxNoEva"))
        # 2-D stencil form of the chain's downstream transfer (8 masked
        # shifted adds instead of a segment-sum scatter; ops/physics.
        # scatter_down_stencil)
        flat_idx = np.flatnonzero(grid.land_flat)
        codes2d, adjacent = direction_codes(graph_eva.downstream, flat_idx,
                                            grid.nrows, grid.ncols)
        if adjacent:
            params["evaDir2D"] = codes2d
            params["landIdx"] = flat_idx.astype(np.int32)
        if option["varfractionwater"]:
            params["diffmaxwater"] = _field(loader.load("FracMaxWater"), P) - water_frac
            var_wno = [1, 32, 60, 91, 121, 152, 182, 213, 244, 274, 305, 335, 370]
            varw = np.zeros((12, P))
            for i, data in enumerate(_stack_slices(binding["WFractionMaps"], grid, 12)):
                varw[i] = grid.compress(data)
            params["varW"] = varw
            varw1 = [12]
            j = 0
            for i in range(1, 367):
                if i >= var_wno[j + 1]:
                    j += 1
                varw1.append(j)
            aux["varW_day_to_month"] = np.array(varw1, dtype=np.int32)
    state["EvaCumM3"] = np.zeros(P)

    # ---------------- rice irrigation (riceirrigation.py:44-77) -----------
    state["PaddyRiceWaterAbstractionFromSurfaceWaterM3"] = np.zeros(P)
    if option["riceIrrigation"]:
        if not option["wateruse"]:
            raise LisfloodError("riceIrrigation module ON MUST HAVE wateruse option ON in setting file")
        params["RiceFlooding"] = _field(loader.load("RiceFlooding"), P)
        params["RicePercolation"] = _field(loader.load("RicePercolation"), P)
        params["RicePlantingDay1"] = _field(loader.load("RicePlantingDay1"), P)
        params["RiceHarvestDay1"] = _field(loader.load("RiceHarvestDay1"), P)
        params["RicePlantingDay2"] = _field(loader.load("RicePlantingDay2"), P)
        params["RiceHarvestDay2"] = _field(loader.load("RiceHarvestDay2"), P)

    # ---------------- water abstraction (waterabstraction.py:53-248) ------
    num_wregions = 0
    if option["wateruse"]:
        params["WUsePercRemain"] = _field(loader.load("WUsePercRemain"), P)
        params["NoWaterUseSteps"] = int(loader.load("maxNoWateruse"))
        gw_bodies = _field(loader.load("GroundwaterBodies"), P)
        params["GroundwaterBodies"] = gw_bodies
        frac_gw_used = np.minimum(np.maximum(_field(loader.load("FractionGroundwaterUsed"), P), 0.0), 1.0)
        frac_nc_used = _field(loader.load("FractionNonConventionalWaterUsed"), P)
        params["FractionNonConventionalWaterUsed"] = frac_nc_used
        if not option["InitLisflood"]:
            params["FractionLakeReservoirWaterUsed"] = _field(loader.load("FractionLakeReservoirWaterUsed"), P)
        else:
            params["FractionLakeReservoirWaterUsed"] = np.zeros(P)
        params["EFlowThreshold"] = _field(loader.load("EFlowThreshold"), P)
        wuse_region = _field(loader.load("WUseRegion"), P).astype(int)
        params["WUseRegionC"] = wuse_region
        num_wregions = int(wuse_region.max()) + 1
        params["IrrigationMult"] = _field(loader.load("IrrigationMult"), P)
        params["IndustryConsumptiveUseFraction"] = _field(loader.load("IndustryConsumptiveUseFraction"), P)
        params["PotentialIrrigationWaterReUseM3Annual"] = _field(loader.load("IrrigationWaterReUseM3"), P)
        params["PotentialIrrigationWaterReUseM3Daily"] = params["PotentialIrrigationWaterReUseM3Annual"] / float(loader.load("IrrigationWaterReUseNumDays"))
        state["ActualAccumulatedReUsedWaterM3"] = np.zeros(P)
        params["EnergyConsumptiveUseFraction"] = _field(loader.load("EnergyConsumptiveUseFraction"), P)
        params["LivestockConsumptiveUseFraction"] = _field(loader.load("LivestockConsumptiveUseFraction"), P)
        leak_abstr = np.minimum(np.maximum(
            _field(loader.load("LeakageFraction"), P) * (1 - _field(loader.load("LeakageReductionFraction"), P)), 0.0), 1.0)
        params["leak_demand_fraction"] = leak_abstr / (1 - leak_abstr)
        params["DomesticWaterSavingConstant"] = np.minimum(np.maximum(1 - _field(loader.load("WaterSavingFraction"), P), 0.0), 1.0)
        params["DomesticConsumptiveUseFraction"] = _field(loader.load("DomesticConsumptiveUseFraction"), P)
        params["LeakageWaterLossFraction"] = _field(loader.load("LeakageWaterLoss"), P)

        if not option["TransientWaterDemandChange"]:
            if option["useWaterDemandAveYear"]:
                raise LisfloodError("TransientWaterDemandChange must be on to use useWaterDemandAveYear")
            params["DomesticDemandMM"] = _field(loader.load("DomesticDemandMaps", timestampflag="closest"), P) * dt_day
            params["IndustrialDemandMM"] = _field(loader.load("IndustrialDemandMaps", timestampflag="closest"), P) * dt_day
            params["LivestockDemandMM"] = _field(loader.load("LivestockDemandMaps", timestampflag="closest"), P) * dt_day
            params["EnergyDemandMM"] = _field(loader.load("EnergyDemandMaps", timestampflag="closest"), P) * dt_day

        if option["groundwaterSmooth"]:
            # window of LZSmoothRange*celllength map units = LZSmoothRange cells
            params["LZSmoothRangeCells"] = max(1, int(round(float(loader.load("LZSmoothRange")))))
            flat_idx = np.flatnonzero(grid.land_flat)
            params["LandRows"], params["LandCols"] = np.divmod(flat_idx, grid.ncols)
            params["GroundwaterCatch"] = ((gw_bodies > 0) * catchments).astype(np.int32)

        if option["wateruseRegion"]:
            # water-region ldd cutting (waterabstraction.py:151-194)
            pit_wuse = np.zeros(P)
            pit_wuse[at_last_point] = wuse_region[at_last_point]
            # region outlets by max upstream area
            up_area = params["UpArea"]
            region_max = np.zeros(num_wregions)
            np.maximum.at(region_max, wuse_region, up_area)
            is_region_max = up_area == region_max[wuse_region]
            pit_wuse = np.where((pit_wuse == 0) & is_region_max, wuse_region, pit_wuse)
            # points where the (structures) ldd leaves a region
            down_region = graph_chan.downstream_value(wuse_region.astype(float))
            leaves = down_region != wuse_region
            pit_wuse = np.where((pit_wuse == 0) & leaves, wuse_region, pit_wuse)
            ldd_wregion = np.where(pit_wuse != 0, 5.0, ldd_chan)
            graph_wregion = build_flow_graph(ldd_wregion, grid)
            down_wregion = np.full(P, P, dtype=np.int32)
            valid = graph_wregion.downstream >= 0
            down_wregion[valid] = graph_wregion.downstream[valid]
            params["downWRegion"] = down_wregion
            params["WaterRegionOutflowPoints"] = pit_wuse != 0
            params["WaterRegionInflowPoints"] = graph_chan.upstream_sum((pit_wuse != 0).astype(float)) > 0
        else:
            params["downWRegion"] = params["downstruct"].copy()
            # the reference leaves WaterRegionInflowPoints undefined without
            # wateruseRegion (and indicatorcalc would crash there too); a
            # no-inflow-points default keeps indicator runs well-defined
            params["WaterRegionInflowPoints"] = np.zeros(P, dtype=bool)

        gw_region_pixels = np.bincount(wuse_region, weights=gw_bodies, minlength=num_wregions)[wuse_region]
        all_region_pixels = np.bincount(wuse_region, weights=np.ones(P), minlength=num_wregions)[wuse_region]
        ratio_gw = all_region_pixels / (gw_region_pixels + 0.01)
        frac_gw_used = np.minimum(frac_gw_used * ratio_gw, 1 - frac_nc_used)
        frac_gw_used[gw_bodies == 0] = 0
        params["FractionGroundwaterUsed"] = frac_gw_used
        gw_fed_irrigation = frac_gw_used.copy()
        gw_fed_irrigation[gw_bodies == 0] = 0
        params["GWfed_fraction_irrigation"] = gw_fed_irrigation
        params["FractionSurfaceWaterUseDomLivInd"] = np.maximum(np.minimum(1 - frac_gw_used - frac_nc_used, 1), 0)

        params["IrrigationType"] = _field(loader.load("IrrigationType"), P)
        irr_eff = _field(loader.load("IrrigationEfficiency"), P)
        conv_eff = _field(loader.load("ConveyanceEfficiency"), P)
        params["IrrigationEfficiency"] = irr_eff
        params["ConveyanceEfficiency"] = conv_eff
        params["efficiency_irrigation"] = irr_eff * conv_eff

        state["IrriLossCUM"] = np.zeros(P)
        state["wateruseCum"] = np.zeros(P)
        state["cumulated_CH_withdrawal"] = np.zeros(P)

    # indicator (indicatorcalc.py:47-78)
    if option["indicator"] and option["wateruse"]:
        params["Population"] = _field(loader.load("Population"), P)
        params["LandUseMask"] = _field(loader.load("LandUseMask"), P)
        params["RegionPopulation"] = np.bincount(
            params["WUseRegionC"], weights=params["Population"], minlength=num_wregions)[params["WUseRegionC"]]
        icfg = SimpleNamespace(rep_water_use=bool(option.get("repWaterUse")))
        for k, v in indicator_state_zero(icfg, P, torch.float64).items():
            state[k] = v.numpy().copy()

    # inflow hydrographs (inflow.py:49-96)
    if option["inflow"]:
        inflow_points = _field(loader.load("InflowPoints"), P)
        inflow_points = np.where(np.isnan(inflow_points) | (inflow_points < 0), 0, inflow_points)
        params["InflowPoints"] = inflow_points
        state["QInM3Old"] = np.where(inflow_points > 0, state["ChanQ"] * dt_sec, 0)
        from ..io.tss import read_tss
        tss_ids, tss_data, tss_steps = read_tss(binding["QInTS"])
        # drop inflow points absent from the tss (inflow.py:80-84)
        known = set(tss_ids)
        for pid in np.unique(inflow_points[inflow_points > 0]).astype(int):
            if pid not in known:
                warnings.warn(LisfloodWarning(f"Inflow point was removed ID: {pid}"))
                inflow_points[inflow_points == pid] = 0
        aux["inflow_tss"] = (tss_ids, tss_data, tss_steps)
        aux["inflow_points"] = inflow_points

    # transmission loss (transmission.py:43-63)
    if option["TransLoss"]:
        trans_area = _field(loader.load("TransArea"), P)
        params["TransSub"] = _field(loader.load("TransSub"), P)
        up_area_trans = _field(loader.load("UpAreaTrans"), P)
        params["UpTrans"] = up_area_trans >= trans_area
        params["TransPower1"] = _field(loader.load("TransPower1"), P)
        params["TransPower2"] = 1.0 / params["TransPower1"]
        state["TransCum"] = np.zeros(P)

    if option["simulateWaterLevels"]:
        params["FloodPlainWidth"] = _field(loader.load("FloodPlainWidth"), P)

    num_catchments = int(catchments.max()) + 1

    config = ModelConfig.from_settings(
        settings,
        num_lakes=num_lakes,
        num_reservoirs=num_res,
        num_catchments=num_catchments,
        num_wregions=num_wregions,
        num_pixels=P,
        grid_rows=grid.nrows,
        grid_cols=grid.ncols,
        max_no_eva=int(params.get("maxNoEva", 5)),
    )

    # waterbalance init (waterbalance.py:43-109) needs config/completed state
    if (not option["InitLisflood"]) and option["repMBTs"]:
        _waterbalance_init(config, params, state, aux, option)
    # routing initialSecond MBTs init (routing.py:405-431)
    if option["repMBTs"]:
        _split_mb_init(config, params, state, aux, option)

    state["TimeSinceStart"] = np.float64(0.0)
    return config, params, state, aux


def _catchtotal(values, catchments, n):
    return np.bincount(catchments, weights=values, minlength=n)[catchments]


def _waterbalance_init(config, params, state, aux, option):
    P = config.num_pixels
    n = config.num_catchments
    catch = params["Catchments"]
    channel_init = aux["ChanIniM3"].copy()
    if option["simulateLakes"] and config.num_lakes:
        channel_init += params["LakeStorageIniM3"]
    if option["simulateReservoirs"] and config.num_reservoirs:
        channel_init += params["ReservoirStorageIniM3"]
    if option["simulatePolders"] and "PolderStorageIniM3" in params:
        channel_init += params["PolderStorageIniM3"]   # waterbalance.py:65-66
    hill1 = (params["SoilFraction"] * (state["CumInterception"] + state["W1a"] + state["W1b"] + state["W2"] + state["UZ"])).sum(0)
    hill1 += state["LZ"]
    overland = state["OFM3Other"] + state["OFM3Forest"] + state["OFM3Direct"]
    hillslope_init = (aux["SnowCoverInit"] + hill1 + params["DirectRunoffFraction"] * state["CumInterSealed"]) * params["MMtoM3"] + overland
    water_init = _catchtotal(channel_init, catch, n) + _catchtotal(hillslope_init, catch, n)
    state["WaterInit"] = water_init
    dt_routing = config.dt_routing
    dis_structure = np.where(params["IsUpsOfStructureKinematicC"], state["ChanQ"] * dt_routing, 0)
    if option["simulateLakes"] and config.num_lakes:
        dis_structure += np.where(params.get("IsUpsOfStructureLake", np.zeros(P, bool)), 0.5 * state["ChanQ"] * dt_routing, 0)
    state["DischargeM3StructuresIni"] = _catchtotal(dis_structure, catch, n)


def _split_mb_init(config, params, state, aux, option):
    n = config.num_catchments
    catch = params["Catchments"]
    P = config.num_pixels
    dt_routing = config.dt_routing
    if option["InitLisflood"]:
        storage = state["ChanM3Kin"].copy()
        state["DischargeM3StructuresIni"] = np.zeros(P)
        if option["simulateReservoirs"] and config.num_reservoirs:
            storage = storage + params["ReservoirStorageIniM3"]
        if option["simulateLakes"] and config.num_lakes:
            storage = storage + params["LakeStorageIniM3"]
        state["StorageStepINIT"] = _catchtotal(storage, catch, n)
    else:
        dis_structure = np.where(params["IsUpsOfStructureKinematicC"], state["ChanQ"] * dt_routing, 0)
        if not option["SplitRouting"]:
            storage = state["ChanM3Kin"].copy()
            if option["simulateReservoirs"] and config.num_reservoirs:
                storage = storage + params["ReservoirStorageIniM3"]
            if option["simulateLakes"] and config.num_lakes:
                storage = storage + params["LakeStorageIniM3"]
                is_ups_lake = params.get("IsUpsOfStructureLake", np.zeros(P, bool))
                dis_structure = dis_structure + np.where(is_ups_lake, 0.5 * state["ChanQ"] * dt_routing, 0)
            state["DischargeM3StructuresIni"] = _catchtotal(dis_structure, catch, n)
            state["StorageStepINIT"] = storage
        else:
            storage = state["ChanM3Kin"] + state["Chan2M3Kin"] - params["Chan2M3Start"]
            if option["simulateReservoirs"] and config.num_reservoirs:
                storage = storage + params["ReservoirStorageIniM3"]
            if option["simulateLakes"] and config.num_lakes:
                storage = storage + params["LakeStorageIniM3"]
            state["StorageStepINIT"] = _catchtotal(storage, catch, n)
            state["DischargeM3StructuresIni"] = _catchtotal(dis_structure, catch, n)


# the meteo forcing of the step and the binding of its stack (the reference's
# readmeteo.py; ES0Maps is not read: the step takes ESRef = (EWRef + ETRef) / 2)
METEO_KEYS = (("Precipitation", "PrecipitationMaps"), ("Tavg", "TavgMaps"),
              ("ETRef", "ET0Maps"), ("EWRef", "E0Maps"))


def meteo_forcing(settings, config, aux):
    """The forcing of every model step from StepStart to StepEnd, as NumPy
    dicts (floats in float64), assembled by the driver's HostForcing as
    LisfloodRunner.forcing_for assembles it: the meteo and calendar entries
    and every option's (models/driver.py). Without TransientWaterDemandChange
    the water demands are the maps build_model reads into the parameters."""
    from .driver import HostForcing
    source = HostForcing(settings, config, aux)
    try:
        static = (source.static_demands()
                  if config.water_use and not config.transient_water_demand else {})
        return [{**source(i, date), **static} for i, date in enumerate(source.dates)]
    finally:
        source.close()

"""Synthetic catchment generator — a full model setup with no input files.

build_synthetic_model is the port's copy of lisflood_tpu/models/synthetic.py:
for the same arguments it returns arrays equal to the JAX package's
(config, params, state, aux), so it can build the continental model on a
machine without JAX. The drainage network is a random spanning forest on an
nrows x ncols grid; soil/channel parameters are drawn from realistic ranges.
The port's own fixtures add to it: with_options (the inputs of every option
of the step) and write_catchment (a catchment on disk, read through the
settings and build_model).
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os

import numpy as np

from ..graph.ldd import FlowGraph, build_schedule, direction_codes
from ..io import csf, ncdf
from ..io.tss import TssWriter
from ..ops.indicators import indicator_keys
from .config import ModelConfig
from .step import LANDUSE_FRACTIONS

LDD_CODE = {(1, 0): 2, (1, 1): 3, (0, 1): 6, (-1, 1): 9, (-1, 0): 8,
            (-1, -1): 7, (0, -1): 4, (1, -1): 1}


def mualem(residual, sat, alpha, n, m, pressure):
    """Soil moisture at a pressure head (van Genuchten / Mualem; reference
    soil.py:30-35). Copy of lisflood_tpu/models/initial.py:mualem."""
    return residual + (sat - residual) / ((1 + (alpha * pressure) ** n) ** m)


def synthetic_drainage(nrows, ncols, seed=0):
    """Random drainage network: every cell drains toward the bottom-right
    with random local direction, guaranteeing acyclicity. Fully vectorized
    (used at continental scale by the benchmark)."""
    rng = np.random.default_rng(seed)
    P = nrows * ncols
    r, c = np.divmod(np.arange(P, dtype=np.int64), ncols)
    has_s = r + 1 < nrows
    has_e = c + 1 < ncols
    # draw among the available directions: interior cells pick S/E/SE,
    # last row drains E, last column drains S, bottom-right corner is a pit
    pick = rng.integers(0, 3, P)
    dr = np.where(has_s & has_e, (pick != 1).astype(np.int64),
                  has_s.astype(np.int64))
    dc = np.where(has_s & has_e, (pick != 0).astype(np.int64),
                  has_e.astype(np.int64))
    pit = ~has_s & ~has_e
    dr[pit] = 0
    dc[pit] = 0
    code_lut = np.array([[5, 6, 0], [2, 3, 0], [0, 0, 0]], dtype=np.int8)
    ldd = code_lut[dr, dc]
    down = ((r + dr) * ncols + (c + dc)).astype(np.int32)
    down[pit] = -1
    return ldd, down


def build_synthetic_model(nrows=16, ncols=16, seed=0, no_rout_steps=4,
                          with_structures=True, split_routing=True,
                          open_water=True, chunk_size=64):
    rng = np.random.default_rng(seed)
    P = nrows * ncols
    ldd, down = synthetic_drainage(nrows, ncols, seed)
    graph = FlowGraph(downstream=down, ldd=ldd, num_pixels=P)
    dt_sec = 86400.0
    dt_day = 1.0
    beta = 0.6

    u = lambda lo, hi, shape=P: rng.uniform(lo, hi, shape)
    params = {}
    state = {}

    pixel_area = np.full(P, 25e6)
    params["PixelLength"] = np.full(P, 5000.0)
    params["PixelArea"] = pixel_area
    params["MMtoM3"] = 0.001 * pixel_area
    params["M3toMM"] = 1.0 / params["MMtoM3"]
    params["lat_rad"] = np.full(P, 0.8)
    params["GwLoss"] = np.zeros(P)
    params["GwPerc"] = np.full(P, 0.5)
    params["GwPercStep"] = params["GwPerc"] * dt_day
    params["GwLossStep"] = np.zeros(P)
    params["PrScaling"] = np.ones(P)
    params["CalEvaporation"] = np.ones(P)

    fr = rng.dirichlet(np.ones(5), P).T      # water, direct, forest, irrig, other
    water, direct, forest, irrig, other = fr * 0.2
    other = 1 - (water + direct + forest + irrig)
    soil_fraction = np.stack([other, forest, irrig])
    params["SoilFraction"] = soil_fraction
    params["ForestFraction"] = forest
    params["DirectRunoffFraction"] = direct
    params["WaterFraction"] = water
    params["IrrigationFraction"] = irrig
    params["RiceFraction"] = np.zeros(P)
    params["OtherFraction"] = other
    params["PermeableFraction"] = 1 - direct - water

    params["DeltaTSnow"] = u(0, 3)
    params["SnowSeason"] = np.full(P, 0.5)
    params["TempSnow"] = np.full(P, 1.0)
    params["SnowFactor"] = np.full(P, 1.45)
    params["SnowMeltCoef"] = np.full(P, 4.0)
    params["TempMelt"] = np.zeros(P)
    state["SnowCoverS"] = u(0, 30, (3, P))

    params["Kfrost"] = np.full(P, 0.57)
    params["Afrost"] = np.full(P, 0.97)
    params["FrostIndexThreshold"] = np.full(P, 56.0)
    params["SnowWaterEquivalent"] = np.full(P, 0.1)
    state["FrostIndex"] = np.zeros(P)

    params["kgb"] = np.full(P, 0.75 * 0.72)
    params["LAIX"] = u(0.1, 5, (36, 3, P))

    sd1a = u(50, 150, (3, P))
    sd1b = u(100, 400, (3, P))
    sd2 = u(200, 800, (3, P))
    params["SoilDepth1a"], params["SoilDepth1b"], params["SoilDepth2"] = sd1a, sd1b, sd2
    params["SoilDepthTotal"] = sd1a + sd1b + sd2
    params["CourantCrit"] = 0.5
    params["LeafDrainageK"] = 1.0
    params["AvWaterThreshold"] = 5.0 * dt_day
    params["CropCoef"] = u(0.8, 1.2, (3, P))
    params["CropGroupNumber"] = u(1, 5, (3, P))
    params["NManning"] = u(0.05, 0.4, (3, P))

    for layer, sd in (("1a", sd1a), ("1b", sd1b), ("2", sd2)):
        lam = u(0.1, 0.4, (3, P))
        n = 1 + lam
        m = lam / n
        ths = u(0.35, 0.5, (3, P))
        thr = u(0.01, 0.08, (3, P))
        ws = ths * sd
        wres = thr * sd
        alpha = u(0.01, 0.06, (3, P))
        params[f"KSat{layer}"] = u(10, 300, (3, P))
        params[f"GenuM{layer}"] = m
        params[f"GenuInvM{layer}"] = 1 / m
        params[f"GenuInvN{layer}"] = 1 / n
        params[f"GenuInvAlpha{layer}"] = 1 / alpha
        params[f"WS{layer}"] = ws
        params[f"WRes{layer}"] = wres
        params[f"WFC{layer}"] = mualem(wres, ws, alpha, n, m, 100.0)
        params[f"WWP{layer}"] = mualem(wres, ws, alpha, n, m, 15000.0)
        params[f"PoreSpaceNotZero{layer}"] = np.ones((3, P), bool)
        if layer != "2":
            params.setdefault("_wpf3", {})[layer] = mualem(wres, ws, alpha, n, m, 1000.0)
    params["WS1"] = params["WS1a"] + params["WS1b"]
    params["WRes1"] = params["WRes1a"] + params["WRes1b"]
    params["WFC1"] = params["WFC1a"] + params["WFC1b"]
    params["WWP1"] = params["WWP1a"] + params["WWP1b"]
    params["WPF3a"] = params.pop("_wpf3")["1a"]
    params["WPF3b"] = params["WFC1b"] * 0.9
    state["W1a"] = params["WFC1a"].copy()
    state["W1b"] = params["WFC1b"].copy()
    state["W2"] = params["WFC2"].copy()

    params["b_Xinanjiang"] = np.full(P, 0.7)
    params["PowerInfPot"] = (params["b_Xinanjiang"] + 1) / params["b_Xinanjiang"]
    params["StoreMaxPervious"] = params["WS1"] / (params["b_Xinanjiang"] + 1)
    params["PowerPrefFlow"] = np.full(P, 3.5)
    state["DSLR"] = np.ones((3, P))
    state["CumInterception"] = np.zeros((3, P))
    state["CumInterSealed"] = np.zeros(P)
    params["SMaxSealed"] = np.full(P, 1.0)
    params["DrainedFraction"] = 0.0
    for key in ("TotalPrecipitation", "TaCUM", "TaInterceptionCUM", "ESActCUM",
                "GwLossCUM", "LZInflowCUM"):
        state[key] = np.zeros(P)

    params["UpperZoneK"] = np.full(P, 0.1)
    params["LowerZoneK"] = np.full(P, 0.01)
    state["LZ"] = u(10, 100)
    params["LZThreshold"] = np.zeros(P)
    state["UZ"] = u(0, 10, (3, P))

    chan_length = np.full(P, 5000.0)
    params["Beta"] = beta
    params["ChanLength"] = chan_length
    params["UpArea"] = graph.accuflux(pixel_area)
    is_channel = np.ones(P, bool)
    params["IsChannel"] = is_channel
    params["IsChannelKinematic"] = is_channel
    params["AtLastPointC"] = graph.is_pit
    catchments = graph.catchment_labels()
    params["Catchments"] = catchments
    params["CatchArea"] = np.bincount(catchments, weights=pixel_area)[catchments]
    downstruct = np.full(P, P, dtype=np.int32)
    valid = graph.downstream >= 0
    downstruct[valid] = graph.downstream[valid]
    params["downstruct"] = downstruct

    chan_grad = u(1e-4, 0.05)
    chan_man = u(0.02, 0.1)
    chan_bw = u(5, 100)
    chan_depth = u(1, 8)
    sdxdy = u(0.5, 3)
    chan_upper = chan_bw + 2 * sdxdy * chan_depth
    params["ChanBottomWidth"] = chan_bw
    params["ChanUpperWidth"] = chan_upper
    params["TotalCrossSectionAreaBankFull"] = 0.5 * chan_depth * (chan_upper + chan_bw)
    wd_alpha = 0.5 * chan_depth
    wetted = chan_bw + 2 * np.sqrt(wd_alpha**2 + (wd_alpha * sdxdy) ** 2)
    params["ChanWettedPerimeterAlpha"] = wetted
    alp_pow = 2.0 / 3.0 * beta
    params["AlpPow"] = alp_pow
    alpha1 = (chan_man / np.sqrt(chan_grad)) ** beta * wetted**alp_pow
    params["ChannelAlpha"] = alpha1
    total_csa = 0.5 * params["TotalCrossSectionAreaBankFull"]
    chan_m3 = total_csa * chan_length
    state["ChanM3Kin"] = chan_m3.copy()
    state["ChanQKin"] = (total_csa / alpha1) ** (1 / beta)
    state["ChanQ"] = state["ChanQKin"].copy()
    for key in ("CumQ", "avgdis", "DischargeM3Out", "TotalQInM3", "sumDis", "sumInWB",
                "EvaCumM3", "PaddyRiceWaterAbstractionFromSurfaceWaterM3"):
        state[key] = np.zeros(P)

    state["OFM3Other"] = np.zeros(P)
    state["OFM3Forest"] = np.zeros(P)
    state["OFM3Direct"] = np.zeros(P)
    of_alpha = (params["NManning"] / np.sqrt(u(1e-3, 0.1))) ** beta * (params["PixelLength"] + 1.0) ** alp_pow
    params["OFAlpha"] = of_alpha
    state["OFQDirect"] = np.zeros(P)
    state["OFQOther"] = np.zeros(P)
    state["OFQForest"] = np.zeros(P)

    num_lakes = num_res = 0
    is_structure = np.zeros(P, bool)
    if with_structures:
        order = np.argsort(params["UpArea"])[::-1]
        lake_index = order[4:6]
        res_index = order[8:10]
        num_lakes, num_res = 2, 2
        is_structure[lake_index] = True
        is_structure[res_index] = True
        params["LakeIndex"] = lake_index
        params["LakeAreaCC"] = u(1e7, 1e9, 2)
        params["LakeACC"] = u(30, 150, 2)
        dt_routing = dt_sec / no_rout_steps
        lake_factor = params["LakeAreaCC"] / (dt_routing * np.sqrt(params["LakeACC"]))
        params["LakeFactor"] = lake_factor
        params["LakeFactorSqr"] = lake_factor**2
        storage = u(1e6, 1e8, 2)
        state["LakeStorageM3CC"] = storage.copy()
        state["LakeStorageM3BalanceCC"] = storage.copy()
        state["LakeInflowOldCC"] = u(1, 50, 2)
        state["LakeOutflowCC"] = u(1, 50, 2)
        state["LakeLevelCC"] = storage / params["LakeAreaCC"]
        lake_m3 = np.zeros(P)
        lake_m3[lake_index] = storage
        params["LakeStorageIniM3"] = lake_m3
        state["LakeStorageM3"] = lake_m3.copy()
        state["EWLakeCUMM3"] = np.zeros(P)

        params["ReservoirIndex"] = res_index
        tot = u(1e7, 1e9, 2)
        params["TotalReservoirStorageM3CC"] = tot
        params["TotalReservoirStorageM3C"] = np.zeros(P)
        params["TotalReservoirStorageM3C"][res_index] = tot
        params["ConservativeStorageLimitCC"] = np.full(2, 0.1)
        params["NormalStorageLimitCC"] = np.full(2, 0.45)
        params["FloodStorageLimitCC"] = np.full(2, 0.9)
        params["Normal_FloodStorageLimitCC"] = np.full(2, 0.8)
        params["NonDamagingReservoirOutflowCC"] = u(100, 300, 2)
        params["NormalReservoirOutflowCC"] = u(20, 80, 2)
        params["MinReservoirOutflowCC"] = u(1, 5, 2)
        params["DeltaO"] = params["NormalReservoirOutflowCC"] - params["MinReservoirOutflowCC"]
        params["DeltaLN"] = params["NormalStorageLimitCC"] - 2 * params["ConservativeStorageLimitCC"]
        params["DeltaLF"] = params["FloodStorageLimitCC"] - params["NormalStorageLimitCC"]
        params["DeltaNFL"] = params["FloodStorageLimitCC"] - params["Normal_FloodStorageLimitCC"]
        fill = params["NormalStorageLimitCC"].copy()
        state["ReservoirFillCC"] = fill
        state["ReservoirStorageM3CC"] = fill * tot
        res_m3 = np.zeros(P)
        res_m3[res_index] = fill * tot
        params["ReservoirStorageIniM3"] = res_m3
        state["ReservoirStorageM3"] = res_m3.copy()

    params["IsStructureKinematic"] = is_structure
    down_ok = graph.downstream >= 0
    is_ups = np.zeros(P, bool)
    is_ups[down_ok] = is_structure[graph.downstream[down_ok]]
    params["IsUpsOfStructureKinematicC"] = is_ups
    ldd_cut = ldd.astype(np.float64)
    ldd_cut[is_ups] = 5
    graph_kin = FlowGraph(downstream=np.where(is_ups, -1, graph.downstream),
                          ldd=ldd_cut.astype(np.int8), num_pixels=P)

    if split_routing:
        alpha2 = alpha1 * u(1.2, 2.0)
        params["ChannelAlpha2"] = alpha2
        qlimit = np.maximum(state["ChanQKin"] * 2, 0.1)
        params["QLimit"] = qlimit
        params["M3Limit"] = alpha1 * chan_length * qlimit**beta
        chan2_start = alpha2 * chan_length * qlimit**beta
        params["Chan2M3Start"] = chan2_start
        params["Chan2QStart"] = qlimit - graph_kin.upstream_sum(qlimit)
        state["CrossSection2Area"] = np.zeros(P)
        state["Sideflow1Chan"] = np.zeros(P)
        chan2_m3 = chan2_start.copy()
        state["Chan2M3Kin"] = chan2_m3
        state["ChanM3Kin"] = chan_m3
        state["Chan2QKin"] = (chan2_m3 / chan_length / alpha2) ** (1 / beta)

    if open_water:
        params["downEva"] = downstruct.copy()
        params["maxNoEva"] = 5
        flat_idx = np.arange(P, dtype=np.int64)
        codes2d, adjacent = direction_codes(graph.downstream, flat_idx, nrows, ncols)
        if adjacent:
            params["evaDir2D"] = codes2d
            params["landIdx"] = flat_idx.astype(np.int32)

    state["TimeSinceStart"] = np.float64(0.0)

    config = ModelConfig(
        split_routing=split_routing,
        simulate_lakes=with_structures,
        simulate_reservoirs=with_structures,
        open_water_evapo=open_water,
        no_rout_steps=no_rout_steps,
        dt_sec=dt_sec,
        num_lakes=num_lakes,
        num_reservoirs=num_res,
        num_catchments=int(catchments.max()) + 1,
        num_pixels=P,
        grid_rows=nrows,
        grid_cols=ncols,
    )
    graph_tochan = FlowGraph(downstream=np.full(P, -1, np.int32),
                             ldd=np.full(P, 5, np.int8), num_pixels=P)
    aux = {
        # pre-cut `graph` as ordering constraints: structure cells chunked
        # after their feeders (required by the pipelined sub-step loop)
        "schedule_kin": build_schedule(graph_kin, chunk_size, order_graph=graph),
        "schedule_tochan": build_schedule(graph_tochan, chunk_size),
        "graph": graph,
        "graph_kin": graph_kin,
        "graph_tochan": graph_tochan,
    }
    return config, params, state, aux


def _catchtotal(values, catchments, n):
    return np.bincount(catchments, weights=values, minlength=n)[catchments]


def with_options(model, seed=0, eva_outside_window=False):
    """The synthetic model `(cfg, params, state, aux)` of build_synthetic_model
    (split routing, structures and open water on) with every further option
    of the step switched on, and the inputs those options read, drawn from
    `seed`: water use with groundwater smoothing and the per-sector reports,
    the water-security indicators, rice irrigation, inflow hydrographs,
    transmission loss, polders, water levels, pF, the mass-balance and
    total-storage reports, and the average discharge. Transient land use
    stays off, since its forcing changes from step to step: its inputs are in
    `aux["landuse"]` and `landuse_forcing` gives a step's entries.

    Returns new `(cfg, params, state, aux)`; the arrays are NumPy and the
    config's field values are shared with the JAX package's ModelConfig, so
    both packages take the same inputs. `aux["forcing_options"]` holds the
    forcing entries the options add to synthetic_forcing's (the inflow
    `QInM3`, the four sectors' demands and the indicators' `MonthEnd`, False:
    a caller ends a month by setting it True for one step).

    The indicators' water regions are the four quadrants of the grid; their
    inflow points are the pixels fed by a pixel of another region, over the
    pre-cut drainage. `aux["landuse"]` holds, per fraction of
    LANDUSE_FRACTIONS, a stack of three steps' maps: forest, irrigated,
    sealed and water fractions drift by up to 10% a step, the rainfed
    (`OtherFraction`) takes up the difference, so the six still sum to 1.

    Transmission loss acts on a tenth of the fifth of the pixels with the
    largest upstream area (no lake or reservoir among them). Each takes a
    fraction of a percent of the discharge passing through: `TransSub` is a
    few thousandths of q**TransPower2 for the lower of the initial discharge
    and the discharge that 1 mm/day of runoff from the upstream area sustains,
    which keeps ChanQ**TransPower2 above TransSub, so `TransCum` holds no NaN.

    With `eva_outside_window` one headwater pixel's evaporation is handed
    straight to the pixel with the largest upstream area: that edge leaves
    any schedule window, so the evaporation chain runs outside the routing
    kernel, which then takes its result as the operand `eva`.
    """
    cfg, params, state, aux = model
    if not (cfg.split_routing and cfg.simulate_lakes and cfg.simulate_reservoirs
            and cfg.open_water_evapo):
        raise ValueError("with_options extends the model with split routing, "
                         "structures and open water")
    rng = np.random.default_rng([seed, 7])
    params, state, aux = dict(params), dict(state), dict(aux)
    P, nrows, ncols = cfg.num_pixels, cfg.grid_rows, cfg.grid_cols
    u = lambda lo, hi, shape=P: rng.uniform(lo, hi, shape)
    rows, cols = np.divmod(np.arange(P, dtype=np.int64), ncols)
    catchments = params["Catchments"]
    forcing = {}

    # rice irrigation: a tenth of the rainfed fraction on a third of the
    # pixels; planting days around the forcing's calendar day (150), so that
    # every phase of the calendar occurs somewhere
    rice = np.where(rng.random(P) < 0.3, 0.1 * params["OtherFraction"], 0.0)
    params["RiceFraction"] = rice
    params["OtherFraction"] = params["OtherFraction"] - rice
    params["RicePlantingDay1"] = rng.integers(100, 175, P).astype(np.float64)
    params["RiceHarvestDay1"] = params["RicePlantingDay1"] + 120.0
    params["RiceFlooding"] = u(5, 15)
    params["RicePercolation"] = u(1, 5)

    # water use: four regions (quadrants of the grid)
    wreg = (rows >= nrows // 2) * 2 + (cols >= ncols // 2)
    params["WUseRegionC"] = wreg.astype(np.int32)
    gw_bodies = (rng.random(P) < 0.6).astype(np.float64)
    params["GroundwaterBodies"] = gw_bodies
    frac_nc = u(0, 0.1)
    frac_gw = np.where(gw_bodies > 0, u(0, 0.3), 0.0)
    params["FractionNonConventionalWaterUsed"] = frac_nc
    params["FractionGroundwaterUsed"] = frac_gw
    params["GWfed_fraction_irrigation"] = frac_gw.copy()
    params["FractionSurfaceWaterUseDomLivInd"] = np.clip(1 - frac_gw - frac_nc, 0, 1)
    params["FractionLakeReservoirWaterUsed"] = u(0, 0.3)
    params["EFlowThreshold"] = u(0, 2)
    params["IrrigationMult"] = u(1.0, 1.2)
    params["IrrigationEfficiency"] = u(0.6, 0.9)
    params["ConveyanceEfficiency"] = u(0.7, 0.95)
    params["efficiency_irrigation"] = params["IrrigationEfficiency"] * params["ConveyanceEfficiency"]
    params["PotentialIrrigationWaterReUseM3Annual"] = u(0, 1e4)
    params["PotentialIrrigationWaterReUseM3Daily"] = params["PotentialIrrigationWaterReUseM3Annual"] / 150.0
    params["LivestockConsumptiveUseFraction"] = u(0.5, 1.0)
    params["DomesticConsumptiveUseFraction"] = u(0.1, 0.3)
    params["IndustryConsumptiveUseFraction"] = u(0.1, 0.3)
    params["EnergyConsumptiveUseFraction"] = u(0.01, 0.05)
    params["DomesticWaterSavingConstant"] = u(0.8, 1.0)
    params["leak_demand_fraction"] = u(0, 0.3)
    for key, hi in (("DomesticDemandMM", 0.3), ("IndustrialDemandMM", 0.2),
                    ("LivestockDemandMM", 0.05), ("EnergyDemandMM", 0.2)):
        forcing[key] = u(0, hi)
    params["LZSmoothRangeCells"] = 5
    params["LandRows"], params["LandCols"] = rows, cols
    params["GroundwaterCatch"] = ((gw_bodies > 0) * catchments).astype(np.int32)
    for key in ("ActualAccumulatedReUsedWaterM3", "IrriLossCUM", "wateruseCum",
                "cumulated_CH_withdrawal"):
        state[key] = np.zeros(P)

    # transmission loss on the larger channels
    params["UpTrans"] = ((params["UpArea"] >= np.quantile(params["UpArea"], 0.8))
                         & ~params["IsStructureKinematic"] & (rng.random(P) < 0.1))
    params["TransPower1"] = u(1.6, 2.4)
    params["TransPower2"] = 1.0 / params["TransPower1"]
    q_low = np.minimum(state["ChanQ"], params["UpArea"] * 1e-3 / cfg.dt_sec)
    params["TransSub"] = u(0.002, 0.005) * q_low ** params["TransPower2"]
    state["TransCum"] = np.zeros(P)

    # inflow hydrographs at a few points; the forcing differs from the last
    # step's inflow, so the sub-steps ramp
    points = np.zeros(P, bool)
    points[rng.choice(P, max(2, P // 20000), replace=False)] = True
    params["InflowPoints"] = points.astype(np.float64)
    state["QInM3Old"] = np.where(points, state["ChanQ"] * cfg.dt_sec, 0.0)
    forcing["QInM3"] = state["QInM3Old"] * u(0.5, 1.5)

    # polders, water levels, pF
    polder = np.zeros(P, bool)
    polder[rng.choice(P, max(2, P // 20000), replace=False)] = True
    params["IsPolder"] = polder
    params["PolderArea"] = np.where(polder, u(1e5, 1e6), 0.0)
    state["PolderStorageM3"] = 0.5 * params["PolderArea"]
    params["FloodPlainWidth"] = u(100, 1000)
    params["HeadMax"] = 1.0e7

    if eva_outside_window:
        down_eva = params["downEva"].copy()
        down_eva[np.argmin(params["UpArea"])] = np.argmax(params["UpArea"])
        params["downEva"] = down_eva
        # the 2-D stencil form knows neighbour cells only
        params.pop("evaDir2D", None)
        params.pop("landIdx", None)

    # water-security indicators: the regions' inflow points, population
    # and land-use mask; the monthly accumulators start at zero
    downstruct = params["downstruct"]
    fed = downstruct < P
    cross = fed & (wreg != wreg[np.minimum(downstruct, P - 1)])
    inflow_points = np.zeros(P, bool)
    inflow_points[downstruct[cross]] = True
    params["WaterRegionInflowPoints"] = inflow_points
    params["RegionPopulation"] = _catchtotal(u(0, 1000), wreg, 4)
    params["LandUseMask"] = (rng.random(P) > 0.2).astype(np.float64)
    forcing["MonthEnd"] = np.bool_(False)

    # transient land use: three steps of drifting fractions
    fractions = {k: params[k] for k in LANDUSE_FRACTIONS}
    stacks = {k: [] for k in LANDUSE_FRACTIONS}
    for _ in range(3):
        for k in ("ForestFraction", "IrrigationFraction", "DirectRunoffFraction", "WaterFraction"):
            fractions[k] = fractions[k] * u(0.9, 1.1)
        fractions["OtherFraction"] = 1 - sum(fractions[k] for k in LANDUSE_FRACTIONS
                                             if k != "OtherFraction")
        for k in LANDUSE_FRACTIONS:
            stacks[k].append(fractions[k])
    aux["landuse"] = {k: np.stack(v) for k, v in stacks.items()}

    cfg = dataclasses.replace(
        cfg, water_use=True, groundwater_smooth=True, rep_water_use=True, indicator=True,
        rice_irrigation=True, inflow=True, trans_loss=True, simulate_polders=True,
        simulate_water_levels=True, simulate_pf=True, rep_mbts=True,
        rep_total_water_storage=True, rep_average_dis=True, num_wregions=4)
    state.update({k: np.zeros(P) for k in indicator_keys(cfg)})
    state["DayCounter"] = np.float64(0.0)

    # the mass balance's initial storages (waterbalance.py:43-109,
    # routing.py:405-431), by the step's own accounting: channel, structure
    # and polder storage plus the hillslope's. The last sub-step's discharge
    # into a structure, and half a lake's last inflow, are in transit: the
    # step counts them relative to DischargeM3StructuresIni
    n = cfg.num_catchments
    dt_routing = cfg.dt_routing
    chan_m3 = state["ChanM3Kin"] + state["Chan2M3Kin"] - params["Chan2M3Start"]
    routing_init = chan_m3 + state["LakeStorageM3"] + state["ReservoirStorageM3"]
    hill1 = state["LZ"] + (params["SoilFraction"] * (
        state["CumInterception"] + state["W1a"] + state["W1b"] + state["W2"] + state["UZ"])).sum(0)
    overland = state["OFM3Other"] + state["OFM3Forest"] + state["OFM3Direct"]
    hillslope_init = (state["SnowCoverS"].sum(0) / 3 + hill1
                      + params["DirectRunoffFraction"] * state["CumInterSealed"]) * params["MMtoM3"] + overland
    dis_structure = np.where(params["IsUpsOfStructureKinematicC"], state["ChanQ"] * dt_routing, 0.0)
    dis_structure[params["LakeIndex"]] += 0.5 * state["LakeInflowOldCC"] * dt_routing
    state["DischargeM3StructuresIni"] = _catchtotal(dis_structure, catchments, n)
    state["StorageStepINIT"] = _catchtotal(routing_init, catchments, n)
    state["WaterInit"] = (_catchtotal(routing_init + state["PolderStorageM3"], catchments, n)
                          + _catchtotal(hillslope_init, catchments, n))
    aux["forcing_options"] = forcing
    return cfg, params, state, aux


def landuse_forcing(aux, t):
    """The transient land-use forcing of step t from `aux["landuse"]`
    (LisfloodRunner.forcing_for): `<key>_t` the step's fractions, `<key>_nt`
    the next step's (the last step's own at the end of the stacks)."""
    stacks = aux["landuse"]
    n = len(next(iter(stacks.values())))
    out = {}
    for k, v in stacks.items():
        out[k + "_t"] = v[t]
        out[k + "_nt"] = v[min(t + 1, n - 1)]
    return out


def synthetic_forcing(P, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return {
        "Precipitation": rng.uniform(0, 15, P).astype(dtype),
        "Tavg": rng.uniform(-5, 20, P).astype(dtype),
        "ETRef": rng.uniform(0, 5, P).astype(dtype),
        "EWRef": rng.uniform(0, 6, P).astype(dtype),
        "CalendarDay": np.float64(150.0),
        "LAIInterval": np.int32(12),
    }


# LISFLOOD's default laea projection of the European (EFAS) grids
LAEA_PROJ4 = ("+proj=laea +lat_0=52 +lon_0=10 +x_0=4321000 +y_0=3210000 +ellps=GRS80 "
              "+units=m +no_defs")
# the main path's options (split routing, lakes, reservoirs, open-water
# evaporation, the mass-balance reports); InitLisflood is on by default in
# the option registry
CATCHMENT_OPTIONS = {"InitLisflood": False, "SplitRouting": True, "simulateLakes": True,
                     "simulateReservoirs": True, "openwaterevapo": True, "repMBTs": True}
# write_catchment(grid="geographic"): 0.05 degree cells from 5 E, 56 N, on
# the sphere of EARTH_RADIUS [m], with the grid mapping of WGS 84 lat/lon
GEO_CELL, GEO_WEST, GEO_NORTH = 0.05, 5.0, 56.0
EARTH_RADIUS = 6371007.2
GEO_MAPPING = ("wgs_1984", {"grid_mapping_name": "latitude_longitude",
                            "longitude_of_prime_meridian": 0.0,
                            "semi_major_axis": 6378137.0,
                            "inverse_flattening": 298.257223563})
METEO_STACKS = {"PrecipitationMaps": ("pr", 0.0, 15.0), "TavgMaps": ("ta", -5.0, 20.0),
                "ET0Maps": ("et", 0.0, 5.0), "E0Maps": ("e0", 0.0, 6.0),
                "ES0Maps": ("es", 0.0, 5.0)}


def rice_calendars(days):
    """(planting, harvest) day pairs of the first rice season such that each
    phase of riceirrigation.py:78-179 falls on one of the calendar `days`:
    soil saturation [planting - 20, planting - 10), flooding [planting - 10,
    planting), growing [planting, harvest - 20) and drainage [harvest - 10,
    harvest). Every day lies in 1..365 and no phase wraps the year end
    (the step's `before` wraps a day below 0 to the previous year, and a
    wrapped phase never holds), plus one season outside the run."""
    out = set()
    for d in days:
        pl = max(d + 15, 20)                               # saturation on d
        if pl <= 365 and pl - 20 <= d < pl - 10:
            out.add((pl, pl + 120))
        pl = min(max(d + 5, 10), 365)                      # flooding on d
        if pl - 10 <= d < pl:
            out.add((pl, pl + 120))
        pl = max(d - 5, 1)                                 # growing on d
        if pl <= d < pl + 100 and pl + 120 <= 365:
            out.add((pl, pl + 120))
        ha = min(max(d + 5, 10), 365)                      # drainage on d
        if ha - 10 <= d < ha:
            out.add((max(ha - 120, 1), ha))
    out.add((120, 240))
    return sorted(out)


def _option_inputs(binding, opts, rng, dirs, nrows, ncols, n_steps, start, land, channel, order,
                   fractions, write, write_nc, xy, rng2, avg_dis):
    """The inputs of the options `opts` switches on, for write_catchment:
    maps through `write`, netCDF stacks through `write_nc`, into `binding`.
    The options of the first slices draw from `rng`, the later ones
    (useWaterDemandAveYear's stacks among them) from `rng2`."""
    P = nrows * ncols
    rows, cols = np.divmod(np.arange(P), ncols)
    end = start + datetime.timedelta(days=n_steps - 1)

    def field(lo, hi, r=rng):
        return np.where(land, r.uniform(lo, hi, P), np.nan).astype(np.float32)

    def stack(name, dates, maps):
        """A netCDF stack of `maps` at `dates` in maps/, bound to `name`."""
        ref = dates[0]
        coords = [("time", np.array([(d - ref).days for d in dates], np.float64),
                   {"units": f"days since {ref:%Y-%m-%d}", "calendar": "proleptic_gregorian"})]
        data = np.where(np.isnan(maps), -9999.0, maps).reshape(len(dates), nrows, ncols)
        write_nc(os.path.join(dirs["maps"], name + ".nc"), coords + xy, "value",
                 data.astype(np.float32))
        binding[name] = f"$(PathMaps)/{name}.nc"

    if opts.get("inflow"):
        # two inflow points on the channels and their hydrograph, a row a step
        points = np.zeros(P, np.int32)
        points[order[12:14]] = (1, 2)
        write("InflowPoints", points, csf.VS_NOMINAL, missing=points == 0)
        tss = TssWriter(os.path.join(dirs["tables"], "inflow.tss"), [1, 2])
        for step in range(1, n_steps + 1):
            tss.sample(step, rng.uniform(5.0, 50.0, 2))
        tss.flush()
        binding["QInTS"] = "$(PathTables)/inflow.tss"
    if opts.get("wateruse"):
        if opts.get("wateruseRegion"):
            # six regions, 1..6: thirds of the columns by halves of the
            # rows, whose borders the channels cross
            write("WUseRegion", (1 + cols * 3 // ncols + 3 * (rows >= nrows // 2))
                  .astype(np.int32), csf.VS_NOMINAL)
        else:
            write("WUseRegion", (cols >= ncols // 2).astype(np.int32), csf.VS_NOMINAL)
        write("GroundwaterBodies", (rng.random(P) < 0.6).astype(np.float32))
        for name, lo, hi in (("FractionGroundwaterUsed", 0, 0.3),
                             ("FractionNonConventionalWaterUsed", 0, 0.1),
                             ("FractionLakeReservoirWaterUsed", 0, 0.3),
                             ("EFlowThreshold", 0, 2), ("IrrigationMult", 1, 1.2),
                             ("IndustryConsumptiveUseFraction", 0.1, 0.3),
                             ("IrrigationWaterReUseM3", 0, 1e4),
                             ("EnergyConsumptiveUseFraction", 0.01, 0.05),
                             ("LivestockConsumptiveUseFraction", 0.5, 1),
                             ("LeakageFraction", 0, 0.2), ("WaterSavingFraction", 0, 0.2),
                             ("DomesticConsumptiveUseFraction", 0.1, 0.3),
                             ("LeakageWaterLoss", 0, 0.5), ("IrrigationEfficiency", 0.6, 0.9),
                             ("ConveyanceEfficiency", 0.7, 0.95)):
            write(name, field(lo, hi))
        binding.update({"WUsePercRemain": "0.5", "maxNoWateruse": "1",
                        "IrrigationWaterReUseNumDays": "150", "LeakageReductionFraction": "0",
                        "IrrigationType": "1"})
        # the demands [mm/day], monthly from the month before the start to
        # the month after the end; with useWaterDemandAveYear one average
        # year of twelve monthly maps, dated in 2010, whatever the run's
        if opts.get("useWaterDemandAveYear"):
            r, months = rng2, [datetime.datetime(2010, m, 1) for m in range(1, 13)]
        else:
            r, months = rng, [datetime.datetime(start.year, start.month, 1)]
            months.insert(0, (months[0] - datetime.timedelta(days=1)).replace(day=1))
            while months[-1] <= end:
                months.append((months[-1] + datetime.timedelta(days=32)).replace(day=1))
        for name, hi in (("DomesticDemandMaps", 0.3), ("IndustrialDemandMaps", 0.2),
                         ("LivestockDemandMaps", 0.05), ("EnergyDemandMaps", 0.2)):
            stack(name, months, np.stack([field(0, hi, r) for _ in months]))
        if opts.get("groundwaterSmooth"):
            binding["LZSmoothRange"] = "5"
        if opts.get("indicator"):
            write("Population", field(0, 1000))
            write("LandUseMask", (rng.random(P) > 0.2).astype(np.float32))
            binding["PopulationMaps"] = binding["Population"]
    if opts.get("TransientLandUseChange"):
        # one map a year from the year before the start: forest, irrigated,
        # sealed and water fractions drift by up to 10% a year, the rainfed
        # (OtherFraction) takes up the difference
        years = [datetime.datetime(y, 1, 1) for y in range(start.year - 1, end.year + 2)]
        frac = dict(fractions)
        maps = {k: [] for k in LANDUSE_FRACTIONS}
        for _ in years:
            for k in ("ForestFraction", "IrrigationFraction", "DirectRunoffFraction",
                      "WaterFraction"):
                frac[k] = frac[k] * rng.uniform(0.9, 1.1, P)
            frac["OtherFraction"] = 1 - sum(frac[k] for k in LANDUSE_FRACTIONS
                                            if k != "OtherFraction")
            for k in LANDUSE_FRACTIONS:
                maps[k].append(np.where(land, frac[k], np.nan))
        for k in LANDUSE_FRACTIONS:
            stack(k + "Maps", years, np.stack(maps[k]))
    if opts.get("varfractionwater"):
        water = np.where(land, fractions["WaterFraction"], np.nan)
        write("FracMaxWater", (water * rng.uniform(1.0, 1.5, P)).astype(np.float32))
        monthly = [datetime.datetime(2000, m, 1) for m in range(1, 13)]
        stack("WFractionMaps", monthly, np.stack([water * rng.uniform(0.5, 1.0, P)
                                                  for _ in monthly]))

    if opts.get("riceIrrigation"):
        # each land cell takes one of the calendars under which a phase of
        # the season falls in the run; the second season's days are read
        # and not used by the step
        days = [(start + datetime.timedelta(days=i)).timetuple().tm_yday for i in range(n_steps)]
        calendars = np.array(rice_calendars(days), np.float64)
        plant, harvest = calendars[rng2.integers(0, len(calendars), P)].T
        for name, v in (("RicePlantingDay1", plant), ("RiceHarvestDay1", harvest),
                        ("RicePlantingDay2", plant + 150), ("RiceHarvestDay2", harvest + 150)):
            write(name, np.where(land, v, np.nan).astype(np.float32))
        write("RiceFlooding", field(5, 15, rng2))
        write("RicePercolation", field(1, 5, rng2))
    if opts.get("simulatePolders"):
        # three polders on channel cells below the largest rivers' sites,
        # their areas in a lookup table
        polders = order[16:25:4]
        ids = np.zeros(P, np.int32)
        ids[polders] = np.arange(1, 4)
        write("PolderSites", ids, csf.VS_NOMINAL, missing=ids == 0)
        with open(os.path.join(dirs["tables"], "TabPolderArea.txt"), "w") as fh:
            fh.writelines(f"{i} {float(v)!r}\n" for i, v in enumerate(rng2.uniform(1e5, 1e6, 3), 1))
        binding["TabPolderArea"] = "$(PathTables)/TabPolderArea.txt"
        binding["PolderInitialLevelValue"] = "0.5"
    if opts.get("simulatePF"):
        binding["HeadMax"] = "10000000"
    if opts.get("simulateWaterLevels"):
        write("FloodPlainWidth", field(100, 1000, rng2))
    if opts.get("drainedIrrigation"):
        binding["DrainedFraction"] = "0.3"
    if opts.get("TransLoss"):
        # the cells whose average discharge (the AvgDis map) exceeds 20 m3/s
        # lose water
        binding.update({"TransArea": "20", "TransSub": "1e-3", "TransPower1": "2.0",
                        "UpAreaTrans": avg_dis})


# the outputs write_catchment(outputs=True) binds: the end maps of the main
# path's state, one state-map stack (LZ, every reported step), the discharge
# TSS at the gauges, the mass-balance TSS per catchment and two upstream
# averages (the TSS `total` operation; active with repBal1)
END_MAPS = ("ChSideEnd", "ChanCrossSectionEnd", "ChanQEnd", "CrossSection2End",
            "CumIntSealedEnd", "CumInterceptionEnd", "CumInterceptionForestEnd",
            "CumInterceptionIrrigationEnd", "DSLREnd", "DSLRForestEnd", "DSLRIrrigationEnd",
            "FrostIndexEnd", "LZEnd", "LakeLevelEnd", "LakePrevInflowEnd", "LakePrevOutflowEnd",
            "OFDirectEnd", "OFForestEnd", "OFOtherEnd", "ReservoirFillEnd", "SnowCoverAEnd",
            "SnowCoverBEnd", "SnowCoverCEnd", "Theta1End", "Theta1ForestEnd",
            "Theta1IrrigationEnd", "Theta2End", "Theta2ForestEnd", "Theta2IrrigationEnd",
            "Theta3End", "Theta3ForestEnd", "Theta3IrrigationEnd", "UZEnd", "UZForestEnd",
            "UZIrrigationEnd")
# a warm start from a run of write_catchment(outputs=True): each initial
# value binding and the end map (END_MAPS) that holds it
WARM_START = {
    "SnowCoverAInitValue": "SnowCoverAEnd", "SnowCoverBInitValue": "SnowCoverBEnd",
    "SnowCoverCInitValue": "SnowCoverCEnd", "FrostIndexInitValue": "FrostIndexEnd",
    "CumIntInitValue": "CumInterceptionEnd", "CumIntForestInitValue": "CumInterceptionForestEnd",
    "CumIntIrrigationInitValue": "CumInterceptionIrrigationEnd",
    "CumIntSealedInitValue": "CumIntSealedEnd",
    "UZInitValue": "UZEnd", "UZForestInitValue": "UZForestEnd",
    "UZIrrigationInitValue": "UZIrrigationEnd",
    "DSLRInitValue": "DSLREnd", "DSLRForestInitValue": "DSLRForestEnd",
    "DSLRIrrigationInitValue": "DSLRIrrigationEnd", "LZInitValue": "LZEnd",
    "ThetaInit1Value": "Theta1End", "ThetaInit2Value": "Theta2End", "ThetaInit3Value": "Theta3End",
    "ThetaForestInit1Value": "Theta1ForestEnd", "ThetaForestInit2Value": "Theta2ForestEnd",
    "ThetaForestInit3Value": "Theta3ForestEnd",
    "ThetaIrrigationInit1Value": "Theta1IrrigationEnd",
    "ThetaIrrigationInit2Value": "Theta2IrrigationEnd",
    "ThetaIrrigationInit3Value": "Theta3IrrigationEnd",
    "TotalCrossSectionAreaInitValue": "ChanCrossSectionEnd", "PrevDischarge": "ChanQEnd",
    "CrossSection2AreaInitValue": "CrossSection2End", "PrevSideflowInitValue": "ChSideEnd",
    "OFDirectInitValue": "OFDirectEnd", "OFOtherInitValue": "OFOtherEnd",
    "OFForestInitValue": "OFForestEnd", "LakeInitialLevelValue": "LakeLevelEnd",
    "LakePrevInflowValue": "LakePrevInflowEnd", "LakePrevOutflowValue": "LakePrevOutflowEnd",
    "ReservoirInitialFillValue": "ReservoirFillEnd"}


def warm_start(out_dir, netcdf=False, lz_step=None):
    """The bindings of a warm start from the end maps that a run of
    write_catchment(outputs=True) wrote into `out_dir`: PCRaster maps
    (`name.map`), or netCDF (`writeNetcdf`, the binding without its .nc).
    `lz_step` n takes LZInitValue from the LZ state-map stack instead: its
    n-th map (lz000000.00n) of a PCRaster stack, and for netCDF the stack
    lz.nc, at the timestepInit the caller binds."""
    out = {k: os.path.join(out_dir, v.lower() + ("" if netcdf else ".map"))
           for k, v in WARM_START.items()}
    if lz_step is not None:
        out["LZInitValue"] = os.path.join(out_dir, "lz" if netcdf else f"lz000000.{lz_step:03d}")
    return out


OUTPUT_TSS = {"DisTS": "dis", "ChanqTS": "chanq", "WaterMassBalanceTSS": "mbError",
              "MassBalanceMMTSS": "mbErrorMM", "MBErrorStorageRatioTSS": "mbErrorStorage",
              "AverageFractionsCatchmentTSS": "averageFractions",
              "MassBalanceErrorSplitRoutingTSS": "mbErrorSplitRouting",
              "OutletDischargeErrorSplitRoutingTSS": "outletDischargeError",
              "TotalRunoffAvUpsTS": "totalRunoffUps", "EvaOpenWaterAvUpsTS": "evaOpenWaterUps"}


# every option whose inputs write_catchment writes, all at once, and the
# report options of their outputs (option_reports)
EVERY_OPTION_INPUTS = {
    "inflow": True, "wateruse": True, "TransientWaterDemandChange": True, "indicator": True,
    "TransientLandUseChange": True, "varfractionwater": True, "riceIrrigation": True,
    "simulatePolders": True, "simulatePF": True, "simulateWaterLevels": True,
    "groundwaterSmooth": True, "wateruseRegion": True, "useWaterDemandAveYear": True,
    "drainedIrrigation": True, "TemperatureInKelvin": True, "TransLoss": True}
EVERY_OPTION_REPORTS = ("repAverageDis", "repWaterUse", "repWIndex", "repTotalAbs",
                        "repTotalWaterStorageMaps", "repPFMaps", "repPFUpsGauges",
                        "repWaterLevelTs", "repsimulatePolders")
EVERY_OPTION = {**EVERY_OPTION_INPUTS, **{k: True for k in EVERY_OPTION_REPORTS}}
# outputs of the registry whose fields neither package's step computes
# (ROADMAP.md Queue 3): option_reports leaves them unbound
UNREPORTED = ("AreatotalIrrigationSWUseM3", "FractionAbstractedFromChannels",
              "LivestockConsumptiveUse", "PotentialSurfaceWaterAvailabilityForIrrigationM3",
              "PolderFluxTS", "WaterUseTS")
_REGISTRY = os.path.join(os.path.dirname(os.path.dirname(__file__)), "config", "registry.json")
# the options of write_catchment's main path: their outputs are END_MAPS,
# LZState and OUTPUT_TSS
_MAIN_PATH = {"nonInit", "SplitRouting", "simulateLakes", "simulateReservoirs", "openwaterevapo"}


def _registry():
    with open(_REGISTRY) as fh:
        return json.load(fh)


def _report_options(entry):
    return entry.get("steps", []) + entry.get("all", []) + entry.get("end", []) + \
        entry.get("repoption", [])


def option_reports(opts):
    """The outputs that write_catchment(outputs=True) binds beside END_MAPS,
    LZState and OUTPUT_TSS, for the options `opts` (name -> bool, over the
    registry's defaults): each map and TSS of the registry that a report
    option switched on reports, when the options its restrictoption names
    (but the report options) are all on and one of them is beyond the main
    path's, and TotalWaterStorageMaps with repTotalWaterStorageMaps; not
    those of UNREPORTED. A TSS is bound where its sites are Gauges,
    Catchments or PolderSites. Returns the binding -> file name under
    PathOut: the TSS as `<name>.tss`, end maps as the lower-case name,
    stacks under a prefix whose first eight characters (PCRaster's stack
    names) are unique."""
    reg = _registry()
    on = {k for k, v in {**reg["options"], **opts}.items() if v}
    out, prefixes = {}, set()
    for kind in ("reported_maps", "timeseries"):
        for name, e in sorted(reg[kind].items()):
            reports = set(_report_options(e))
            physics = {o for o in e["restrictoption"] if not o.startswith("rep")}
            if not (reports & on and physics <= on | {"nonInit"}):
                continue
            if not (physics - _MAIN_PATH or "repTotalWaterStorageMaps" in reports):
                continue
            if name in UNREPORTED:
                continue
            if kind == "timeseries":
                if e["where"] in ("Gauges", "Catchments", "PolderSites"):
                    out[name] = name + ".tss"
                continue
            prefix = name.lower()
            if e["steps"] or e["all"]:
                prefix = prefix[:8]
                i = 0
                while prefix in prefixes:
                    i += 1
                    prefix = f"{name.lower()[:6]}{i:02d}"
                prefixes.add(prefix)
            out[name] = prefix
    return out


def expected_outputs(settings):
    """The names of the files a run of `settings` writes into PathOut,
    predicted from registry.json alone with the reference's activation rule
    (settings.py:666-680): a map or TSS is active when one of its report
    options is on and, if it has restrictoptions, all of those are on; an
    active output whose binding is set is written. With writeNetcdf (or
    writeNetcdfStack) a map output is one `<binding>.nc`; in PCRaster an end
    map is `<binding>.map` and a stack one numbered map (8.3 names) a step
    it reports: every step within ReportSteps, the monthly ones at a month's
    last step (which the run marks only with water use and the indicators,
    the reference's indicatorcalc.py:92-96) and the yearly ones at a
    year's."""
    reg = _registry()
    opts, binding = settings.options, settings.binding

    def active(reports, restrict):
        return any(opts.get(o) for o in reports) and all(opts.get(o) for o in restrict)

    netcdf = opts.get("writeNetcdf") or opts.get("writeNetcdfStack")
    step0 = settings.step_start_int
    dt = datetime.timedelta(seconds=float(binding["DtSec"]))
    dates = [settings.step_start_dt + i * dt for i in range(settings.step_end_int - step0 + 1)]
    ends = opts.get("wateruse") and opts.get("indicator")
    due = {"all": [], "monthly": [], "yearly": []}
    for i, date in enumerate(dates):
        due["all"].append(step0 + i)
        if ends and (date + dt).month != date.month:
            due["monthly"].append(step0 + i)
        if ends and (date + dt).year != date.year:
            due["yearly"].append(step0 + i)
    rep_steps = set(settings.report_steps)
    names, seen = set(), set()
    for name, e in reg["reported_maps"].items():
        path = binding.get(name)
        if not path:
            continue
        path = os.path.normpath(path)
        base = os.path.basename(path)
        for trigger in ("end", "steps", "all"):
            if not active(e[trigger], e["restrictoption"]) or path in seen:
                continue
            steps = due["monthly" if e["monthly"] else "yearly" if e["yearly"] else "all"]
            if trigger == "steps":
                steps = [s for s in steps if s in rep_steps]
                if not rep_steps & set(due["all"]):
                    continue
            seen.add(path)
            if netcdf:
                names.add(base + ".nc")
            elif trigger == "end":
                names.add(base if base.endswith(".map") else base + ".map")
            else:
                for s in steps:
                    nr = str(s)
                    stem = f"{base[:8]}{'0' * (11 - len(base[:8]) - len(nr))}{nr}"
                    names.add(f"{stem[:8]}.{stem[8:]}")
    for name, e in reg["timeseries"].items():
        path = binding.get(name)
        if path and active(e["repoption"], e["restrictoption"]):
            base = os.path.basename(os.path.normpath(path))
            names.add(base if base.endswith(".tss") else base + ".tss")
    return names


def write_catchment(path, nrows, ncols, seed=0, n_steps=4, options=None, nc_format="netcdf4",
                    outputs=False, meteo_format="pcraster", start=datetime.date(2000, 1, 1),
                    user=None, grid="laea", gauges="map", meteo_margin=0, lat_ascending=False,
                    submask=False, mask_format="map", lon_descending=False):
    """Write a catchment of nrows x ncols 5 km cells as LISFLOOD reads it
    from disk, into the directory `path`, and return its settings file.

    A test fixture, like with_options; nothing in the step depends on it.
    Every file is written with the port's own writers:
      - PCRaster maps: the mask (a quarter disc of sea in the north-west
        corner left out), the LDD of synthetic_drainage(nrows, ncols, seed),
        the channels (cells whose upstream cell count is in the top fifth,
        so the overland graph has edges), lake, reservoir and gauge sites at
        the channel cells of largest upstream count, the lakes' mask, and
        maps of the parameters that vary in space (land-use fractions,
        soil depths and conductivities, channel and slope geometry, the
        average discharge that splits the channel's two lanes);
      - the lake and reservoir lookup tables;
      - netCDF: the latitude template and the LAI maps (36 slices for each of
        three vegetation types) on a projected laea x/y grid, as netCDF-4
        (`nc_format="netcdf4"`, through h5py) or netCDF classic
        (`nc_format="classic"`, through SciPy);
      - meteo (precipitation, temperature and the three evaporation
        forcings) as PCRaster stacks of `n_steps` maps, daily from
        01/01/2000;
      - every other binding the step's initialisation reads, as a number;
      - settings.xml, with split routing, lakes, reservoirs, open-water
        evaporation and the mass-balance reports on, DtSec 86400 and
        DtSecChannel 3600 (NoRoutSteps 24); `options` (name -> bool) sets
        further options over these.
    Data are drawn from `seed`. With the defaults of the arguments below the
    files are those written before they existed, bit for bit:
      - `outputs`: bind the outputs of END_MAPS, the state-map stack
        LZState and the TSS of OUTPUT_TSS under $(PathOut) (which outputs
        are written the options decide);
      - `meteo_format` "netcdf": the meteo as one netCDF stack a forcing
        (in `nc_format`, a daily time axis) instead of PCRaster stacks,
        with the same values;
      - `start`: the first day (CalendarDayStart and StepStart);
      - `user`: more lfuser variables (EnsMembers, FilterSteps);
      - the inputs of the options that `options` switches on, drawn from a
        second stream of `seed`: inflow (two points on the channels and
        their hydrograph TSS), water use (two regions, the four demands as
        monthly netCDF stacks, read as transient forcing with
        TransientWaterDemandChange and as the map nearest the start
        without), the indicators (population, land-use mask), transient
        land use (yearly netCDF stacks of the six fractions, one map a
        year from the year before the start, the fractions drifting year
        by year) and the variable water fraction (twelve monthly maps);
      - `grid` "geographic": a lat/lon grid of GEO_CELL degree cells from
        GEO_WEST, GEO_NORTH, with gridSizeUserDefined on and the maps
        PixelLengthUser and PixelAreaUser of each cell's size on the sphere
        (the length the square root of the area); the channel lengths and
        AvgDis follow them, and every netCDF file is on lon/lat with the
        `latitude_longitude` grid mapping GEO_MAPPING;
      - `gauges` "coords": bind Gauges to the "x1 y1 x2 y2 ..." centres of
        the gauge cells (Gauges.map is written all the same);
      - `meteo_margin` k (netCDF meteo): each forcing stack covers the
        mask's window and k cells more on every side (the edge's values);
      - `lat_ascending` (netCDF meteo): the forcing stacks' latitude (or y)
        axis runs south to north;
      - `submask`: also write SubMask.map, true on the land cells upstream
        of the second gauge and on that cell, missing elsewhere;
      - `mask_format` "netcdf": MaskMap bound to MaskMap.nc (1 on land, 0
        on sea, in `nc_format`); "string": MaskMap bound to the "ncols
        nrows cellsize west north" string of the grid, and the LDD missing
        on the sea, which then leaves the sea out of the model's mask;
      - `lon_descending`: every netCDF file's x (or lon) axis runs east to
        west, with its data in that order.
    The later options' inputs (and, with `outputs`, the reports of
    option_reports), drawn from a third stream of `seed`:
      - riceIrrigation: the rice fraction on about a third of the land (the
        rainfed fraction takes it elsewhere), the first season's planting
        and harvest days from rice_calendars of the run's days, the flooding
        and percolation maps;
      - simulatePolders: three polders (PolderSites) on channel cells,
        TabPolderArea and PolderInitialLevelValue; simulatePF: HeadMax;
        simulateWaterLevels: FloodPlainWidth; groundwaterSmooth:
        LZSmoothRange; drainedIrrigation: DrainedFraction;
      - wateruseRegion: six water regions (1..6) instead of two;
      - useWaterDemandAveYear: the demand stacks as twelve monthly maps of
        2010;
      - TemperatureInKelvin: the temperature stack in kelvin (the same
        draws plus 273.15);
      - TransLoss: TransArea 20 m3/s of the AvgDis map (UpAreaTrans),
        TransSub and TransPower1."""
    if nc_format not in ("netcdf4", "classic"):
        raise ValueError(f"nc_format {nc_format!r}: 'netcdf4' or 'classic'")
    if grid not in ("laea", "geographic"):
        raise ValueError(f"grid {grid!r}: 'laea' or 'geographic'")
    if gauges not in ("map", "coords"):
        raise ValueError(f"gauges {gauges!r}: 'map' or 'coords'")
    if (meteo_margin or lat_ascending) and meteo_format != "netcdf":
        raise ValueError("meteo_margin and lat_ascending need meteo_format='netcdf'")
    if mask_format not in ("map", "netcdf", "string"):
        raise ValueError(f"mask_format {mask_format!r}: 'map', 'netcdf' or 'string'")
    geographic = grid == "geographic"
    opts = {**CATCHMENT_OPTIONS, **({"gridSizeUserDefined": True} if geographic else {}),
            **(options or {})}
    rng = np.random.default_rng([seed, 11])
    rng2 = np.random.default_rng([seed, 13])
    root = os.path.abspath(path)
    dirs = {k: os.path.join(root, k) for k in ("maps", "tables", "meteo", "out")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    P = nrows * ncols
    if geographic:
        cell, west, north = GEO_CELL, GEO_WEST, GEO_NORTH
    else:
        cell, west, north = 5000.0, 2_500_000.0, 5_500_000.0
    rows, cols = np.divmod(np.arange(P, dtype=np.int64), ncols)
    land = (rows / nrows) ** 2 + (cols / ncols) ** 2 >= 0.04
    ldd, down = synthetic_drainage(nrows, ncols, seed)
    codes, _ = direction_codes(down, np.arange(P), nrows, ncols)
    codes[codes == 0] = 5
    flow = FlowGraph(downstream=down, ldd=ldd, num_pixels=P)
    ups = flow.accuflux(np.ones(P))
    channel = land & (ups >= np.quantile(ups[land], 0.8))
    order = np.argsort(np.where(channel, ups, -1.0), kind="stable")[::-1]
    lakes, reservoirs, gauge_cells = order[4:6], order[8:10], order[:3]
    binding = {}
    if geographic:
        # each cell's area on the sphere [m2] and a length of the same square
        lat_n = np.radians(north - cell * rows)
        lat_s = np.radians(north - cell * (rows + 1))
        pixel_area = EARTH_RADIUS**2 * np.radians(cell) * (np.sin(lat_n) - np.sin(lat_s))
        metres = np.sqrt(pixel_area)
        up_area = flow.accuflux(pixel_area)
    else:
        metres = cell
        up_area = ups * cell * cell

    def write(name, values, scale=csf.VS_SCALAR, missing=None):
        """A map of the grid; `values` per cell, NaN (or `missing`) = MV."""
        file = os.path.join(dirs["maps"], name + ".map")
        csf.write_map(file, np.asarray(values).reshape(nrows, ncols), west, north, cell,
                      value_scale=scale,
                      mv_mask=None if missing is None else missing.reshape(nrows, ncols))
        binding[name] = f"$(PathMaps)/{name}.map"

    def field(lo, hi):
        return np.where(land, rng.uniform(lo, hi, P), np.nan).astype(np.float32)

    def sites(name, cells):
        ids = np.zeros(P, np.int32)
        ids[cells] = np.arange(1, len(cells) + 1)
        write(name, ids, csf.VS_NOMINAL, missing=ids == 0)

    write("MaskMap", land.astype(np.uint8), csf.VS_BOOLEAN)
    write("Ldd", codes.astype(np.uint8), csf.VS_LDD,
          missing=~land if mask_format == "string" else None)
    write("Channels", channel.astype(np.uint8), csf.VS_BOOLEAN)
    sites("LakeSites", lakes)
    sites("ReservoirSites", reservoirs)
    sites("Gauges", gauge_cells)
    if gauges == "coords":
        g_rows, g_cols = np.divmod(gauge_cells, ncols)
        binding["Gauges"] = " ".join(f"{float(west + cell * (c + 0.5))!r} "
                                     f"{float(north - cell * (r + 0.5))!r}"
                                     for r, c in zip(g_rows, g_cols))
    if submask:
        # the land cells that drain through the second gauge's cell
        inside = np.zeros(P, bool)
        inside[gauge_cells[1]] = True
        for i in np.argsort(-ups, kind="stable"):
            if down[i] >= 0 and inside[down[i]]:
                inside[i] = True
        inside &= land
        write("SubMask", inside.astype(np.uint8), csf.VS_BOOLEAN, missing=~inside)
    if geographic:
        write("PixelLengthUser", metres.astype(np.float32))
        write("PixelAreaUser", pixel_area.astype(np.float32))
    lake_mask = np.isin(np.arange(P), lakes) | np.isin(down, lakes)
    write("LakeMask", lake_mask.astype(np.uint8), csf.VS_BOOLEAN)
    fr = rng.dirichlet(np.ones(5), P).T * 0.2      # water, direct, forest, irrigated, rice
    fractions = {"WaterFraction": fr[0], "DirectRunoffFraction": fr[1],
                 "ForestFraction": fr[2], "IrrigationFraction": fr[3], "RiceFraction": fr[4]}
    fractions["OtherFraction"] = 1 - fr.sum(0)
    if opts.get("riceIrrigation"):
        paddy = rng2.random(P) < 0.3
        fractions["OtherFraction"] = fractions["OtherFraction"] + np.where(paddy, 0.0, fr[4])
        fractions["RiceFraction"] = np.where(paddy, fr[4], 0.0)
    for name, v in fractions.items():
        write(name, np.where(land, v, np.nan).astype(np.float32))
    size = np.log1p(ups) / np.log1p(ups.max())    # 0 at the headwaters, 1 at the outlet
    for name, lo, hi in (("ElevationStD", 0, 300), ("Grad", 1e-3, 0.1),
                         ("SoilDepth1", 50, 150), ("SoilDepth1Forest", 60, 200),
                         ("SoilDepth2", 100, 400), ("SoilDepth2Forest", 150, 500),
                         ("SoilDepth3", 200, 800), ("SoilDepth3Forest", 300, 1000),
                         ("MapKSat1", 10, 300), ("MapKSat2", 5, 100), ("MapKSat3", 1, 50),
                         ("ChanGrad", 1e-4, 0.01), ("ChanMan", 0.02, 0.06),
                         ("LZAvInflowMap", 0.1, 1.0)):
        write(name, field(lo, hi))
    write("ChanLength", np.where(land, metres * (1 + 0.4 * rng.random(P)), np.nan).astype(np.float32))
    write("ChanBottomWidth", np.where(land, 2 + 98 * size, np.nan).astype(np.float32))
    write("ChanDepthThreshold", np.where(land, 0.5 + 7.5 * size, np.nan).astype(np.float32))
    # the average discharge of 1 mm/day of runoff from the upstream area
    write("AvgDis", np.where(land, up_area * 1e-3 / 86400.0, np.nan).astype(np.float32))

    tables = {
        "TabLakeArea": (lakes, rng.uniform(1e7, 1e8, 2)),
        "TabLakeA": (lakes, rng.uniform(30, 150, 2)),
        "TabLakeAvNetInflowEstimate": (lakes, rng.uniform(10, 50, 2)),
        "TabTotStorage": (reservoirs, rng.uniform(1e8, 1e9, 2)),
        "TabConservativeStorageLimit": (reservoirs, np.full(2, 0.1)),
        "TabNormalStorageLimit": (reservoirs, np.full(2, 0.45)),
        "TabFloodStorageLimit": (reservoirs, np.full(2, 0.9)),
        "TabNonDamagingOutflowQ": (reservoirs, rng.uniform(100, 300, 2)),
        "TabNormalOutflowQ": (reservoirs, rng.uniform(20, 80, 2)),
        "TabMinOutflowQ": (reservoirs, rng.uniform(1, 5, 2)),
    }
    for name, (cells, values) in tables.items():
        with open(os.path.join(dirs["tables"], name + ".txt"), "w") as fh:
            fh.writelines(f"{i} {float(v)!r}\n" for i, v in enumerate(values, 1))
        binding[name] = f"$(PathTables)/{name}.txt"

    # netCDF on the projected grid (or lon/lat): x ascending, y descending
    # (north first)
    def axes(k=0):
        """The grid's y and x coordinates, k cells more on every side."""
        x = west + cell * (np.arange(-k, ncols + k) + 0.5)
        y = north - cell * (np.arange(-k, nrows + k) + 0.5)
        if geographic:
            return [("lat", y, {"standard_name": "latitude", "units": "degrees_north"}),
                    ("lon", x, {"standard_name": "longitude", "units": "degrees_east"})]
        return [("y", y, {"standard_name": "projection_y_coordinate", "units": "m"}),
                ("x", x, {"standard_name": "projection_x_coordinate", "units": "m"})]

    xy = axes()
    days = ("time", np.arange(36, dtype=np.float64) * 10.0,
            {"units": "days since 2000-01-01", "calendar": "proleptic_gregorian"})
    mapping = GEO_MAPPING if geographic else None

    def write_nc(file, coords, var, data):
        """A netCDF file of one variable, in `nc_format` (with the grid
        mapping on a geographic grid); x is the last of `coords`."""
        if lon_descending:
            coords = coords[:-1] + [(coords[-1][0], coords[-1][1][::-1], coords[-1][2])]
            data = np.ascontiguousarray(data[..., ::-1])
        if nc_format == "classic":
            ncdf.write_classic(file, coords, var, data, fill_value=-9999.0,
                               grid_mapping=mapping)
        else:
            f = ncdf.create_nc(file)
            try:
                for dim, values, attrs in coords:
                    ncdf.add_dimension(f, dim, values, attrs)
                attrs = None
                if mapping is not None:
                    ncdf.add_grid_mapping(f, *mapping)
                    attrs = {"grid_mapping": mapping[0]}
                ncdf.add_variable(f, var, tuple(c[0] for c in coords), data.dtype,
                                  fill_value=-9999.0, attrs=attrs)[...] = data
            finally:
                f.close()

    def write_map_nc(name, coords, var, data):
        write_nc(os.path.join(dirs["maps"], name + ".nc"), coords, var, data)
        binding[name] = f"$(PathMaps)/{name}.nc"

    write_map_nc("netCDFtemplate", xy, "template", np.where(land, 1.0, -9999.0)
                 .reshape(nrows, ncols).astype(np.float32))
    if mask_format == "netcdf":
        write_map_nc("MaskMap", xy, "mask", land.reshape(nrows, ncols).astype(np.float32))
    elif mask_format == "string":
        binding["MaskMap"] = f"{ncols} {nrows} {cell!r} {west!r} {north!r}"
    season = 1 + 0.5 * np.sin(2 * np.pi * np.arange(36) / 36)
    for name, lo, hi in (("LAIOtherMaps", 0.5, 3), ("LAIForestMaps", 2, 6),
                         ("LAIIrrigationMaps", 0.5, 4)):
        base = rng.uniform(lo, hi, P).reshape(nrows, ncols)
        write_map_nc(name, [days] + xy, "lai", (season[:, None, None] * base).astype(np.float32))

    # meteo stacks: map i of a stack is step i (PCRaster 8.3 names), or one
    # netCDF file a forcing with a daily time axis
    start = datetime.datetime(start.year, start.month, start.day)
    daily = ("time", np.arange(n_steps, dtype=np.float64),
             {"units": f"days since {start:%Y-%m-%d}", "calendar": "proleptic_gregorian"})
    meteo_axes = axes(meteo_margin)
    if lat_ascending:
        meteo_axes[0] = (meteo_axes[0][0], meteo_axes[0][1][::-1], meteo_axes[0][2])
    for key, (prefix, lo, hi) in METEO_STACKS.items():
        maps = [field(lo, hi).reshape(nrows, ncols) for _ in range(n_steps)]
        if key == "TavgMaps" and opts.get("TemperatureInKelvin"):
            maps = [m + np.float32(273.15) for m in maps]
        if meteo_format == "netcdf":
            data = np.where(np.isnan(maps), -9999.0, maps).astype(np.float32)
            if meteo_margin:
                k = meteo_margin
                data = np.pad(data, ((0, 0), (k, k), (k, k)), mode="edge")
            if lat_ascending:
                data = data[:, ::-1]
            write_nc(os.path.join(dirs["meteo"], prefix + ".nc"), [daily] + meteo_axes, prefix,
                     np.ascontiguousarray(data))
        else:
            for step, data in enumerate(maps, 1):
                nr = str(step)
                name = f"{prefix}{'0' * (11 - len(prefix) - len(nr))}{nr}"
                csf.write_map(os.path.join(dirs["meteo"], f"{name[:8]}.{name[8:]}"), data,
                              west, north, cell)
        binding[key] = f"$(PathMeteo)/{prefix}"

    _option_inputs(binding, opts, np.random.default_rng([seed, 12]), dirs, nrows, ncols,
                   n_steps, start, land, channel, order, fractions, write, write_nc, xy, rng2,
                   binding["AvgDis"])
    if outputs:
        binding.update({k: f"$(PathOut)/{k.lower()}" for k in END_MAPS})
        binding["LZState"] = "$(PathOut)/lz"
        binding.update({k: f"$(PathOut)/{v}.tss" for k, v in OUTPUT_TSS.items()})
        binding.update({k: f"$(PathOut)/{v}" for k, v in option_reports(opts).items()})

    end = start + datetime.timedelta(days=n_steps - 1)
    binding.update({
        "CalendarDayStart": start.strftime("%d/%m/%Y %H:%M"),
        "StepStart": start.strftime("%d/%m/%Y %H:%M"),
        "StepEnd": end.strftime("%d/%m/%Y %H:%M"), "DtSec": "86400", "DtSecChannel": "3600",
        "PathOut": "$(PathOut)", **({} if geographic else {"proj4_params": LAEA_PROJ4}),
        "GwLoss": "0", "GwPercValue": "0.5", "PrScaling": "1", "CalEvaporation": "1",
        "TemperatureLapseRate": "0.0065", "SnowSeasonAdj": "1.0", "TempSnow": "1.0",
        "SnowFactor": "1.0", "SnowMeltCoef": "4.0", "TempMelt": "0.0",
        "SnowCoverAInitValue": "0", "SnowCoverBInitValue": "0", "SnowCoverCInitValue": "0",
        "Kfrost": "0.57", "Afrost": "0.97", "FrostIndexThreshold": "56",
        "SnowWaterEquivalent": "0.45", "FrostIndexInitValue": "0", "kdf": "0.72",
        "CourantCrit": "0.4", "LeafDrainageTimeConstant": "0.1", "AvWaterRateThreshold": "5",
        "MapCropCoef": "1.0", "MapForestCropCoef": "1.1", "MapIrrigationCropCoef": "1.05",
        "MapCropGroupNumber": "4", "MapForestCropGroupNumber": "4.5",
        "MapIrrigationCropGroupNumber": "3", "MapN": "0.2", "MapForestN": "0.4",
        "MapKSat1Forest": "200", "MapKSat2Forest": "60",
        "MapLambda1": "0.25", "MapLambda1Forest": "0.3", "MapLambda2": "0.2",
        "MapLambda2Forest": "0.25", "MapLambda3": "0.15",
        "MapGenuAlpha1": "0.03", "MapGenuAlpha1Forest": "0.04", "MapGenuAlpha2": "0.02",
        "MapGenuAlpha2Forest": "0.03", "MapGenuAlpha3": "0.01",
        "MapThetaSat1": "0.45", "MapThetaSat1Forest": "0.5", "MapThetaSat2": "0.42",
        "MapThetaSat2Forest": "0.45", "MapThetaSat3": "0.4",
        "MapThetaRes1": "0.05", "MapThetaRes1Forest": "0.06", "MapThetaRes2": "0.04",
        "MapThetaRes2Forest": "0.05", "MapThetaRes3": "0.03",
        **{k: "-9999" for k in ("ThetaInit1Value", "ThetaForestInit1Value",
                                "ThetaIrrigationInit1Value", "ThetaInit2Value",
                                "ThetaForestInit2Value", "ThetaIrrigationInit2Value",
                                "ThetaInit3Value", "ThetaForestInit3Value",
                                "ThetaIrrigationInit3Value")},
        "b_Xinanjiang": "0.7", "PowerPrefFlow": "3.5",
        "DSLRInitValue": "1", "DSLRForestInitValue": "1", "DSLRIrrigationInitValue": "1",
        "CumIntInitValue": "0", "CumIntForestInitValue": "0", "CumIntIrrigationInitValue": "0",
        "CumIntSealedInitValue": "0", "SMaxSealed": "1.0",
        "UpperZoneTimeConstant": "10", "LowerZoneTimeConstant": "100", "LZInitValue": "-9999",
        "LZThreshold": "0", "UZInitValue": "0", "UZForestInitValue": "0",
        "UZIrrigationInitValue": "0",
        "beta": "0.6", "ChanGradMin": "0.0001", "CalChanMan": "1.0", "ChanSdXdY": "1.0",
        "TotalCrossSectionAreaInitValue": "-9999", "PrevDischarge": "-9999",
        "CrossSection2AreaInitValue": "-9999", "PrevSideflowInitValue": "-9999",
        "CalChanMan2": "3.0", "QSplitMult": "2.0",
        "OFOtherInitValue": "0", "OFForestInitValue": "0", "OFDirectInitValue": "0",
        "GradMin": "0.001", "OFDepRef": "5",
        "LakeMultiplier": "1.0", "LakeInitialLevelValue": "-9999",
        "LakePrevInflowValue": "-9999", "LakePrevOutflowValue": "-9999",
        "adjust_Normal_Flood": "0.8", "ReservoirRnormqMult": "1.0",
        "ReservoirInitialFillValue": "-9999", "maxNoEva": "5",
    })
    user = {"PathRoot": root, "PathMaps": "$(PathRoot)/maps", "PathTables": "$(PathRoot)/tables",
            "PathMeteo": "$(PathRoot)/meteo", "PathOut": dirs["out"], **(user or {})}
    # lfuser values are not expanded: give them whole
    user = {k: str(v).replace("$(PathRoot)", root) for k, v in user.items()}
    lines = ["<?xml version=\"1.0\" encoding=\"UTF-8\"?>", "<lfsettings>", "<lfuser>"]
    lines += [f'  <textvar name="{k}" value="{v}"/>' for k, v in user.items()]
    lines += ["</lfuser>", "<lfoptions>"]
    lines += [f'  <setoption choice="{int(bool(v))}" name="{k}"/>' for k, v in opts.items()]
    lines += ["</lfoptions>", "<lfbinding>"]
    lines += [f'  <textvar name="{k}" value="{v}"/>' for k, v in binding.items()]
    lines += ["</lfbinding>", "</lfsettings>"]
    settings = os.path.join(root, "settings.xml")
    with open(settings, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return settings

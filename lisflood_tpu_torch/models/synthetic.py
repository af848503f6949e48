"""Synthetic catchment generator — a full model setup with no input files.

The port's copy of lisflood_tpu/models/synthetic.py: for the same arguments
it returns arrays equal to the JAX package's (config, params, state, aux),
so it can build the continental model on a machine without JAX. The drainage network is a random spanning forest on
an nrows x ncols grid; soil/channel parameters are drawn from realistic
ranges.
"""
from __future__ import annotations

import numpy as np

from ..graph.ldd import FlowGraph, build_schedule, direction_codes
from .config import ModelConfig

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

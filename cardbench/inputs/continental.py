"""The continental grid's inputs: a synthetic drainage forest and its maps.

A frozen copy of lisflood_tpu_torch/models/synthetic.py (commit c77b93b):
`synthetic_drainage` and `build_synthetic_model`, drawing the same numbers
from the same seed, with the graph passes of reference/graph.py in place of
the program's FlowGraph. What the program derives from these inputs (its
routing schedules, routers, tables, segment orders, the captured step) is
left to the program: `build_program` hands the drainage to its FlowGraph and
build_schedule, timed in the run's set-up.

`make_inputs` returns a dict: the ModelConfig fields (`fields`), the
parameter maps (`params`), the initial state (`state`), the drainage
(`down`, `ldd`) and its cut at the structures (`down_kin`), and the
schedule's chunk; `forcing_ring` makes the days' forcing on the device.
"""
from __future__ import annotations

import numpy as np

from ..reference.graph import accuflux, catchment_labels, direction_codes, upstream_sum


def mualem(residual, sat, alpha, n, m, pressure):
    """Soil moisture at a pressure head (van Genuchten / Mualem)."""
    return residual + (sat - residual) / ((1 + (alpha * pressure) ** n) ** m)


def synthetic_drainage(nrows, ncols, seed=0):
    """Every cell drains S, E or SE at random (the last row E, the last
    column S), so the one pit is the bottom-right corner. Returns (ldd codes,
    down)."""
    rng = np.random.default_rng(seed)
    P = nrows * ncols
    r, c = np.divmod(np.arange(P, dtype=np.int64), ncols)
    has_s = r + 1 < nrows
    has_e = c + 1 < ncols
    pick = rng.integers(0, 3, P)
    dr = np.where(has_s & has_e, (pick != 1).astype(np.int64), has_s.astype(np.int64))
    dc = np.where(has_s & has_e, (pick != 0).astype(np.int64), has_e.astype(np.int64))
    pit = ~has_s & ~has_e
    dr[pit] = 0
    dc[pit] = 0
    code_lut = np.array([[5, 6, 0], [2, 3, 0], [0, 0, 0]], dtype=np.int8)
    ldd = code_lut[dr, dc]
    down = ((r + dr) * ncols + (c + dc)).astype(np.int32)
    down[pit] = -1
    return ldd, down


def make_inputs(config, seed, workdir=None, traffic=None):
    """The model of `config` (nrows, ncols, no_rout_steps, chunk) drawn from
    `seed`: split routing, two lakes, two reservoirs and open-water
    evaporation on a grid where every cell is a channel."""
    nrows, ncols = config["nrows"], config["ncols"]
    no_rout_steps = config["no_rout_steps"]
    rng = np.random.default_rng(seed)
    P = nrows * ncols
    ldd, down = synthetic_drainage(nrows, ncols, seed)
    dt_sec, dt_day, beta = 86400.0, 1.0, 0.6
    u = lambda lo, hi, shape=P: rng.uniform(lo, hi, shape)
    params, state = {}, {}

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
    params["SoilFraction"] = np.stack([other, forest, irrig])
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

    sd1a, sd1b, sd2 = u(50, 150, (3, P)), u(100, 400, (3, P)), u(200, 800, (3, P))
    params["SoilDepth1a"], params["SoilDepth1b"], params["SoilDepth2"] = sd1a, sd1b, sd2
    params["SoilDepthTotal"] = sd1a + sd1b + sd2
    params["CourantCrit"] = 0.5
    params["LeafDrainageK"] = 1.0
    params["AvWaterThreshold"] = 5.0 * dt_day
    params["CropCoef"] = u(0.8, 1.2, (3, P))
    params["CropGroupNumber"] = u(1, 5, (3, P))
    params["NManning"] = u(0.05, 0.4, (3, P))

    wpf3 = {}
    for layer, sd in (("1a", sd1a), ("1b", sd1b), ("2", sd2)):
        lam = u(0.1, 0.4, (3, P))
        n = 1 + lam
        m = lam / n
        ths = u(0.35, 0.5, (3, P))
        thr = u(0.01, 0.08, (3, P))
        ws, wres = ths * sd, thr * sd
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
            wpf3[layer] = mualem(wres, ws, alpha, n, m, 1000.0)
    params["WS1"] = params["WS1a"] + params["WS1b"]
    params["WRes1"] = params["WRes1a"] + params["WRes1b"]
    params["WFC1"] = params["WFC1a"] + params["WFC1b"]
    params["WWP1"] = params["WWP1a"] + params["WWP1b"]
    params["WPF3a"] = wpf3["1a"]
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
    params["UpArea"] = accuflux(down, pixel_area)
    is_channel = np.ones(P, bool)
    params["IsChannel"] = is_channel
    params["IsChannelKinematic"] = is_channel
    params["AtLastPointC"] = down < 0
    catchments = catchment_labels(down)
    params["Catchments"] = catchments
    params["CatchArea"] = np.bincount(catchments, weights=pixel_area)[catchments]
    downstruct = np.where(down >= 0, down, P).astype(np.int32)
    params["downstruct"] = downstruct

    chan_grad, chan_man = u(1e-4, 0.05), u(0.02, 0.1)
    chan_bw, chan_depth, sdxdy = u(5, 100), u(1, 8), u(0.5, 3)
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

    for key in ("OFM3Other", "OFM3Forest", "OFM3Direct"):
        state[key] = np.zeros(P)
    params["OFAlpha"] = ((params["NManning"] / np.sqrt(u(1e-3, 0.1))) ** beta
                         * (params["PixelLength"] + 1.0) ** alp_pow)
    for key in ("OFQDirect", "OFQOther", "OFQForest"):
        state[key] = np.zeros(P)

    is_structure = np.zeros(P, bool)
    order = np.argsort(params["UpArea"])[::-1]
    lake_index, res_index = order[4:6], order[8:10]
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
    is_ups = np.zeros(P, bool)
    is_ups[down >= 0] = is_structure[down[down >= 0]]
    params["IsUpsOfStructureKinematicC"] = is_ups
    down_kin = np.where(is_ups, -1, down).astype(np.int32)
    ldd_kin = np.where(is_ups, 5, ldd).astype(np.int8)

    alpha2 = alpha1 * u(1.2, 2.0)
    params["ChannelAlpha2"] = alpha2
    qlimit = np.maximum(state["ChanQKin"] * 2, 0.1)
    params["QLimit"] = qlimit
    params["M3Limit"] = alpha1 * chan_length * qlimit**beta
    chan2_start = alpha2 * chan_length * qlimit**beta
    params["Chan2M3Start"] = chan2_start
    params["Chan2QStart"] = qlimit - upstream_sum(down_kin, qlimit)
    state["CrossSection2Area"] = np.zeros(P)
    state["Sideflow1Chan"] = np.zeros(P)
    state["Chan2M3Kin"] = chan2_start.copy()
    state["Chan2QKin"] = (chan2_start / chan_length / alpha2) ** (1 / beta)

    params["downEva"] = downstruct.copy()
    params["maxNoEva"] = 5
    flat_idx = np.arange(P, dtype=np.int64)
    codes2d, adjacent = direction_codes(down, flat_idx, nrows, ncols)
    if adjacent:
        params["evaDir2D"] = codes2d
        params["landIdx"] = flat_idx.astype(np.int32)
    state["TimeSinceStart"] = np.float64(0.0)

    fields = dict(split_routing=True, simulate_lakes=True, simulate_reservoirs=True,
                  open_water_evapo=True, no_rout_steps=no_rout_steps, dt_sec=dt_sec,
                  num_lakes=2, num_reservoirs=2, num_catchments=int(catchments.max()) + 1,
                  num_pixels=P, grid_rows=nrows, grid_cols=ncols)
    return {"fields": fields, "params": params, "state": state, "down": down, "ldd": ldd,
            "down_kin": down_kin, "ldd_kin": ldd_kin, "chunk": config["chunk"],
            "channel": is_channel, "down_tochan": np.full(P, -1, np.int32)}


def forcing_ring(torch, inputs, days, seed, device, dtype):
    """`days` days of meteo forcing made on the device from `seed`, in the
    ranges of the program's synthetic_forcing (precipitation 0-15 mm, mean
    temperature -5-20 C, ET0 0-5 mm, E0 0-6 mm), from calendar day 150 on,
    each entry with a leading day axis. Every seed draws the same amount."""
    P = inputs["fields"]["num_pixels"]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    draw = lambda lo, hi: torch.rand((days, P), generator=gen, device=device,
                                     dtype=torch.float64).mul_(hi - lo).add_(lo).to(dtype)
    ring = {"Precipitation": draw(0.0, 15.0), "Tavg": draw(-5.0, 20.0),
            "ETRef": draw(0.0, 5.0), "EWRef": draw(0.0, 6.0)}
    day = 150 + np.arange(days)
    ring["CalendarDay"] = torch.as_tensor(day.astype(np.float64), dtype=dtype, device=device)
    ring["LAIInterval"] = torch.as_tensor(lai_interval(day), device=device)
    return ring


# the calendar days that start LISFLOOD's 36 prescribed-LAI intervals
LAI_INTERVAL_STARTS = [1, 11, 21, 32, 42, 52, 60, 70, 80, 91, 101, 111, 121, 131,
                       141, 152, 162, 172, 182, 192, 202, 213, 223, 233, 244, 254,
                       264, 274, 284, 294, 305, 315, 325, 335, 345, 355, 370]


def lai_interval(day):
    """The LAI interval (0..35) of each calendar day."""
    index = np.searchsorted(LAI_INTERVAL_STARTS, np.asarray(day), side="right") - 1
    return index.astype(np.int64)


def build_program(torch, inputs, traffic, dtype, device):
    """The program's model from the inputs: its FlowGraph and routing
    schedules (its own derivation, timed as set-up) and its ModelConfig.
    Returns (cfg, params, state, aux) as the program's build_step takes
    them."""
    import dataclasses
    from lisflood_tpu_torch.graph.ldd import FlowGraph, build_schedule
    from lisflood_tpu_torch.models.config import ModelConfig

    P = inputs["fields"]["num_pixels"]
    graph = FlowGraph(downstream=inputs["down"], ldd=inputs["ldd"], num_pixels=P)
    graph_kin = FlowGraph(downstream=inputs["down_kin"], ldd=inputs["ldd_kin"], num_pixels=P)
    graph_tochan = FlowGraph(downstream=inputs["down_tochan"], ldd=np.full(P, 5, np.int8),
                             num_pixels=P)
    aux = {"schedule_kin": build_schedule(graph_kin, inputs["chunk"], order_graph=graph),
           "schedule_tochan": build_schedule(graph_tochan, inputs["chunk"]),
           "graph": graph, "graph_kin": graph_kin, "graph_tochan": graph_tochan}
    cfg = dataclasses.replace(ModelConfig(**inputs["fields"]),
                              routing_kernel=traffic["router"])
    return cfg, inputs["params"], inputs["state"], aux


def reference_model(inputs):
    """The plain reference's model: the inputs themselves (nothing here is
    derived by the program)."""
    f = inputs["fields"]
    cfg = {k: f[k] for k in ("no_rout_steps", "dt_sec", "num_lakes", "num_reservoirs",
                             "num_catchments")}
    cfg["open_water_evapo"] = True
    return {"cfg": cfg, "params": inputs["params"], "state": inputs["state"],
            "down_kin": inputs["down_kin"],
            "down_order": inputs["down"], "downstruct": inputs["down"],
            "down_tochan": inputs["down_tochan"]}


def reference_forcing(inputs, day, ring_forcing):
    """The reference's forcing of ring day `day`: the ring the benchmark
    made, as the program got it."""
    return ring_forcing


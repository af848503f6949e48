"""The model step — assembly of the process functions, the port of
lisflood_tpu/models/step.py.

`build_step(cfg, params, aux)` moves the parameters to the device and returns
a `Step`, a callable `step(state, forcing) -> (state, diag)` that runs the
reference's per-timestep order (Lisflood_dynamic.py:38-268):

  [transient land use] -> meteo -> LAI -> [inflow] -> open-water fraction ->
  snow -> frost -> canopy -> soil columns -> [pF] -> open/sealed -> [rice] ->
  [water abstraction] -> per-pixel aggregation -> groundwater
  [-> end of an InitLisfloodwithoutSplit step] -> [open-water evaporation,
  when its graph leaves the kernel's window or in the InitLisflood prerun] ->
  surface routing -> sub-stepped channel routing (lakes, reservoirs, the
  evaporation chain and the sideflow terms inside the routing kernel) ->
  [water level] -> [polder level] -> [water balance] -> [indicators]

The InitLisflood prerun routes a single lane with no lake, reservoir or
polder. With the packed router (RoutingKernel packed, the default) the
channel-routing state lives in schedule-packed position space across steps
('pk$' state keys) and the sub-step kernel runs the loop; with the sharded
router (RoutingKernel sharded) and the scan router (RoutingKernel scan) the
state is natural and the sequential sub-step loop runs around K6's sweep.
The step's segment sums (catchment and region totals, the evaporation chain
outside the kernel, UpstreamSumMonthDis) add in the fixed order of
SegmentOrders built with the step (segment_orders; K7 on the card).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device, to_device
from ..ops import physics as ph
from ..ops.indicators import (groundwater_smooth, indicator_keys, indicator_state_zero,
                              indicator_step)
from ..ops.kinwave import ScanRouter
from ..ops.kinwave_packed import PackedRouter, PackedSchedule
from ..ops.kinwave_sharded import ShardedRouter, build_sharded_schedule
from ..ops.routing_ops import (channel_routing_kernel, channel_routing_substeps, resolve_pipeline,
                               surface_routing_step)
from ..ops.segment_sum import SegmentOrder
from ..ops.wavefront import upstream_table, wavefront_tables
from ..parallel.partition import catchment_partition

STATE_KEYS_BASE = [
    "SnowCoverS", "FrostIndex", "CumInterception", "CumInterSealed",
    "W1a", "W1b", "W2", "DSLR", "UZ", "LZ",
    "TotalPrecipitation", "TaCUM", "TaInterceptionCUM", "ESActCUM",
    "GwLossCUM", "LZInflowCUM",
    "ChanQKin", "ChanM3Kin", "ChanQ", "CumQ", "avgdis",
    "DischargeM3Out", "TotalQInM3", "sumDis", "sumInWB",
    "OFM3Other", "OFM3Forest", "OFM3Direct",
    "OFQDirect", "OFQOther", "OFQForest",
    "EvaCumM3", "PaddyRiceWaterAbstractionFromSurfaceWaterM3",
    "TimeSinceStart",
]

# the fractions a transient land-use step reads from its forcing (<key>_t,
# and <key>_nt, the next step's, for the mass balance)
LANDUSE_FRACTIONS = ("ForestFraction", "DirectRunoffFraction", "WaterFraction",
                     "IrrigationFraction", "RiceFraction", "OtherFraction")


def uses_packed_state(cfg):
    """Whether the channel-routing state lives in schedule-packed position
    space across steps (pk$-prefixed state keys)."""
    return cfg.routing_kernel == "packed"


def packed_routing_keys(cfg):
    """State entries held packed (pk$-prefixed) when uses_packed_state."""
    keys = ["ChanQKin", "ChanM3Kin", "ChanQ", "CumQ", "avgdis",
            "DischargeM3Out", "sumDis"]
    if cfg.split:
        keys += ["Chan2QKin", "Chan2M3Kin", "CrossSection2Area", "Sideflow1Chan"]
    if cfg.trans_loss:
        keys += ["TransCum"]
    if cfg.open_water_evapo:
        keys += ["EvaCumM3"]
    return keys


def state_keys(cfg):
    keys = list(STATE_KEYS_BASE)
    if cfg.split:
        keys += ["Chan2QKin", "Chan2M3Kin", "CrossSection2Area", "Sideflow1Chan"]
    if cfg.lakes:
        keys += ["LakeStorageM3CC", "LakeInflowOldCC", "LakeOutflowCC",
                 "LakeStorageM3BalanceCC", "LakeLevelCC", "LakeStorageM3", "EWLakeCUMM3"]
    if cfg.reservoirs:
        keys += ["ReservoirStorageM3CC", "ReservoirFillCC", "ReservoirStorageM3"]
    if cfg.water_use:
        keys += ["ActualAccumulatedReUsedWaterM3", "IrriLossCUM", "wateruseCum",
                 "cumulated_CH_withdrawal"]
    if cfg.trans_loss:
        keys += ["TransCum"]
    if cfg.inflow:
        keys += ["QInM3Old"]
    if cfg.polders:
        keys += ["PolderStorageM3"]
    if cfg.rep_mbts:
        keys += ["WaterInit", "DischargeM3StructuresIni", "StorageStepINIT"]
    if cfg.indicator and cfg.water_use:
        keys += list(indicator_keys(cfg))
    if uses_packed_state(cfg):
        pk = set(packed_routing_keys(cfg))
        keys = ["pk$" + k if k in pk else k for k in keys]
    return keys


def sharded_schedules(cfg, aux):
    """The sharded schedules of RoutingKernel sharded: the channel graph
    `aux["graph_kin"]` partitioned into `cfg.num_shards` shards, and the
    schedules of it and of the overland graph `aux["graph_tochan"]` (which
    shares the pixel space) on that partition. Returns a dict with the
    schedules under "kin" and "tochan", `shard_of`, `partition_stats` and
    the host seconds of the parts in `seconds`."""
    t0 = time.perf_counter()
    shard_of, stats = catchment_partition(aux["graph_kin"], cfg.num_shards)
    out = {"shard_of": shard_of, "partition_stats": stats,
           "seconds": {"partition": time.perf_counter() - t0}}
    for key, graph in (("kin", "graph_kin"), ("tochan", "graph_tochan")):
        t0 = time.perf_counter()
        out[key] = build_sharded_schedule(aux[graph], shard_of)
        out["seconds"][f"schedule_{key}"] = time.perf_counter() - t0
    return out


def build_routers(cfg, aux, device):
    """Kinematic-wave routers for the channel and the overland (to-channel)
    graphs, as `cfg.routing_kernel` selects: 'packed' reads the schedules
    (`aux["schedule_kin"]`, `["schedule_tochan"]`, the port's or the JAX
    package's, by their `chunks`, `downstream` and `num_pixels` fields);
    'sharded' builds both routers on the schedules of `sharded_schedules`,
    or on `aux["sharded"]` where it holds them (a folded ensemble's, the
    single model's replicated, models/ensemble.py), and also returns
    `shard_of` and `partition_stats`, as the JAX package does, and the host
    seconds of its parts in `seconds` (partition, then each graph's
    schedule and router, the router's with K6's tile tables where it
    sweeps); 'scan' builds ScanRouters of both schedules, which route in
    natural order with K6 on each graph's own tables (built here, their host
    seconds, with the router's, in `seconds`)."""
    if cfg.routing_kernel == "sharded":
        sched = aux["sharded"] if "sharded" in aux else sharded_schedules(cfg, aux)
        out = {"shard_of": sched["shard_of"], "partition_stats": sched["partition_stats"],
               "seconds": dict(sched["seconds"])}
        for key in ("kin", "tochan"):
            t0 = time.perf_counter()
            out[key] = ShardedRouter(sched[key], device=device)
            if not out[key].no_edges:
                out[key].sweep_tiles()
            out["seconds"][f"router_{key}"] = time.perf_counter() - t0
        return out
    if cfg.routing_kernel == "scan":
        out = {"seconds": {}}
        for key in ("kin", "tochan"):
            t0 = time.perf_counter()
            out[key] = ScanRouter(aux["schedule_" + key], device)
            if not out[key].no_edges:
                out[key].sweep_tiles()
            out["seconds"]["router_" + key] = time.perf_counter() - t0
        return out
    if cfg.routing_kernel != "packed":
        raise ValueError(f"unknown routing_kernel {cfg.routing_kernel!r}")
    routers = {"kin": PackedRouter(aux["schedule_kin"], device),
               "tochan": PackedRouter(aux["schedule_tochan"], device)}
    if not routers["tochan"].no_edges:
        # the overland router sweeps: its tile tables are built with the step,
        # so that its first step does not pay for them
        routers["tochan"].sweep_tiles()
    return routers


# the padding fill of each per-position row of packed_routing_params: a
# padded lane stays inert (parallel/shard_model.py fills the lanes of a rank's
# chunks that it neither owns nor reads with them too)
PACKED_FILLS = {"ChanLength": 1.0, "ChannelAlpha": 1.0, "IsChannelKinematic": False,
                "AtLastPointC": False, "ChannelAlpha2": 1.0, "QLimit": 0.0,
                "M3Limit": np.inf,      # padded lanes never count as over-limit
                "Chan2M3Start": 0.0, "Chan2QStart": 0.0, "UpTrans": False,
                "TransPower1": 1.0, "TransPower2": 1.0, "TransSub": 0.0}


def packed_routing_params(cfg, params_np, ps):
    """Host-side schedule-order reorder of the per-pixel params the sub-step
    loop touches (p['kinp$...']), with padding fills that keep padded lanes
    inert. For a PackedSchedule also the sub-step kernel's tables; for the
    sequential loop's position spaces (a ShardedSchedule, the scan router's
    identity NaturalSchedule) only what that loop reads (with the mass
    balance the catchment of every position, padding in the extra segment
    num_catchments).

    Returns (params, feeders_earlier, eva_window_ok): whether every structure
    cell lies in a strictly later chunk than all of its feeders, and whether
    the evaporation graph's edges fit the schedule window — the two
    conditions the kernel's structure and evaporation chains rely on (True
    and False for the sequential loop, which reads the previous sub-step's
    discharge and runs the chain outside)."""
    out = {}
    feeders_earlier = True
    sequential = not isinstance(ps, PackedSchedule)
    chunk_of = lambda pos: pos // ps.chunk

    def pk(name):
        fill = PACKED_FILLS[name]
        kind = bool if isinstance(fill, bool) else np.float64
        out["kinp$" + name] = ps.pack_np(np.asarray(params_np[name], kind), fill)

    pk("ChanLength")
    pk("ChannelAlpha")
    pk("IsChannelKinematic")
    if not sequential:
        pk("AtLastPointC")
    if cfg.split:
        for name in ("ChannelAlpha2", "QLimit", "M3Limit", "Chan2M3Start", "Chan2QStart"):
            pk(name)
    if cfg.trans_loss:
        for name in ("UpTrans", "TransPower1", "TransPower2", "TransSub"):
            pk(name)

    if sequential and cfg.rep_mbts:
        out["kinp$Catchments"] = ps.pack_np(np.asarray(params_np["Catchments"], np.int64),
                                            cfg.num_catchments)

    P = ps.num_pixels
    p_pad = ps.p_pad
    real = ps.perm < P
    pos = np.flatnonzero(real)
    pix = ps.perm[real]
    if not sequential:
        # the kernel's hand-over of discharge, by the (structure-cut) routing graph
        has_down = ps.down_pos < p_pad
        out["kinp$UpsTable"] = upstream_table(np.flatnonzero(has_down), ps.down_pos[has_down],
                                              p_pad)

    # structure inflow comes from the ORIGINAL (pre-cut) downstruct: the
    # pixel upstream of a lake is a routing pit but still feeds the lake
    # (structures.py:43-61, lakes.py:215)
    downstruct = np.asarray(params_np["downstruct"], np.int64)   # (P,), P = pit

    def ups_gather(struct_pix):
        """(n, 8) packed positions of each structure cell's upstream pixels
        (0-padded) with 0/1 weights, and the same positions -1-padded."""
        nonlocal feeders_earlier
        n = len(struct_pix)
        idx = np.zeros((n, 8), np.int32)
        w = np.zeros((n, 8), np.float64)
        for i, px in enumerate(np.asarray(struct_pix, np.int64)):
            ups = np.flatnonzero(downstruct == px)
            if ups.size > 8:
                raise ValueError(f"structure cell {px} has {ups.size} upstream pixels")
            upos = ps.inv_perm[ups]
            if not sequential and not (chunk_of(upos) < chunk_of(ps.inv_perm[px])).all():
                feeders_earlier = False
            idx[i, :upos.size] = upos
            w[i, :upos.size] = 1.0
        return idx, w, np.where(w > 0, idx, -1).astype(np.int32)

    struct_pos = []
    if cfg.lakes:
        lake_pos = ps.inv_perm[np.asarray(params_np["LakeIndex"], np.int64)]
        out["kinp$LakePos"] = lake_pos.astype(np.int32)
        out["kinp$LakeUpsIdx"], out["kinp$LakeUpsW"], out["kinp$LakeFee"] = \
            ups_gather(params_np["LakeIndex"])
        struct_pos += list(lake_pos)
    if cfg.reservoirs:
        res_pos = ps.inv_perm[np.asarray(params_np["ReservoirIndex"], np.int64)]
        out["kinp$ResPos"] = res_pos.astype(np.int32)
        out["kinp$ResUpsIdx"], out["kinp$ResUpsW"], out["kinp$ResFee"] = \
            ups_gather(params_np["ReservoirIndex"])
        struct_pos += list(res_pos)
    if len(set(struct_pos)) != len(struct_pos):
        raise ValueError("two lakes/reservoirs share a pixel")

    # the open-water evaporation chain inside the kernel (never in the
    # InitLisflood prerun): its transfers follow downEva, whose edges must
    # land 1..W chunks later
    eva_window_ok = False
    if sequential:
        return out, feeders_earlier, eva_window_ok
    if cfg.open_water_evapo and not cfg.init_lisflood and "downEva" in params_np:
        down_eva = np.asarray(params_np["downEva"], np.int64)     # (P,), P = pit
        tgt = down_eva[pix]
        has_t = tgt < P
        tgt_pos = ps.inv_perm[tgt[has_t]]
        delta = tgt_pos // ps.chunk - pos[has_t] // ps.chunk
        if not has_t.any() or (1 <= delta.min() and delta.max() <= ps.window):
            out["kinp$EvaUpsTable"] = upstream_table(pos[has_t], tgt_pos, p_pad)
            eva_window_ok = True
    # the kernel's per-chunk dependency tables (the step refuses a schedule
    # whose feeders are not earlier, so none are built for one)
    if feeders_earlier:
        tables = wavefront_tables(
            ps.n_chunks, ps.chunk, ps.window, out["kinp$UpsTable"], out.get("kinp$EvaUpsTable"),
            out.get("kinp$LakePos"), out.get("kinp$LakeFee"),
            out.get("kinp$ResPos"), out.get("kinp$ResFee"))
        out.update({"kinp$" + k: v for k, v in tables.items()})
    return out, feeders_earlier, eva_window_ok


def device_params(cfg, params_np, routers, device, dtype):
    """Parameters on the device: float arrays in `dtype`, bool arrays as bool,
    integer arrays as int64 (index type) except the routing kernel's int32
    tables ('kinp$' entries keep their integer type); scalars stay Python
    numbers. Also records on the channel router the two schedule conditions
    of packed_routing_params."""
    p = {}
    for k, v in params_np.items():
        if isinstance(v, (int, float, np.floating, np.integer)):
            p[k] = int(v) if isinstance(v, (int, np.integer)) else float(v)
        else:
            p.update(to_device({k: v}, device, dtype))
    kin = routers["kin"]
    kinp, kin.struct_feeders_earlier, kin.eva_window_ok = packed_routing_params(
        cfg, params_np, kin.ps)
    for k, v in kinp.items():
        if v.dtype.kind in "iu":
            p[k] = torch.as_tensor(v, device=device)
        else:
            p.update(to_device({k: v}, device, dtype))
    return p


def prepare_state(cfg, routers, state):
    """The step's state contract from a natural-space state on the device:
    routing entries move to pk$-prefixed schedule-packed tensors."""
    if not uses_packed_state(cfg) or "pk$ChanQKin" in state:
        return dict(state)
    kin = routers["kin"]
    pkeys = set(packed_routing_keys(cfg))
    return {("pk$" + k if k in pkeys else k): (kin.pack(v) if k in pkeys else v)
            for k, v in state.items()}


def natural_state(cfg, routers, state):
    """Inverse of prepare_state: pk$ entries back to natural-space names."""
    kin = routers["kin"]
    return {(k[3:] if k.startswith("pk$") else k): (kin.unpack(v) if k.startswith("pk$") else v)
            for k, v in state.items()}


def check_options(cfg):
    """Refuses what the reference cannot run: the InitLisflood prerun
    simulates no lake or reservoir, whose storage the water-balance reports
    (with either structure) and the indicators (with both) read; the JAX
    step fails there with a KeyError."""
    structures = cfg.simulate_lakes or cfg.simulate_reservoirs
    if cfg.init_lisflood and (
            (cfg.rep_total_water_storage or cfg.rep_mbts) and structures
            or cfg.indicator and cfg.water_use and cfg.simulate_lakes and cfg.simulate_reservoirs):
        raise ValueError("InitLisflood simulates no lake or reservoir: switch off the water-"
                         "balance reports and the indicators, or the structures, for the prerun")


class Step:
    """One model step on the device: `step(state, forcing) -> (state, diag)`.

    `state` is the prepared (packed) state of `prepare_state`, `forcing` a
    dict of tensors; `land_phase` runs the step up to the channel routing
    and returns the diagnostics the routing consumes."""

    def __init__(self, cfg, params, routers, device, gw_grid=None):
        check_options(cfg)
        self.cfg = cfg
        self.params = params
        self.routers = routers
        self.device = torch.device(device)
        # a rank of the multi-process step smooths LZ on the whole grid
        # (parallel/shard_model.GridPixels)
        self.gw_grid = gw_grid
        self.pipeline = resolve_pipeline(cfg, routers, self.device)
        # the evaporation chain runs inside the routing kernel when its graph
        # fits the schedule window, else before the routing (evapowater_step),
        # as always in the InitLisflood prerun
        self.eva_in_kernel = (cfg.open_water_evapo and not cfg.init_lisflood
                              and routers["kin"].eva_window_ok)

    def prepare_state(self, state, dtype=None):
        """NumPy state -> the step's packed state on the device."""
        dtype = dtype or self.params["ChanLength"].dtype
        return prepare_state(self.cfg, self.routers, to_device(state, self.device, dtype))

    def natural_state(self, state):
        return natural_state(self.cfg, self.routers, state)

    def _natural(self, s, key):
        """State entry `key` in natural space, from its pk$ form where the
        state is packed."""
        return self.routers["kin"].unpack(s["pk$" + key]) if "pk$" + key in s else s[key]

    def smooth_lz(self, p, lz):
        """groundwater_smooth of LZ; on a rank (gw_grid), the whole grid's
        smoothing of the gathered LZ, in the one-process order, of which the
        rank keeps its own pixels."""
        cfg, g = self.cfg, self.gw_grid
        if g is None:
            return groundwater_smooth(cfg, p, lz, p["LandRows"], p["LandCols"],
                                      cfg.grid_rows, cfg.grid_cols)
        return g.space.own_of(groundwater_smooth(cfg, g.params, g.space.gather(lz), g.rows,
                                                 g.cols, cfg.grid_rows, cfg.grid_cols))

    def step_params(self, f):
        """The parameters of the step with forcing `f`: with transient land
        use a copy whose six fractions are the forcing's `<key>_t` and whose
        SoilFraction and PermeableFraction follow from them
        (landusechange.py:94-148); the step's own parameters stay as they
        are."""
        if not self.cfg.transient_landuse:
            return self.params
        p = dict(self.params)
        for k in LANDUSE_FRACTIONS:
            p[k] = f[k + "_t"]
        p["SoilFraction"] = torch.stack([p["OtherFraction"] + p["RiceFraction"],
                                         p["ForestFraction"], p["IrrigationFraction"]])
        p["PermeableFraction"] = 1 - p["DirectRunoffFraction"] - p["WaterFraction"]
        return p

    def land_phase(self, s, f, p=None):
        """The step up to the channel routing (to the groundwater with
        InitLisfloodwithoutSplit); `p` is step_params(f)."""
        cfg, routers = self.cfg, self.routers
        p = self.step_params(f) if p is None else p
        d = dict(f)  # diagnostics namespace, seeded with forcing
        d["TimeSinceStart"] = s["TimeSinceStart"] + 1.0

        # meteo scaling (readmeteo.py:44-81)
        d["Precipitation"] = f["Precipitation"] * cfg.dt_day * p["PrScaling"]
        tavg = f["Tavg"]
        if cfg.temperature_in_kelvin:
            tavg = tavg - 273.15
        d["Tavg"] = tavg
        d["ETRef"] = f["ETRef"] * cfg.dt_day * p["CalEvaporation"]
        d["EWRef"] = f["EWRef"] * cfg.dt_day * p["CalEvaporation"]
        d["ESRef"] = (d["EWRef"] + d["ETRef"]) / 2

        # LAI selection (leafarea.py:76-90); a tensor index goes through
        # index_select, which reads nothing back on the host (indexing with a
        # 0-d device tensor does)
        lai_i = f["LAIInterval"]
        d["LAI"] = (p["LAIX"].index_select(0, lai_i.reshape(1)).squeeze(0)
                    if torch.is_tensor(lai_i) else p["LAIX"][lai_i])

        # inflow hydrographs (inflow.py:98-127)
        if cfg.inflow:
            d["QInM3OldLoop"] = s["QInM3Old"]   # last step's inflow, ramped from in the sub-steps
            d["QInM3Old"] = f["QInM3"]          # becomes old for the next step
            d["QDelta"] = (f["QInM3"] - s["QInM3Old"]) / cfg.no_rout_steps
            d["TotalQInM3"] = s["TotalQInM3"] + f["QInM3"]

        d.update(ph.evapowater_init_step(cfg, p, s, d))
        d.update(ph.snow_step(cfg, p, s, d))
        d.update(ph.frost_step(cfg, p, s, d))
        d.update(ph.canopy_step(cfg, p, s, d))
        soil_in = dict(s)
        soil_in["W1a"], soil_in["W1b"] = d["W1a"], d["W1b"]
        d.update(ph.soil_columns_step(cfg, p, soil_in, d))
        if cfg.simulate_pf:
            d.update(ph.pf_step(cfg, p, d))
        d.update(ph.opensealed_step(cfg, p, s, d))
        if cfg.rice_irrigation:
            d.update(ph.rice_irrigation_step(cfg, p, s, d))
        else:
            d["PaddyRiceWaterAbstractionFromSurfaceWaterM3"] = torch.zeros_like(d["Rain"])
        if cfg.water_use:
            # natural-space views of the packed channel state
            wa_state = dict(s)
            wa_state["ChanM3Kin"] = d["ChanM3Kin"] = self._natural(s, "ChanM3Kin")
            d["ChanQ"] = self._natural(s, "ChanQ")
            d.update(ph.water_abstraction_step(cfg, p, wa_state, d))
            if cfg.groundwater_smooth:
                d["LZ"] = self.smooth_lz(p, d["LZ"])
        d.update(ph.soil_perpixel_step(cfg, p, s, d))
        d.update(ph.groundwater_step(cfg, p, s, d))
        if cfg.init_lisflood_without_split:
            return d

        if cfg.open_water_evapo:
            if self.eva_in_kernel:
                # the kernel takes the own-pixel potential evaporation and
                # returns the chain's result
                d["EvaUpstream0"] = d["EWRef"] * p["MMtoM3"] * d["WaterFraction"]
            else:
                eva_d = dict(d)
                eva_d["ChanM3Kin"] = self._natural(s, "ChanM3Kin")
                s_eva = dict(s)
                s_eva["EvaCumM3"] = self._natural(s, "EvaCumM3")
                out_eva = ph.evapowater_step(cfg, p, s_eva, eva_d)
                if "pk$EvaCumM3" in s:
                    out_eva["pk$EvaCumM3"] = (s["pk$EvaCumM3"]
                                              + routers["kin"].pack_rows([out_eva["EvaAddM3"]])[0])
                d.update(out_eva)

        d.update(surface_routing_step(cfg, p, s, d, routers))
        return d

    def __call__(self, s, f):
        cfg = self.cfg
        p = self.step_params(f)
        d = self.land_phase(s, f, p)
        if cfg.init_lisflood_without_split:
            return _collect_state(cfg, s, d), d
        # the routing starts from the lake and reservoir storages that the
        # water abstraction left
        route_state = dict(s)
        for k in ("LakeStorageM3CC", "ReservoirStorageM3CC", "LakeStorageM3", "ReservoirStorageM3"):
            if k in d:
                route_state[k] = d[k]
        routing = (channel_routing_substeps if self.pipeline == "substeps"
                   else channel_routing_kernel)
        d.update(routing(cfg, p, route_state, d, self.routers))

        if cfg.simulate_water_levels:
            d.update(ph.waterlevel_step(cfg, p, s, d))
        # polder level diagnostic: the reference's dynamic polder parts are a
        # no-op skeleton (polder.py:72-177), so the storage passes through
        if cfg.polders:
            d["PolderLevel"] = torch.where(
                p["IsPolder"], s["PolderStorageM3"] / torch.clamp_min(p["PolderArea"], 1e-30), 0.0)
        if cfg.rep_total_water_storage or cfg.rep_mbts:
            d.update(_waterbalance(cfg, p, s, d))
        # water-security indicators (indicatorcalc.py:80-235)
        if cfg.indicator and cfg.water_use:
            month_dis = s["MonthDisM3"] + d["ChanQAvg"] * cfg.dt_sec
            d["UpstreamSumMonthDis"] = ph.scatter_to_downstream(month_dis,
                                                                p["seg$downstruct"])
            d.update(indicator_step(cfg, p, s, d))
            # month-end reset of the accumulators (Lisflood_dynamic.py:266-268)
            zeros = indicator_state_zero(cfg, cfg.num_pixels, d["Rain"].dtype, d["Rain"].device)
            for k in indicator_keys(cfg):
                d[k] = torch.where(f["MonthEnd"], zeros[k], d[k])
        return _collect_state(cfg, s, d), d


def segment_orders(cfg, params_np, device, position_catchments=None, eva_outside=True):
    """The SegmentOrders of the step's segment sums (ops/segment_sum.py) on
    `device`, built on the host from the constant segment arrays, by the
    parameter keys the step reads them under, 'seg$<name>': Catchments (the
    mass balance's catchment totals), kinp$Catchments (the sequential loop's
    in-loop totals in position space, from `position_catchments`, its padding
    in the extra segment num_catchments), WUseRegionC (water use and the
    indicators), downEva (the evaporation chain outside the kernel,
    `eva_outside`, where no stencil moves it) and downstruct (the
    indicators' UpstreamSumMonthDis). No segment array changes from step to
    step: step_params replaces only land-use fractions."""
    P = cfg.num_pixels
    build = lambda seg, n, count=None: SegmentOrder.build(seg, n, count, device)
    out = {}
    if cfg.rep_mbts:
        out["seg$Catchments"] = build(params_np["Catchments"], cfg.num_catchments)
    if position_catchments is not None:
        out["seg$kinp$Catchments"] = build(position_catchments, cfg.num_catchments + 1)
    if cfg.water_use:
        out["seg$WUseRegionC"] = build(params_np["WUseRegionC"], cfg.num_wregions)
    if (cfg.open_water_evapo and eva_outside and "downEva" in params_np
            and not ph.eva_uses_stencil(cfg, params_np, device)):
        out["seg$downEva"] = build(params_np["downEva"], P + 1, P)
    if cfg.indicator and cfg.water_use:
        out["seg$downstruct"] = build(params_np["downstruct"], P + 1, P)
    return out


def build_step(cfg, params_np, aux, dtype=torch.float64, device=None):
    """Returns (step, device_params). `aux` holds the channel and overland
    schedules ('schedule_kin', 'schedule_tochan'). The step's segment orders
    (segment_orders) join the parameters; `step.order_seconds` is the host
    time of building them."""
    device = resolve_device(device)
    routers = build_routers(cfg, aux, device)
    p = device_params(cfg, params_np, routers, device, dtype)
    step = Step(cfg, p, routers, device)
    t0 = time.perf_counter()
    kin_catch = p.get("kinp$Catchments")
    p.update(segment_orders(cfg, params_np, device,
                            None if kin_catch is None else kin_catch.cpu().numpy(),
                            not step.eva_in_kernel))
    step.order_seconds = time.perf_counter() - t0
    return step, p


def build_multi_step(cfg, params_np, aux, output_keys=(), dtype=torch.float64, device=None):
    """Multi-step runner: `multi(state, forcing_stack) -> (state, outputs)`,
    where every forcing entry carries a leading time axis and `outputs`
    holds only `output_keys`, stacked over time (the JAX package's
    lax.scan). On the card each step is a replay of the step captured as a
    CUDA graph (models/graph.GraphedStep, `multi.stepper`), its forcing
    copied from the stack on the device and its outputs into the stacks; on
    the CPU the eager step. `multi.step` is the eager step either way."""
    from .graph import stepper

    step, p = build_step(cfg, params_np, aux, dtype, device)
    output_keys = tuple(output_keys)
    runner = stepper(step)

    def multi(state, forcing_stack):
        n = len(next(iter(forcing_stack.values())))
        outs = {}
        for t in range(n):
            state, d = runner.run(state, {k: v[t] for k, v in forcing_stack.items()})
            for k in output_keys:
                if k not in outs:
                    outs[k] = d[k].new_empty((n,) + tuple(d[k].shape))
                outs[k][t].copy_(d[k])
        return runner.keep(state), outs

    multi.step = step
    multi.stepper = runner
    multi.params = p
    multi.routers = step.routers
    multi.prepare_state = step.prepare_state
    multi.natural_state = step.natural_state
    return multi, p


def _collect_state(cfg, s, d):
    new_state = {k: d.get(k, s[k]) for k in state_keys(cfg)}
    new_state["TimeSinceStart"] = d["TimeSinceStart"]
    return new_state


def _storage_channel(cfg, p, s, d):
    """waterbalance.py:114-122; no polder storage in the InitLisflood prerun
    (check_options refuses it with lakes or reservoirs)."""
    stored = d["ChanM3"]
    if cfg.lakes:
        stored = stored + d["LakeStorageM3Balance"]
    if cfg.reservoirs:
        stored = stored + d["ReservoirStorageM3"]
    if cfg.polders:
        stored = stored + d.get("PolderStorageM3", s["PolderStorageM3"])
    return stored


def _storage_hillslope(cfg, p, s, d):
    """waterbalance.py:124-128."""
    hill1 = d["LZ"] + (p["SoilFraction"] * (d["CumInterception"] + d["W1a"] + d["W1b"]
                                            + d["W2"] + d["UZ"])).sum(0)
    hillslope_mm = (d["WaterDepth"] + d["SnowCover"] + hill1
                    + d["DirectRunoffFraction"] * d["CumInterSealed"])
    return hillslope_mm * p["MMtoM3"]


def _waterbalance(cfg, p, s, d):
    """Total water storage and the catchment mass balance
    (waterbalance.py:114-288); the prerun (InitLisflood) has no balance."""
    catchtotal = lambda x: ph.segment_spread(x, p["seg$Catchments"])
    out = {}
    channel_stored = _storage_channel(cfg, p, s, d)
    hillslope_stored = _storage_hillslope(cfg, p, s, d)
    if cfg.rep_total_water_storage:
        out["TotalWaterStorageMM"] = (channel_stored + hillslope_stored) * p["M3toMM"]
    if cfg.rep_mbts and not cfg.init_lisflood:
        # one catchment total per balance term: the per-pixel parts are
        # summed first (a total is ~1 M atomic adds on the card)
        sum_in = torch.where(torch.isnan(s["sumInWB"]), 0.0, s["sumInWB"])
        water_in = catchtotal(sum_in + d["TotalPrecipitationWB"] * p["MMtoM3"])
        channel_total = catchtotal(channel_stored)
        hillslope_total = catchtotal(hillslope_stored)
        water_stored = channel_total + hillslope_total
        sum1 = torch.where(p["AtLastPointC"], d["ChanQAvg"], 0.0)
        # the reference never updates EWLakeWBM3: lakes add nothing here
        pixel_out = sum1 * cfg.dt_sec + (d["TaWB"] + d["TaInterceptionWB"] + d["ESActWB"]
                                         + d["GwLossWB"]) * p["MMtoM3"]
        if cfg.open_water_evapo:
            pixel_out = pixel_out + d["EvaWBM3"]
        if cfg.trans_loss:
            pixel_out = pixel_out + d["TransCum"]
        if cfg.water_use:
            pixel_out = pixel_out + d["IrriLossCUM"] + d["wateruseCum"]
        water_out = catchtotal(pixel_out)
        dis_stru = torch.where(p["IsUpsOfStructureKinematicC"], d["ChanQ"] * cfg.dt_routing, 0.0)
        if cfg.simulate_lakes:
            dis_stru = dis_stru + ph.place(torch.zeros_like(dis_stru), p["LakeIndex"],
                                           0.5 * d["LakeInflowCC"] * cfg.dt_routing)
        dis_structures = catchtotal(dis_stru)
        dis_structures = dis_structures - s["DischargeM3StructuresIni"]
        mb_error = s["WaterInit"] + water_in - water_stored - water_out - dis_structures
        out["MB_WaterInit"] = s["WaterInit"]
        out["MB_WaterIn"] = water_in
        out["MB_WaterStored"] = water_stored
        out["MB_WaterOut"] = water_out
        out["MB_DisStructures"] = dis_structures
        out["MB_ChannelStored"] = channel_total
        out["MB_HillslopeStored"] = hillslope_total
        out["MBError"] = mb_error
        out["MBErrorMM"] = 1000.0 * mb_error / p["CatchArea"]
        if cfg.transient_landuse:
            # the next step starts from the next step's fractions: WaterInit
            # is the hillslope storage priced with them
            # (waterbalance.py:186-271)
            p_next = dict(p)
            p_next["SoilFraction"] = torch.stack([
                d["OtherFraction_nt"] + d["RiceFraction_nt"],
                d["ForestFraction_nt"], d["IrrigationFraction_nt"]])
            d_next = dict(d)
            d_next["DirectRunoffFraction"] = d["DirectRunoffFraction_nt"]
            hillslope_next = catchtotal(_storage_hillslope(cfg, p_next, s, d_next))
            out["WaterInit"] = channel_total + hillslope_next + dis_structures
            # the reference evaluates the analysis diagnostics after moving
            # the fractions on to the next step's (waterbalance.py:186-199)
            fr = {k: d[k + "_nt"] for k in LANDUSE_FRACTIONS}
        else:
            out["WaterInit"] = water_stored + dis_structures
            fr = p
        # mass-balance analysis diagnostics (waterbalance.py:276-289)
        sum_fracs = (fr["ForestFraction"] + fr["DirectRunoffFraction"] + fr["WaterFraction"]
                     + fr["IrrigationFraction"] + fr["OtherFraction"])
        npix = catchtotal(torch.ones_like(sum_fracs))
        out["AverageFractions"] = catchtotal(sum_fracs) / npix
        out["MBErrorStorage"] = mb_error / out["WaterInit"]
    return out

"""The model step — assembly of the process functions, the port of
lisflood_tpu/models/step.py.

`build_step(cfg, params, aux)` moves the parameters to the device and returns
a `Step`, a callable `step(state, forcing) -> (state, diag)` that runs the
reference's per-timestep order (Lisflood_dynamic.py:38-268):

  meteo -> LAI -> [inflow] -> open-water fraction -> snow -> frost -> canopy
  -> soil columns -> [pF] -> open/sealed -> [rice] -> [water abstraction] ->
  per-pixel aggregation -> groundwater -> [open-water evaporation, when its
  graph leaves the kernel's window] -> surface routing -> sub-stepped
  channel routing (lakes, reservoirs, the evaporation chain and the sideflow
  terms inside the routing kernel) -> [water level] -> [polder level] ->
  [water balance]

The channel-routing state lives in schedule-packed position space across
steps ('pk$' state keys). Options the port does not run (_NOT_PORTED) raise
NotImplementedError when the step is built.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, to_device
from ..ops import physics as ph
from ..ops.indicators import groundwater_smooth
from ..ops.kinwave_packed import PackedRouter
from ..ops.kinwave_substep import wavefront_tables
from ..ops.routing_ops import channel_routing_kernel, resolve_pipeline, surface_routing_step

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

# options the port does not run yet, by ModelConfig field
_NOT_PORTED = {
    "init_lisflood": "InitLisflood",
    "init_lisflood_without_split": "InitLisfloodwithoutSplit",
    "indicator": "indicators",
    "transient_landuse": "transient land use",
}


def uses_packed_state(cfg):
    """Whether the channel-routing state lives in schedule-packed position
    space across steps (pk$-prefixed state keys)."""
    return cfg.routing_kernel == "packed"


def packed_routing_keys(cfg):
    """State entries held packed (pk$-prefixed) when uses_packed_state."""
    keys = ["ChanQKin", "ChanM3Kin", "ChanQ", "CumQ", "avgdis",
            "DischargeM3Out", "sumDis"]
    if cfg.split_routing:
        keys += ["Chan2QKin", "Chan2M3Kin", "CrossSection2Area", "Sideflow1Chan"]
    if cfg.trans_loss:
        keys += ["TransCum"]
    if cfg.open_water_evapo:
        keys += ["EvaCumM3"]
    return keys


def state_keys(cfg):
    keys = list(STATE_KEYS_BASE)
    if cfg.split_routing:
        keys += ["Chan2QKin", "Chan2M3Kin", "CrossSection2Area", "Sideflow1Chan"]
    if cfg.simulate_lakes:
        keys += ["LakeStorageM3CC", "LakeInflowOldCC", "LakeOutflowCC",
                 "LakeStorageM3BalanceCC", "LakeLevelCC", "LakeStorageM3", "EWLakeCUMM3"]
    if cfg.simulate_reservoirs:
        keys += ["ReservoirStorageM3CC", "ReservoirFillCC", "ReservoirStorageM3"]
    if cfg.water_use:
        keys += ["ActualAccumulatedReUsedWaterM3", "IrriLossCUM", "wateruseCum",
                 "cumulated_CH_withdrawal"]
    if cfg.trans_loss:
        keys += ["TransCum"]
    if cfg.inflow:
        keys += ["QInM3Old"]
    if cfg.simulate_polders:
        keys += ["PolderStorageM3"]
    if cfg.rep_mbts:
        keys += ["WaterInit", "DischargeM3StructuresIni", "StorageStepINIT"]
    if uses_packed_state(cfg):
        pk = set(packed_routing_keys(cfg))
        keys = ["pk$" + k if k in pk else k for k in keys]
    return keys


def build_routers(cfg, aux, device):
    """Kinematic-wave routers for the channel and the overland (to-channel)
    schedules. The schedules may be the port's or the JAX package's: they
    are read by their `chunks`, `downstream` and `num_pixels` fields."""
    if cfg.routing_kernel != "packed":
        raise NotImplementedError(
            f"routing_kernel={cfg.routing_kernel!r}: the port has the packed router only")
    return {"kin": PackedRouter(aux["schedule_kin"], device),
            "tochan": PackedRouter(aux["schedule_tochan"], device)}


def upstream_table(src_pos, tgt_pos, p_pad):
    """(K, p_pad) int32: the source positions of every target position, in
    ascending order, -1 where there are fewer than K. The routing kernel sums
    its upstream inflow in this order."""
    src_pos = np.asarray(src_pos, np.int64)
    tgt_pos = np.asarray(tgt_pos, np.int64)
    if src_pos.size == 0:
        return np.full((1, p_pad), -1, np.int32)
    order = np.lexsort((src_pos, tgt_pos))
    s, t = src_pos[order], tgt_pos[order]
    first = np.r_[0, np.flatnonzero(np.diff(t)) + 1]
    counts = np.diff(np.r_[first, t.size])
    rank = np.arange(t.size) - np.repeat(first, counts)
    table = np.full((int(counts.max()), p_pad), -1, np.int32)
    table[rank, t] = s
    return table


def packed_routing_params(cfg, params_np, ps):
    """Host-side schedule-order reorder of the per-pixel params the sub-step
    loop touches (p['kinp$...']), with padding fills that keep padded lanes
    inert, plus the routing kernel's tables.

    Returns (params, feeders_earlier, eva_window_ok): whether every structure
    cell lies in a strictly later chunk than all of its feeders, and whether
    the evaporation graph's edges fit the schedule window — the two
    conditions the kernel's structure and evaporation chains rely on."""
    out = {}
    feeders_earlier = True

    def pk(name, fill=0.0):
        out["kinp$" + name] = ps.pack_np(np.asarray(params_np[name], np.float64), fill)

    pk("ChanLength", 1.0)
    pk("ChannelAlpha", 1.0)
    out["kinp$IsChannelKinematic"] = ps.pack_np(
        np.asarray(params_np["IsChannelKinematic"], bool), False)
    out["kinp$AtLastPointC"] = ps.pack_np(np.asarray(params_np["AtLastPointC"], bool), False)
    if cfg.split_routing:
        pk("ChannelAlpha2", 1.0)
        pk("QLimit", 0.0)
        pk("M3Limit", np.inf)      # padded lanes never count as over-limit
        pk("Chan2M3Start", 0.0)
        pk("Chan2QStart", 0.0)
    if cfg.trans_loss:
        out["kinp$UpTrans"] = ps.pack_np(np.asarray(params_np["UpTrans"], bool), False)
        pk("TransPower1", 1.0)
        pk("TransPower2", 1.0)
        pk("TransSub", 0.0)

    P = ps.num_pixels
    p_pad = ps.p_pad
    real = ps.perm < P
    pos = np.flatnonzero(real)
    pix = ps.perm[real]
    # the kernel's hand-over of discharge, by the (structure-cut) routing graph
    has_down = ps.down_pos < p_pad
    out["kinp$UpsTable"] = upstream_table(np.flatnonzero(has_down), ps.down_pos[has_down], p_pad)

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
            if not (upos // ps.chunk < ps.inv_perm[px] // ps.chunk).all():
                feeders_earlier = False
            idx[i, :upos.size] = upos
            w[i, :upos.size] = 1.0
        return idx, w, np.where(w > 0, idx, -1).astype(np.int32)

    struct_pos = []
    if cfg.simulate_lakes:
        lake_pos = ps.inv_perm[np.asarray(params_np["LakeIndex"], np.int64)]
        out["kinp$LakePos"] = lake_pos.astype(np.int32)
        out["kinp$LakeUpsIdx"], out["kinp$LakeUpsW"], out["kinp$LakeFee"] = \
            ups_gather(params_np["LakeIndex"])
        struct_pos += list(lake_pos)
    if cfg.simulate_reservoirs:
        res_pos = ps.inv_perm[np.asarray(params_np["ReservoirIndex"], np.int64)]
        out["kinp$ResPos"] = res_pos.astype(np.int32)
        out["kinp$ResUpsIdx"], out["kinp$ResUpsW"], out["kinp$ResFee"] = \
            ups_gather(params_np["ReservoirIndex"])
        struct_pos += list(res_pos)
    if len(set(struct_pos)) != len(struct_pos):
        raise ValueError("two lakes/reservoirs share a pixel")

    # the open-water evaporation chain inside the kernel: its transfers
    # follow downEva, whose edges must land 1..W chunks later
    eva_window_ok = False
    if cfg.open_water_evapo and "downEva" in params_np:
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
    """Raise NotImplementedError for options outside the port's slice."""
    off = [name for field, name in _NOT_PORTED.items() if getattr(cfg, field)]
    if off:
        raise NotImplementedError(f"options not ported yet: {', '.join(off)}")


class Step:
    """One model step on the device: `step(state, forcing) -> (state, diag)`.

    `state` is the prepared (packed) state of `prepare_state`, `forcing` a
    dict of tensors; `land_phase` runs the step up to the channel routing
    and returns the diagnostics the routing consumes."""

    def __init__(self, cfg, params, routers, device):
        check_options(cfg)
        self.cfg = cfg
        self.params = params
        self.routers = routers
        self.device = torch.device(device)
        self.pipeline = resolve_pipeline(cfg, routers, self.device)
        # the evaporation chain runs inside the routing kernel when its graph
        # fits the schedule window, else before the routing (evapowater_step)
        self.eva_in_kernel = cfg.open_water_evapo and routers["kin"].eva_window_ok

    def prepare_state(self, state, dtype=None):
        """NumPy state -> the step's packed state on the device."""
        dtype = dtype or self.params["ChanLength"].dtype
        return prepare_state(self.cfg, self.routers, to_device(state, self.device, dtype))

    def natural_state(self, state):
        return natural_state(self.cfg, self.routers, state)

    def land_phase(self, s, f):
        cfg, p, routers = self.cfg, self.params, self.routers
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

        # LAI selection (leafarea.py:76-90)
        d["LAI"] = p["LAIX"][f["LAIInterval"]]

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
            wa_state["ChanM3Kin"] = d["ChanM3Kin"] = routers["kin"].unpack(s["pk$ChanM3Kin"])
            d["ChanQ"] = routers["kin"].unpack(s["pk$ChanQ"])
            d.update(ph.water_abstraction_step(cfg, p, wa_state, d))
            if cfg.groundwater_smooth:
                d["LZ"] = groundwater_smooth(cfg, p, d["LZ"], p["LandRows"], p["LandCols"],
                                             cfg.grid_rows, cfg.grid_cols)
        d.update(ph.soil_perpixel_step(cfg, p, s, d))
        d.update(ph.groundwater_step(cfg, p, s, d))

        if cfg.open_water_evapo:
            if self.eva_in_kernel:
                # the kernel takes the own-pixel potential evaporation and
                # returns the chain's result
                d["EvaUpstream0"] = d["EWRef"] * p["MMtoM3"] * d["WaterFraction"]
            else:
                kin = routers["kin"]
                eva_d = dict(d)
                eva_d["ChanM3Kin"] = kin.unpack(s["pk$ChanM3Kin"])
                s_eva = dict(s)
                s_eva["EvaCumM3"] = kin.unpack(s["pk$EvaCumM3"])
                out_eva = ph.evapowater_step(cfg, p, s_eva, eva_d)
                out_eva["pk$EvaCumM3"] = s["pk$EvaCumM3"] + kin.pack(out_eva["EvaAddM3"])
                d.update(out_eva)

        d.update(surface_routing_step(cfg, p, s, d, routers))
        return d

    def __call__(self, s, f):
        cfg, p = self.cfg, self.params
        d = self.land_phase(s, f)
        # the routing starts from the lake and reservoir storages that the
        # water abstraction left
        route_state = dict(s)
        for k in ("LakeStorageM3CC", "ReservoirStorageM3CC", "LakeStorageM3", "ReservoirStorageM3"):
            if k in d:
                route_state[k] = d[k]
        d.update(channel_routing_kernel(cfg, p, route_state, d, self.routers))

        if cfg.simulate_water_levels:
            d.update(ph.waterlevel_step(cfg, p, s, d))
        # polder level diagnostic: the reference's dynamic polder parts are a
        # no-op skeleton (polder.py:72-177), so the storage passes through
        if cfg.simulate_polders:
            d["PolderLevel"] = torch.where(
                p["IsPolder"], s["PolderStorageM3"] / torch.clamp_min(p["PolderArea"], 1e-30), 0.0)
        if cfg.rep_total_water_storage or cfg.rep_mbts:
            d.update(_waterbalance(cfg, p, s, d))
        return _collect_state(cfg, s, d), d


def build_step(cfg, params_np, aux, dtype=torch.float64, device=None):
    """Returns (step, device_params). `aux` holds the channel and overland
    schedules ('schedule_kin', 'schedule_tochan')."""
    check_options(cfg)
    device = resolve_device(device)
    routers = build_routers(cfg, aux, device)
    p = device_params(cfg, params_np, routers, device, dtype)
    return Step(cfg, p, routers, device), p


def build_multi_step(cfg, params_np, aux, output_keys=(), dtype=torch.float64, device=None):
    """Multi-step runner: `multi(state, forcing_stack) -> (state, outputs)`,
    where every forcing entry carries a leading time axis and `outputs`
    holds only `output_keys`, stacked over time. A Python loop over the
    steps (the JAX package's lax.scan)."""
    step, p = build_step(cfg, params_np, aux, dtype, device)
    output_keys = tuple(output_keys)

    def multi(state, forcing_stack):
        n = len(next(iter(forcing_stack.values())))
        outs = {k: [] for k in output_keys}
        for t in range(n):
            state, d = step(state, {k: v[t] for k, v in forcing_stack.items()})
            for k in output_keys:
                outs[k].append(d[k])
        return state, {k: torch.stack(v) for k, v in outs.items()}

    multi.step = step
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
    """waterbalance.py:114-122."""
    stored = d["ChanM3"]
    if cfg.simulate_lakes:
        stored = stored + d["LakeStorageM3Balance"]
    if cfg.simulate_reservoirs:
        stored = stored + d["ReservoirStorageM3"]
    if cfg.simulate_polders:
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
    (waterbalance.py:114-288), without transient land use."""
    catchtotal = lambda x: ph.segment_spread(x, p["Catchments"], cfg.num_catchments)
    out = {}
    channel_stored = _storage_channel(cfg, p, s, d)
    hillslope_stored = _storage_hillslope(cfg, p, s, d)
    if cfg.rep_total_water_storage:
        out["TotalWaterStorageMM"] = (channel_stored + hillslope_stored) * p["M3toMM"]
    if cfg.rep_mbts:
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
            dis_stru = dis_stru + torch.zeros_like(dis_stru).index_copy_(
                0, p["LakeIndex"], 0.5 * d["LakeInflowCC"] * cfg.dt_routing)
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
        out["WaterInit"] = water_stored + dis_structures
        # mass-balance analysis diagnostics (waterbalance.py:276-289)
        sum_fracs = (p["ForestFraction"] + p["DirectRunoffFraction"] + p["WaterFraction"]
                     + p["IrrigationFraction"] + p["OtherFraction"])
        npix = catchtotal(torch.ones_like(sum_fracs))
        out["AverageFractions"] = catchtotal(sum_fracs) / npix
        out["MBErrorStorage"] = mb_error / out["WaterInit"]
    return out

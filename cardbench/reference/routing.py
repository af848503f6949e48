"""The plain reference's routing: overland flow, the sub-stepped channel
loop with lakes, reservoirs and split routing, and what follows the loop.

The arithmetic is a frozen copy of the program's sequential sub-step loop
(lisflood_tpu_torch/ops/routing_ops.py: surface_routing_step,
channel_routing_substeps, _post_routing; ops/kinwave_substep.py:
_lake_step, _reservoir_step; ops/kinwave_packed.py: _newton_unrolled;
commit c77b93b), in natural pixel order. Its order of work is its own: a
cell at sub-step n needs its sources at sub-step n and itself at n - 1, so
the cells are taken by diagonals of (level, sub-step), level the longest
path from a headwater of the graph that orders the structures after their
feeders. A lake or reservoir steps at the start of its sub-step from its
feeders' discharge of the sub-step before, as in the sequential loop.
State entries carry a leading member axis: (M, P).
"""
from __future__ import annotations

import numpy as np
import torch

from .graph import sweep_levels, upstream_csr

NEWTON_TOL = 1e-12
NEWTON_ITERS = 6
# the structure state keys of each kind: lk_*, rs_*
PREFIX = {"lake": "lk", "reservoir": "rs"}


def newton_solve(c_total, adx, beta, iters=NEWTON_ITERS):
    """Q + adx Q^beta = c_total by Newton from the secant bounds, a fixed
    number of masked iterations (the q-space solve of LISFLOOD's
    kinematic_wave_parallel_tools)."""
    inv_beta = 1.0 / beta
    b_a_dx = beta * adx
    small = c_total <= NEWTON_TOL
    c = torch.where(small, 1.0, c_total)
    a_cpui_pow = b_a_dx * c ** (beta - 1.0)
    secant = torch.where(a_cpui_pow <= 1.0, c / (1.0 + a_cpui_pow),
                         c / (1.0 + a_cpui_pow ** inv_beta))
    other = ((c - secant) / adx) ** inv_beta
    q = 0.5 * (secant + other)
    prev = torch.full_like(q, -1.0)
    for _ in range(iters):
        powq = q ** beta
        err = q + adx * powq - c
        active = (err.abs() > NEWTON_TOL) & (q != prev)
        q_next = torch.clamp_min(q - err / (1.0 + b_a_dx * powq / q), NEWTON_TOL)
        q, prev = torch.where(active, q_next, q), torch.where(active, q, prev)
    q = torch.where(q == NEWTON_TOL, 0.0, q)
    return torch.where(small, 0.0, q)


class Sweep:
    """A natural graph's sweep plan on the device: for every group of
    `order_down`'s levels the pixels and their sources in `down` (a padded
    table, P where none). `order_down` orders the pixels (every edge of
    `down` is an edge of it)."""

    def __init__(self, down, device, order_down=None):
        down = np.asarray(down, np.int64)
        P = down.size
        self.P = P
        self.has_edges = bool((down >= 0).any())
        ptr, src = upstream_csr(down)
        K = max(1, int(np.diff(ptr).max()) if P else 1)
        table = np.full((K, P), P, np.int64)
        n = np.diff(ptr)
        col = np.repeat(np.arange(P), n)
        row = np.arange(src.size) - np.repeat(ptr[:-1], n)
        table[row, col] = src
        self.table = torch.as_tensor(table, device=device)
        levels = sweep_levels(down if order_down is None else order_down)
        self.depth = np.zeros(P, np.int64)
        for i, lv in enumerate(levels):
            self.depth[lv] = i
        self.levels = [torch.as_tensor(lv, device=device) for lv in levels]

    def inflow(self, q, pix):
        """Sum over each of `pix`'s sources of q (..., P + 1; the last entry
        0), in the table's order."""
        total = q[..., self.table[0, pix]]
        for k in range(1, self.table.shape[0]):
            total = total + q[..., self.table[k, pix]]
        return total

    def route(self, const, adx, beta):
        """Q + adx Q^beta = const + the sources' Q, pixel by pixel down the
        graph; const and adx (..., P)."""
        if not self.has_edges:
            return newton_solve(const, adx, beta)
        q = const.new_zeros(const.shape[:-1] + (self.P + 1,))
        for pix in self.levels:
            q[..., pix] = newton_solve(self.inflow(q, pix) + const[..., pix], adx[..., pix], beta)
        return q[..., :self.P]


def surface_routing_step(cfg, p, s, d, sweep):
    """Overland kinematic wave for the runoff lanes [Other, Forest, Direct]
    (surface_routing.py:115-213)."""
    soil_frac = p["SoilFraction"]
    surface_run_soil = soil_frac * torch.clamp_min(
        d["AvailableWaterForInfiltration"] - d["Infiltration"], 0)
    mmto_m3 = p["MMtoM3"]
    inv_pl = 1.0 / p["PixelLength"]
    inv_dt = 1.0 / cfg.dt_sec
    sideflow_direct = d["DirectRunoff"] * mmto_m3 * inv_pl * inv_dt
    sideflow_other = (surface_run_soil[0] + surface_run_soil[2]) * mmto_m3 * inv_pl * inv_dt
    sideflow_forest = surface_run_soil[1] * mmto_m3 * inv_pl * inv_dt
    dx = p["PixelLength"]
    adx = p["OFAlpha"] * dx / cfg.dt_sec
    q0 = torch.stack([s["OFQOther"], s["OFQForest"], s["OFQDirect"]])
    lat = torch.stack([sideflow_other, sideflow_forest, sideflow_direct]) * dx
    beta = p["Beta"]
    lanes = sweep.route(adx * q0 ** beta + lat, adx, beta)
    of_q_other, of_q_forest, of_q_direct = lanes[0], lanes[1], lanes[2]
    surface_runoff = d["DirectRunoff"] + surface_run_soil.sum(0)
    of_m3_direct = dx * p["OFAlpha"][2] * of_q_direct**beta
    of_m3_other = dx * p["OFAlpha"][0] * of_q_other**beta
    of_m3_forest = dx * p["OFAlpha"][1] * of_q_forest**beta
    q_all = of_q_direct + of_q_other + of_q_forest
    m3_all = of_m3_direct + of_m3_other + of_m3_forest
    of_to_chan = torch.where(p["IsChannel"], q_all * cfg.dt_sec, 0.0)
    to_chan_runoff = (d["UZOutflowPixel"] + d["LZOutflowToChannelPixel"]) * mmto_m3 + of_to_chan
    return {
        "SurfaceRunSoil": surface_run_soil,
        "SurfaceRunoff": surface_runoff,
        "TotalRunoff": surface_runoff + d["UZOutflowPixel"] + d["LZOutflowToChannelPixel"],
        "OFQDirect": of_q_direct, "OFQOther": of_q_other, "OFQForest": of_q_forest,
        "OFM3Direct": of_m3_direct, "OFM3Other": of_m3_other, "OFM3Forest": of_m3_forest,
        "Qall": q_all, "M3all": m3_all, "OFToChanM3": of_to_chan,
        "WaterDepth": m3_all * p["M3toMM"],
        "ToChanM3RunoffDt": to_chan_runoff / cfg.no_rout_steps,
        "ToChanM3Runoff": to_chan_runoff,
    }


def lake_step(p, ys, inflow, dt_r):
    """One Modified Puls step (lakes.py:199-263) of every lake: advances
    `ys` and returns the outflow volumes."""
    lake_in = (inflow + ys["lk_inold"]) * 0.5
    si = ys["lk_st"] / dt_r - 0.5 * ys["lk_out"] + lake_in
    r = -p["LakeFactor"] + torch.sqrt(p["LakeFactorSqr"] + 2.0 * si)
    out_new = r * r
    q_out = out_new * dt_r
    st_new = (si - out_new * 0.5) * dt_r
    st_new = torch.where(torch.isnan(st_new) | (st_new < 0), 0.0, st_new)
    ys.update(lk_bal=ys["lk_bal"] + lake_in * dt_r - q_out, lk_inold=inflow, lk_in=inflow,
              lk_out=out_new, lk_st=st_new, lk_level=st_new / p["LakeAreaCC"],
              lk_sumin=ys["lk_sumin"] + inflow * dt_r, lk_sumout=ys["lk_sumout"] + q_out)
    return q_out


def reservoir_step(p, ys, inflow, dt_r):
    """One rule-curve step (reservoir.py:173-303) of every reservoir."""
    total, cons = p["TotalReservoirStorageM3CC"], p["ConservativeStorageLimitCC"]
    norm, flood = p["NormalStorageLimitCC"], p["FloodStorageLimitCC"]
    nfl, nondam = p["Normal_FloodStorageLimitCC"], p["NonDamagingReservoirOutflowCC"]
    normout, minout = p["NormalReservoirOutflowCC"], p["MinReservoirOutflowCC"]
    delta_o, dln, dnfl = p["DeltaO"], p["DeltaLN"], p["DeltaNFL"]
    inv_day = 1.0 / 86400.0
    q_in = inflow * dt_r
    st_new = ys["rs_st"] + q_in
    f = st_new / total
    o1 = torch.minimum(minout, st_new * inv_day)
    o2 = minout + delta_o * (f - 2 * cons) / dln
    o3a = normout
    o3b = o3a + ((f - nfl) / dnfl) * (nondam - o3a)
    temp4 = torch.minimum(nondam, torch.maximum(inflow * 1.2, o3a))
    o4 = torch.maximum((f - flood - 0.01) * total * inv_day, temp4)
    outflow = o1
    outflow = torch.where(f > 2 * cons, o2, outflow)
    outflow = torch.where(f > norm, o3a, outflow)
    outflow = torch.where(f > nfl, o3b, outflow)
    outflow = torch.where(f > flood, o4, outflow)
    temp = torch.minimum(outflow, torch.maximum(inflow, o3a))
    outflow = torch.where((outflow > 1.2 * inflow) & (outflow > o3a) & (f < flood), temp, outflow)
    q_out = outflow * dt_r
    q_out = torch.minimum(q_out, st_new)
    q_out = torch.maximum(q_out, st_new - total)
    st_new = st_new - q_out
    f = st_new / total
    f = torch.where(torch.isnan(f) | (f < 0), 0.0, f)
    ys.update(rs_st=st_new, rs_fill=f, rs_sumin=ys["rs_sumin"] + q_in,
              rs_sumout=ys["rs_sumout"] + q_out)
    return q_out


class ChannelPlan:
    """The channel loop's order: the structure-cut graph `down_kin`'s
    sources, the pixels by diagonals of (level of `down_order`, sub-step),
    and each structure's feeders in `downstruct` (the uncut channel
    graph)."""

    def __init__(self, down_kin, down_order, downstruct, structures, T, device):
        self.sweep = Sweep(down_kin, device, order_down=down_order)
        self.T = T
        depth = self.sweep.depth
        levels = [lv.cpu().numpy() for lv in self.sweep.levels]
        self.diagonals = []
        for dg in range(len(levels) + T - 1):
            ns = [n for n in range(T) if 0 <= dg - n < len(levels)]
            pix = np.concatenate([levels[dg - n] for n in ns])
            sub = np.concatenate([np.full(levels[dg - n].size, n) for n in ns])
            self.diagonals.append((torch.as_tensor(pix, device=device),
                                   torch.as_tensor(sub, device=device)))
        P = self.sweep.P
        downstruct = np.asarray(downstruct, np.int64)
        self.structures = {}
        for name, cells in structures.items():
            cells = np.array(cells, np.int64)
            feeders = [np.flatnonzero(downstruct == c) for c in cells]
            K = max(1, max(f.size for f in feeders))
            table = np.full((cells.size, K), P, np.int64)
            for i, f in enumerate(feeders):
                table[i, :f.size] = f
            # the diagonal at which each structure steps at sub-step 0
            self.structures[name] = (torch.as_tensor(cells, device=device),
                                     torch.as_tensor(table, device=device), depth[cells])


def channel_routing(cfg, p, s, d, plan):
    """The NoRoutSteps sub-step loop (routing.py:435-706, the program's
    channel_routing_substeps) with split routing, lakes, reservoirs and the
    evaporation moved down before it; returns the carry of the loop in
    natural pixel space."""
    T, dt_r, beta = cfg.no_rout_steps, cfg.dt_routing, p["Beta"]
    dx = p["ChanLength"]
    inv_dx = 1.0 / dx
    adx = torch.stack([p["ChannelAlpha"] * dx / dt_r, p["ChannelAlpha2"] * dx / dt_r])
    M, P = s["ChanQKin"].shape
    to_chan = d["ToChanM3RunoffDt"]
    eva_dt = d["EvaAddM3Dt"] if cfg.open_water_evapo else torch.zeros_like(to_chan)
    zero = torch.zeros_like(to_chan)
    pad = lambda x: torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], -1)
    q1, m31 = s["ChanQKin"].clone(), s["ChanM3Kin"].clone()
    q2, m32 = s["Chan2QKin"].clone(), s["Chan2M3Kin"].clone()
    cross2, side1 = s["CrossSection2Area"].clone(), s["Sideflow1Chan"].clone()
    sumdis = torch.zeros_like(to_chan)
    # each sub-step's discharge: the sweep's own (sources' inflow) and ChanQ
    raw = to_chan.new_zeros((T, 2, M, P + 1))
    chanq = to_chan.new_zeros((T + 1, M, P + 1))
    chanq[0, :, :P] = s["ChanQ"]
    struct_out = to_chan.new_zeros((T, M, P))
    ys = {}
    if cfg.lakes:
        ys.update(lk_st=s["LakeStorageM3CC"], lk_inold=s["LakeInflowOldCC"],
                  lk_out=s["LakeOutflowCC"], lk_bal=s["LakeStorageM3BalanceCC"],
                  lk_level=s["LakeLevelCC"], lk_in=zero.new_zeros((M, cfg.num_lakes)),
                  lk_sumin=zero.new_zeros((M, cfg.num_lakes)),
                  lk_sumout=zero.new_zeros((M, cfg.num_lakes)))
    if cfg.reservoirs:
        ys.update(rs_st=s["ReservoirStorageM3CC"], rs_fill=s["ReservoirFillCC"],
                  rs_sumin=zero.new_zeros((M, cfg.num_reservoirs)),
                  rs_sumout=zero.new_zeros((M, cfg.num_reservoirs)))
    ys = {k: v.clone() for k, v in ys.items()}
    steps = {"lake": lake_step, "reservoir": reservoir_step}
    for dg, (pix, sub) in enumerate(plan.diagonals):
        # the structures whose sub-step starts here step first, from their
        # feeders' discharge of the sub-step before
        for name, (cells, feeders, depth0) in plan.structures.items():
            for n in sorted({int(dg - t) for t in depth0 if 0 <= dg - t < T}):
                sel = torch.as_tensor(dg - depth0 == n, device=cells.device)
                stepped = dict(ys)
                q_out = steps[name](p, stepped, chanq[n][:, feeders].sum(-1), dt_r)
                for k in stepped:
                    if k[:2] == PREFIX[name]:
                        ys[k] = torch.where(sel, stepped[k], ys[k])
                struct_out[n][:, cells[sel]] += q_out[:, sel]
        sideflow_m3 = to_chan[:, pix] - eva_dt[:, pix] + struct_out[sub, :, pix].T
        sideflow = torch.where(p["IsChannelKinematic"][pix], sideflow_m3 * inv_dx[pix] / dt_r, 0.0)
        sideflow = torch.where(torch.isnan(sideflow), 0.0, sideflow)
        a_m31, a_m32 = m31[:, pix], m32[:, pix]
        ratio_den = a_m31 + a_m32
        ratio = torch.where(ratio_den > 0, a_m31 / torch.where(ratio_den > 0, ratio_den, 1.0), 0.0)
        over = (a_m31 + a_m32 - p["Chan2M3Start"][pix]) > p["M3Limit"][pix]
        sideflow1 = torch.where(over, ratio * sideflow, sideflow)
        sideflow1 = torch.where(sideflow.abs() < 1e-7, sideflow, sideflow1)
        sideflow2 = sideflow - sideflow1 + p["Chan2QStart"][pix] * inv_dx[pix]
        a = adx[:, pix][:, None]
        const = a * torch.stack([q1[:, pix], q2[:, pix]]) ** beta \
            + torch.stack([sideflow1, sideflow2]) * dx[pix]
        table = plan.sweep.table[:, pix]
        inflow = torch.zeros_like(const)
        for k in range(table.shape[0]):
            inflow = inflow + raw[sub, :, :, table[k]].permute(1, 2, 0)
        q12 = newton_solve(inflow + const, a, beta)
        raw[sub, :, :, pix] = q12.permute(2, 0, 1)
        n_m31 = torch.clamp_min(dx[pix] * p["ChannelAlpha"][pix] * q12[0] ** beta, 0.0)
        n_q1 = (n_m31 * inv_dx[pix] / p["ChannelAlpha"][pix]) ** (1 / beta)
        n_m32 = dx[pix] * p["ChannelAlpha2"][pix] * q12[1] ** beta
        n_m32 = torch.where(n_m32 - p["Chan2M3Start"][pix] < 0.0, p["Chan2M3Start"][pix], n_m32)
        n_q2 = (n_m32 * inv_dx[pix] / p["ChannelAlpha2"][pix]) ** (1 / beta)
        n_chanq = torch.clamp_min(n_q1 + n_q2 - p["QLimit"][pix], 0.0)
        q1[:, pix], m31[:, pix], q2[:, pix], m32[:, pix] = n_q1, n_m31, n_q2, n_m32
        cross2[:, pix] = (n_m32 - p["Chan2M3Start"][pix]) * inv_dx[pix]
        side1[:, pix] = sideflow1
        chanq[sub + 1, :, pix] = n_chanq.T
        sumdis[:, pix] = sumdis[:, pix] + n_chanq
    carry = {"ChanQKin": q1, "ChanM3Kin": m31, "ChanQ": chanq[T, :, :P].clone(),
             "sumDisDay": sumdis, "Chan2QKin": q2, "Chan2M3Kin": m32,
             "CrossSection2Area": cross2, "Sideflow1Chan": side1}
    names = {"lk_st": "LakeStorageM3CC", "lk_inold": "LakeInflowOldCC", "lk_in": "LakeInflowCC",
             "lk_out": "LakeOutflowCC", "lk_bal": "LakeStorageM3BalanceCC",
             "lk_level": "LakeLevelCC", "lk_sumin": "sumLakeInCC", "lk_sumout": "sumLakeOutCC",
             "rs_st": "ReservoirStorageM3CC", "rs_fill": "ReservoirFillCC",
             "rs_sumin": "sumResInCC", "rs_sumout": "sumResOutCC"}
    carry.update({names[k]: v for k, v in ys.items()})
    if cfg.rep_mbts:
        ct = lambda x: catchtotal(x, p["Catchments"], cfg.num_catchments)
        carry["AddedTRUN"] = T * ct(to_chan) - T * ct(eva_dt)
    return carry


def catchtotal(values, catchments, n):
    """Each pixel's catchment total of `values` (..., P)."""
    flat = values.reshape(-1, values.shape[-1])
    out = flat.new_zeros((flat.shape[0], n))
    out.index_add_(1, catchments, flat)
    return out[:, catchments].reshape(values.shape)


def post_routing(cfg, p, s, d, carry):
    """The state and diagnostics after the loop (Lisflood_dynamic.py:194-230,
    routing.py:645-706)."""
    P = p["ChanLength"].shape[-1]
    dx = p["ChanLength"]
    inv_dx = 1.0 / dx
    ct = lambda x: catchtotal(x, p["Catchments"], cfg.num_catchments)
    out = dict(carry)
    chan_m3 = carry["ChanM3Kin"] + carry["Chan2M3Kin"] - p["Chan2M3Start"]
    out["ChanM3"] = chan_m3
    out["TotalCrossSectionArea"] = chan_m3 * inv_dx
    out["sumDis"] = s["sumDis"] + carry["sumDisDay"]
    out["ChanQAvg"] = carry["sumDisDay"] / cfg.no_rout_steps
    out["DischargeM3Out"] = s["DischargeM3Out"] + torch.where(
        p["AtLastPointC"], carry["ChanQ"] * cfg.dt_sec, 0.0)

    def expand(idx, cc):
        full = cc.new_zeros(cc.shape[:-1] + (P,))
        full[..., idx] = cc
        return full

    if cfg.lakes:
        li = p["LakeIndex"]
        out["LakeStorageM3Balance"] = expand(li, carry["LakeStorageM3BalanceCC"])
        out["LakeStorageM3"] = expand(li, carry["LakeStorageM3CC"])
    if cfg.reservoirs:
        out["ReservoirStorageM3"] = expand(p["ReservoirIndex"], carry["ReservoirStorageM3CC"])
    if cfg.rep_mbts:
        sum1 = torch.where(p["AtLastPointC"], carry["sumDisDay"] / cfg.no_rout_steps, 0.0)
        out_step = ct(sum1 * cfg.dt_sec)
        storage_step = chan_m3
        if cfg.reservoirs:
            storage_step = storage_step + out["ReservoirStorageM3"]
        if cfg.lakes:
            storage_step = storage_step + out["LakeStorageM3Balance"]
        dt_r = cfg.dt_routing
        dis_stru = torch.where(p["IsUpsOfStructureKinematicC"], carry["ChanQ"] * dt_r, 0.0)
        if cfg.lakes:
            dis_stru = dis_stru + expand(p["LakeIndex"], 0.5 * carry["LakeInflowCC"] * dt_r)
        dis_structures = ct(dis_stru) - s["DischargeM3StructuresIni"]
        storage_step1 = ct(storage_step)
        out["MBErrorSplitRoutingM3"] = (-storage_step1 + s["StorageStepINIT"] - out_step
                                        - dis_structures + carry["AddedTRUN"])
        out["StorageStepINIT"] = storage_step1 + dis_structures
    return out


def waterbalance(cfg, p, s, d):
    """The catchment mass balance's carried terms (waterbalance.py:114-288):
    the next step's WaterInit."""
    ct = lambda x: catchtotal(x, p["Catchments"], cfg.num_catchments)
    stored = d["ChanM3"]
    if cfg.lakes:
        stored = stored + d["LakeStorageM3Balance"]
    if cfg.reservoirs:
        stored = stored + d["ReservoirStorageM3"]
    hill1 = d["LZ"] + (p["SoilFraction"] * (d["CumInterception"] + d["W1a"] + d["W1b"]
                                            + d["W2"] + d["UZ"])).sum(0)
    hillslope = (d["WaterDepth"] + d["SnowCover"] + hill1
                 + d["DirectRunoffFraction"] * d["CumInterSealed"]) * p["MMtoM3"]
    dis_stru = torch.where(p["IsUpsOfStructureKinematicC"], d["ChanQ"] * cfg.dt_routing, 0.0)
    if cfg.lakes:
        lake = d["ChanQ"].new_zeros(d["ChanQ"].shape)
        lake[..., p["LakeIndex"]] = 0.5 * d["LakeInflowCC"] * cfg.dt_routing
        dis_stru = dis_stru + lake
    dis_structures = ct(dis_stru) - s["DischargeM3StructuresIni"]
    return {"WaterInit": ct(stored) + ct(hillslope) + dis_structures}



"""Surface and channel routing of one model step — the port of
lisflood_tpu/ops/routing_ops.py (surface_routing.py:115-213,
routing.py:435-706, lakes.py:199-298, reservoir.py:173-323,
transmission.py:67-89, Lisflood_dynamic.py:176-230).

Two sub-step loops, chosen by the channel router (resolve_pipeline):
  - the packed router's: the chunk-major loop of ops/kinwave_substep.py, the
    whole NoRoutSteps x chunks loop of a step in one launch of the CUDA
    kernel on a CUDA device, its plain PyTorch version on the CPU
    (channel_routing_kernel);
  - the sharded and the scan router's: the sequential loop of the JAX
    package's `channel_routing` (channel_routing_substeps), one sub-step
    after the other, each routing the whole graph with one sweep of K6
    (ops/kinwave_sharded.py; the scan router, ops/kinwave.py, sweeps the
    natural graph in the identity position space).
The JAX package's chunk-major XLA loop (`channel_routing_pipelined`) is a
schedule for XLA that the kernel replaces and has no counterpart here.
"""
from __future__ import annotations

import torch

from .kinwave import ScanRouter
from .kinwave_packed import PackedRouter
from .kinwave_sharded import ShardedRouter
from .kinwave_substep import (WAVEFRONT_TABLES, SubstepSpec, _lake_step, _reservoir_step,
                              kinwave_substep)
from .physics import place, segment_spread, take


def overland_operands(cfg, p, s, d):
    """The overland kinematic wave's operands for the lanes [Other, Forest,
    Direct] (surface_routing.py:115-160): (surface runoff of the soil
    fractions, (3, P) discharge, (3, P) lateral inflow, (3, P) alpha*dx/dt)."""
    soil_frac = p["SoilFraction"]
    surface_run_soil = soil_frac * torch.clamp_min(d["AvailableWaterForInfiltration"] - d["Infiltration"], 0)

    mmto_m3 = p["MMtoM3"]
    inv_pl = 1.0 / p["PixelLength"]
    inv_dt = 1.0 / cfg.dt_sec
    sideflow_direct = d["DirectRunoff"] * mmto_m3 * inv_pl * inv_dt
    sideflow_other = (surface_run_soil[0] + surface_run_soil[2]) * mmto_m3 * inv_pl * inv_dt
    sideflow_forest = surface_run_soil[1] * mmto_m3 * inv_pl * inv_dt

    # OFAlpha lanes [Other, Forest, Direct]; a_dx_div_dt = alpha * dx / dt
    dx = p["PixelLength"]
    adx = p["OFAlpha"] * dx / cfg.dt_sec
    q0 = torch.stack([s["OFQOther"], s["OFQForest"], s["OFQDirect"]])
    lat = torch.stack([sideflow_other, sideflow_forest, sideflow_direct]) * dx
    return surface_run_soil, q0, lat, adx


def surface_routing_step(cfg, p, s, d, routers):
    """Overland kinematic wave for 3 runoff lanes (surface_routing.py:115-213)."""
    surface_run_soil, q0, lat, adx = overland_operands(cfg, p, s, d)
    surface_runoff = d["DirectRunoff"] + surface_run_soil.sum(0)
    total_runoff = surface_runoff + d["UZOutflowPixel"] + d["LZOutflowToChannelPixel"]
    mmto_m3 = p["MMtoM3"]
    dx = p["PixelLength"]
    beta = p["Beta"]
    q_lanes = routers["tochan"].route_batched(q0, lat, adx, beta)
    of_q_other, of_q_forest, of_q_direct = q_lanes[0], q_lanes[1], q_lanes[2]

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
        "TotalRunoff": total_runoff,
        "OFQDirect": of_q_direct, "OFQOther": of_q_other, "OFQForest": of_q_forest,
        "OFM3Direct": of_m3_direct, "OFM3Other": of_m3_other, "OFM3Forest": of_m3_forest,
        "Qall": q_all, "M3all": m3_all,
        "OFToChanM3": of_to_chan,
        "WaterDepth": m3_all * p["M3toMM"],
        "ToChanM3RunoffDt": to_chan_runoff / cfg.no_rout_steps,
        "ToChanM3Runoff": to_chan_runoff,
    }


def resolve_pipeline(cfg, routers, device):
    """Which implementation runs the sub-step loop: for the packed router
    'cuda' (the kernel) on a CUDA device and 'reference' (its plain PyTorch
    version) on the CPU, in float32 and float64 alike; for the sharded and
    the scan router 'substeps', the sequential loop
    (channel_routing_substeps), on any device. Raises for a configuration no
    loop takes."""
    kin = routers["kin"]
    if isinstance(kin, (ShardedRouter, ScanRouter)):
        return "substeps"
    if not isinstance(kin, PackedRouter):
        raise NotImplementedError("the sub-step loops take the packed or the sharded router")
    structs = cfg.lakes or cfg.reservoirs
    if structs and not kin.struct_feeders_earlier:
        raise NotImplementedError(
            "a lake or reservoir is not chunked after all of its feeders: the sub-step "
            "kernel needs them earlier; the sequential loop runs with the sharded router "
            "(RoutingKernel sharded)")
    kind = torch.device(device).type
    if kind == "cuda":
        return "cuda"
    if kind == "cpu":
        return "reference"
    raise RuntimeError(f"no sub-step pipeline for device {kind!r}")


# the lake and reservoir state of the sub-step loops' structure steps
# (ops/kinwave_substep._lake_step, _reservoir_step) and its state keys
STRUCTURE_CARRY = {
    "lk_st": "LakeStorageM3CC", "lk_inold": "LakeInflowOldCC", "lk_in": "LakeInflowCC",
    "lk_out": "LakeOutflowCC", "lk_bal": "LakeStorageM3BalanceCC", "lk_level": "LakeLevelCC",
    "lk_sumin": "sumLakeInCC", "lk_sumout": "sumLakeOutCC",
    "rs_st": "ReservoirStorageM3CC", "rs_fill": "ReservoirFillCC",
    "rs_sumin": "sumResInCC", "rs_sumout": "sumResOutCC",
}


def structure_params(cfg, p):
    """The lake and reservoir parameters of the structure steps, by their
    operand names."""
    out = {}
    if cfg.lakes:
        out.update({"lk_factor": p["LakeFactor"], "lk_factorsqr": p["LakeFactorSqr"],
                    "lk_area": p["LakeAreaCC"]})
    if cfg.reservoirs:
        out.update({
            "rs_tot": p["TotalReservoirStorageM3CC"],
            "rs_cons": p["ConservativeStorageLimitCC"],
            "rs_norm": p["NormalStorageLimitCC"],
            "rs_flood": p["FloodStorageLimitCC"],
            "rs_nfl": p["Normal_FloodStorageLimitCC"],
            "rs_nondam": p["NonDamagingReservoirOutflowCC"],
            "rs_normout": p["NormalReservoirOutflowCC"],
            "rs_minout": p["MinReservoirOutflowCC"],
            "rs_do": p["DeltaO"], "rs_dln": p["DeltaLN"], "rs_dnfl": p["DeltaNFL"],
        })
    return out


def channel_routing_substeps(cfg, p, s, d, routers):
    """The NoRoutSteps sub-step loop, one sub-step after the other, in the
    channel router's position space (lisflood_tpu/ops/routing_ops.py:
    channel_routing, :185-414; the scan router's is the identity, its
    kinp$ parameters the natural ones): each sub-step runs the lakes and
    reservoirs on the previous sub-step's discharge, assembles the
    sideflow, and routes single or split (two lanes in one sweep); the
    catchment totals of the mass balance are taken in the loop. The state is
    natural across steps; the result goes through _post_routing."""
    kin = routers["kin"]
    pk = lambda name: p["kinp$" + name]
    pack, unpack = kin.pack, kin.unpack
    T = cfg.no_rout_steps
    dt_r = cfg.dt_routing
    dtype = s["ChanQKin"].dtype
    beta = p["Beta"]
    dx = pk("ChanLength")
    inv_dx = 1.0 / dx
    adx1 = pk("ChannelAlpha") * dx / dt_r
    inv_alpha1 = 1.0 / pk("ChannelAlpha")
    if cfg.split:
        adx2 = pk("ChannelAlpha2") * dx / dt_r
        inv_alpha2 = 1.0 / pk("ChannelAlpha2")

    # per-step inputs of the loop, in position space
    to_chan = pack(d["ToChanM3RunoffDt"])
    if cfg.open_water_evapo:
        eva_dt = pack(d["EvaAddM3Dt"])
    if cfg.water_use:
        wuse_add = (pack(d["withdrawal_CH_actual_M3_routStep"])
                    - pack(d["returnflow_GwAbs2Channel_M3_routStep"]))
    if cfg.inflow:
        qin_old, qdelta = pack(d["QInM3OldLoop"]), pack(d["QDelta"])

    zero = torch.zeros_like(to_chan)
    c = {"ChanQKin": pack(s["ChanQKin"]), "ChanM3Kin": pack(s["ChanM3Kin"]),
         "ChanQ": pack(s["ChanQ"]), "sumDisDay": zero}
    if cfg.split:
        for k in ("Chan2QKin", "Chan2M3Kin", "CrossSection2Area", "Sideflow1Chan"):
            c[k] = pack(s[k])
    if cfg.trans_loss:
        c["TransCum"] = pack(s["TransCum"])
    if cfg.inflow:
        c["QinADDEDM3"] = zero
    # lakes and reservoirs: their state, advanced in place by the structure
    # steps, and the positions of their feeders
    xs = structure_params(cfg, p)
    ys = {}
    if cfg.lakes:
        lake_zero = torch.zeros(cfg.num_lakes, dtype=dtype, device=zero.device)
        ys.update({"lk_st": s["LakeStorageM3CC"], "lk_inold": s["LakeInflowOldCC"],
                   "lk_in": lake_zero, "lk_out": s["LakeOutflowCC"],
                   "lk_bal": s["LakeStorageM3BalanceCC"], "lk_level": s["LakeLevelCC"],
                   "lk_sumin": lake_zero, "lk_sumout": lake_zero})
    if cfg.reservoirs:
        res_zero = torch.zeros(cfg.num_reservoirs, dtype=dtype, device=zero.device)
        ys.update({"rs_st": s["ReservoirStorageM3CC"], "rs_fill": s["ReservoirFillCC"],
                   "rs_sumin": res_zero, "rs_sumout": res_zero})
    ys = {k: v.clone() for k, v in ys.items()}
    every = slice(None)

    def structure_out(name, step):
        """The structures' outflow volumes, placed at their positions, from
        their inflow: the previous sub-step's discharge of their feeders."""
        inflow = (take(c["ChanQ"], pk(name + "UpsIdx")) * pk(name + "UpsW")).sum(1)
        q_out = step(xs, ys, every, inflow, dt_r)
        return place(torch.zeros_like(zero), pk(name + "Pos"), q_out)

    if cfg.rep_mbts:
        # in-loop catchment totals in position space, in the order built over
        # kinp$Catchments: padded positions carry the extra segment
        # num_catchments, so they never add to a real total. The totals of
        # the terms that do not change over the sub-steps are taken once.
        ct = lambda x: segment_spread(x, p["seg$kinp$Catchments"])
        c["AddedTRUN"] = zero
        added_const = ct(to_chan)
        if cfg.open_water_evapo:
            eva_total = ct(eva_dt)
        if cfg.water_use:
            wuse_total = ct(wuse_add)

    for n in range(T):
        if cfg.lakes:
            q_lake_out = structure_out("Lake", _lake_step)
        if cfg.reservoirs:
            q_res_out = structure_out("Res", _reservoir_step)
        if cfg.inflow:
            q_in_dt = (qin_old + float(n + 1) * qdelta) / T
            c["QinADDEDM3"] = c["QinADDEDM3"] + q_in_dt
        if cfg.trans_loss:
            chan_q = c["ChanQ"]
            trans_out = torch.where(
                pk("UpTrans"), (chan_q ** pk("TransPower2") - pk("TransSub")) ** pk("TransPower1"),
                chan_q)
            trans_loss_m3 = (chan_q - trans_out) * dt_r
            c["TransCum"] = c["TransCum"] + trans_loss_m3

        # sideflow assembly (routing.py:462-478)
        sideflow_m3 = to_chan
        if cfg.open_water_evapo:
            sideflow_m3 = sideflow_m3 - eva_dt
        if cfg.water_use:
            sideflow_m3 = sideflow_m3 - wuse_add
        if cfg.inflow:
            sideflow_m3 = sideflow_m3 + q_in_dt
        if cfg.trans_loss:
            sideflow_m3 = sideflow_m3 - trans_loss_m3
        if cfg.lakes:
            sideflow_m3 = sideflow_m3 + q_lake_out
        if cfg.reservoirs:
            sideflow_m3 = sideflow_m3 + q_res_out

        if cfg.rep_mbts:
            added = added_const
            if cfg.inflow:
                added = added + ct(q_in_dt)
            if cfg.open_water_evapo:
                added = added - eva_total
            if cfg.water_use:
                added = added - wuse_total
            c["AddedTRUN"] = c["AddedTRUN"] + added

        sideflow = torch.where(pk("IsChannelKinematic"), sideflow_m3 * inv_dx / dt_r, 0.0)
        sideflow = torch.where(torch.isnan(sideflow), 0.0, sideflow)

        if not cfg.split:
            # single routing (routing.py:518-541)
            q = kin.route_packed(c["ChanQKin"][None], (sideflow * dx)[None], adx1[None], beta)[0]
            m3 = torch.clamp_min(dx * pk("ChannelAlpha") * q ** beta, 0.0)
            q = (m3 * inv_dx * inv_alpha1) ** (1 / beta)
            c.update(ChanQKin=q, ChanM3Kin=m3, ChanQ=q, sumDisDay=c["sumDisDay"] + q)
        else:
            # double routing (routing.py:543-604)
            m3_1, m3_2 = c["ChanM3Kin"], c["Chan2M3Kin"]
            ratio_den = m3_1 + m3_2
            sideflow_ratio = torch.where(
                ratio_den > 0, m3_1 / torch.where(ratio_den > 0, ratio_den, 1.0), 0.0)
            over_limit = (m3_1 + m3_2 - pk("Chan2M3Start")) > pk("M3Limit")
            sideflow1 = torch.where(over_limit, sideflow_ratio * sideflow, sideflow)
            sideflow1 = torch.where(sideflow.abs() < 1e-7, sideflow, sideflow1)
            sideflow2 = sideflow - sideflow1 + pk("Chan2QStart") * inv_dx
            # main channel and floodplain in one sweep
            q12 = kin.route_packed(torch.stack([c["ChanQKin"], c["Chan2QKin"]]),
                                   torch.stack([sideflow1, sideflow2]) * dx,
                                   torch.stack([adx1, adx2]), beta)
            m31 = torch.clamp_min(dx * pk("ChannelAlpha") * q12[0] ** beta, 0.0)
            q1 = (m31 * inv_dx * inv_alpha1) ** (1 / beta)
            m32 = dx * pk("ChannelAlpha2") * q12[1] ** beta
            m32 = torch.where(m32 - pk("Chan2M3Start") < 0.0, pk("Chan2M3Start"), m32)
            q2 = (m32 * inv_dx * inv_alpha2) ** (1 / beta)
            chan_q = torch.clamp_min(q1 + q2 - pk("QLimit"), 0.0)
            c.update(ChanQKin=q1, ChanM3Kin=m31, Chan2QKin=q2, Chan2M3Kin=m32,
                     CrossSection2Area=(m32 - pk("Chan2M3Start")) * inv_dx,
                     Sideflow1Chan=sideflow1, ChanQ=chan_q, sumDisDay=c["sumDisDay"] + chan_q)

    carry = {k: unpack(v) for k, v in c.items()}
    carry.update({STRUCTURE_CARRY[k]: v for k, v in ys.items()})
    return _post_routing(cfg, p, s, d, carry, dtype)


def kernel_operands(cfg, p, s, d, routers):
    """(SubstepSpec, operands) of the sub-step loop (ops/kinwave_substep.py),
    from the packed state and the step's diagnostics. Counterpart of the JAX
    package's pallas_operands."""
    kin = routers["kin"]
    ps = kin.ps
    pk = lambda name: p["kinp$" + name]
    spk = lambda k: s["pk$" + k]
    n, C = ps.n_chunks, ps.chunk
    split = cfg.split
    dtype = spk("ChanQKin").dtype
    c2 = lambda x: x.reshape(n, C)
    # the land phase's per-pixel inputs of the loop, packed together (a rank
    # takes its halo's from their owners there)
    rows = {"ToChan": d["ToChanM3RunoffDt"]}
    if "EvaUpstream0" in d:
        rows["ev_up0"] = d["EvaUpstream0"]
    elif cfg.open_water_evapo:
        rows["eva"] = d["EvaAddM3Dt"]
    if cfg.water_use:
        rows["withdrawal"] = d["withdrawal_CH_actual_M3_routStep"]
        rows["returnflow"] = d["returnflow_GwAbs2Channel_M3_routStep"]
    if cfg.inflow:
        rows["qin_old"], rows["qdelta"] = d["QInM3OldLoop"], d["QDelta"]
    packed = dict(zip(rows, kin.pack_rows(list(rows.values()))))
    xs = {
        "ToChan": c2(packed["ToChan"]),
        "dx": c2(pk("ChanLength")),
        "adx1": c2(pk("ChannelAlpha") * pk("ChanLength") / cfg.dt_routing),
        "alpha1": c2(pk("ChannelAlpha")),
        "ischan": c2(pk("IsChannelKinematic").to(dtype)),
        "q1_0": c2(spk("ChanQKin")),
        "m31_0": c2(spk("ChanM3Kin")),
        "chanq_0": c2(spk("ChanQ")),
        "ups": pk("UpsTable"),
    }
    if split:
        xs.update({
            "adx2": c2(pk("ChannelAlpha2") * pk("ChanLength") / cfg.dt_routing),
            "alpha2": c2(pk("ChannelAlpha2")),
            "qlimit": c2(pk("QLimit")),
            "m3limit": c2(pk("M3Limit")),
            "chan2m3start": c2(pk("Chan2M3Start")),
            "chan2qstart": c2(pk("Chan2QStart")),
            "q2_0": c2(spk("Chan2QKin")),
            "m32_0": c2(spk("Chan2M3Kin")),
        })
    E = 0
    if "EvaUpstream0" in d:
        # the whole evaporation chain runs in the kernel, its transfers over
        # the evaporation graph's upstream table
        E = int(cfg.max_no_eva)
        xs["ev_up0"] = c2(packed["ev_up0"])
        xs["ev_ups"] = pk("EvaUpsTable")
    elif cfg.open_water_evapo:
        # the chain ran outside (physics.evapowater_step)
        xs["eva"] = c2(packed["eva"])
    if cfg.water_use:
        xs["wuse"] = c2(packed["withdrawal"] - packed["returnflow"])
    if cfg.inflow:
        xs["qin_old"] = c2(packed["qin_old"])
        xs["qdelta"] = c2(packed["qdelta"])
    if cfg.trans_loss:
        xs["uptrans"] = c2(pk("UpTrans").to(dtype))
        xs["tp1"] = c2(pk("TransPower1"))
        xs["tp2"] = c2(pk("TransPower2"))
        xs["tsub"] = c2(pk("TransSub"))
    # structure inflow at the start of the step: the previous sub-step's
    # discharge of its <=8 feeders (pre-cut graph); the structures are those
    # on the router's lanes (a rank's: those on its kept lanes)
    buf0 = lambda name: (spk("ChanQ")[pk(name + "UpsIdx")] * pk(name + "UpsW")).sum(1)
    xs.update({k: kin.structures(k[:2], v) for k, v in structure_params(cfg, p).items()})
    if cfg.lakes:
        lk = lambda key: kin.structures("lk", s[key])
        xs.update({
            "lk_pos": pk("LakePos"), "lk_fee": pk("LakeFee"), "lk_fee_w": pk("LakeUpsW"),
            "lk_st0": lk("LakeStorageM3CC"), "lk_inold0": lk("LakeInflowOldCC"),
            "lk_out0": lk("LakeOutflowCC"), "lk_bal0": lk("LakeStorageM3BalanceCC"),
            "lk_buf0": buf0("Lake"),
        })
    if cfg.reservoirs:
        xs.update({
            "rs_pos": pk("ResPos"), "rs_fee": pk("ResFee"), "rs_fee_w": pk("ResUpsW"),
            "rs_st0": kin.structures("rs", s["ReservoirStorageM3CC"]),
            "rs_fill0": kin.structures("rs", s["ReservoirFillCC"]),
            "rs_buf0": buf0("Res"),
        })
    # the kernel's dependency tables (the plain version does not read them)
    xs.update({k: pk(k) for k in WAVEFRONT_TABLES})
    spec = SubstepSpec(n_chunks=n, chunk=C, window=ps.window, T=cfg.no_rout_steps,
                       dt_routing=cfg.dt_routing, beta=float(p["Beta"]),
                       split=split, E=E)
    return spec, {k: v.contiguous() for k, v in xs.items()}


def channel_routing_kernel(cfg, p, s, d, routers):
    """The NoRoutSteps sub-step loop with lakes, reservoirs, the open-water
    evaporation chain and the optional sideflow terms, on the sub-step kernel
    (counterpart of the JAX package's channel_routing_pallas); returns
    end-of-step state and diagnostics. The routing state stays
    schedule-packed across steps."""
    kin = routers["kin"]
    T = cfg.no_rout_steps
    spec, xs = kernel_operands(cfg, p, s, d, routers)
    ys = kin.structure_state(kinwave_substep(spec, xs))

    flat = lambda name: ys[name].reshape(-1)
    carry = {"ChanQKin": flat("q1"), "ChanM3Kin": flat("m31"),
             "ChanQ": flat("chanq"), "sumDisDay": flat("sumdis")}
    if spec.split:
        carry.update({"Chan2QKin": flat("q2"), "Chan2M3Kin": flat("m32"),
                      "CrossSection2Area": flat("cross2"), "Sideflow1Chan": flat("side1")})
    if cfg.trans_loss:
        carry["TransCum"] = s["pk$TransCum"] + flat("trans")
    natural = {}     # carry entries that are in natural pixel space already
    if cfg.inflow:
        # closed form of the per-sub-step ramp sum (inflow.py:145-147)
        natural["QinADDEDM3"] = d["QInM3OldLoop"] + d["QDelta"] * (T + 1) / 2.0
    if cfg.rep_mbts:
        # AddedTRUN is linear in the per-sub-step terms: one catchment total
        ct = lambda v: segment_spread(v, p["seg$Catchments"])
        added = T * ct(d["ToChanM3RunoffDt"])
        if cfg.inflow:
            added = added + ct(natural["QinADDEDM3"])
        if cfg.open_water_evapo:
            eva_dt = kin.unpack(flat("ev_add")) / T if spec.E else d["EvaAddM3Dt"]
            added = added - T * ct(eva_dt)
        if cfg.water_use:
            added = added - T * ct(d["withdrawal_CH_actual_M3_routStep"]
                                   - d["returnflow_GwAbs2Channel_M3_routStep"])
        natural["AddedTRUN"] = added
    carry.update({STRUCTURE_CARRY[k]: v for k, v in ys.items() if k in STRUCTURE_CARRY})
    out = _post_routing_packed(cfg, p, s, d, carry, routers, natural)
    if spec.E:
        eva_p = flat("ev_add")
        eva_nat = kin.unpack(eva_p)
        out["EvaAddM3"] = eva_nat
        out["EvaAddM3Dt"] = eva_nat / T
        out["EvaWBM3"] = eva_nat
        out["pk$EvaCumM3"] = s["pk$EvaCumM3"] + eva_p
        out["EvaCumM3"] = kin.unpack(out["pk$EvaCumM3"])
    return out


def _post_routing(cfg, p, s, d, carry, dtype):
    """Post-sub-step-loop state and diagnostics in natural pixel space
    (Lisflood_dynamic.py:194-230, routing.py:645-706)."""
    P = cfg.num_pixels
    dx = p["ChanLength"]
    inv_dx = 1.0 / dx
    catchtotal = lambda x: segment_spread(x, p["seg$Catchments"])

    out = dict(carry)
    if cfg.inflow:
        # for the mass-balance module (Lisflood_dynamic.py:185-189)
        out["sumInWB"] = carry["QinADDEDM3"]
    if not cfg.split:
        chan_m3 = carry["ChanM3Kin"]
    else:
        chan_m3 = carry["ChanM3Kin"] + carry["Chan2M3Kin"] - p["Chan2M3Start"]
    out["ChanM3"] = chan_m3
    out["TotalCrossSectionArea"] = chan_m3 * inv_dx
    out["sumDis"] = s["sumDis"] + carry["sumDisDay"]
    out["ChanQAvg"] = carry["sumDisDay"] / cfg.no_rout_steps
    if cfg.init_lisflood or cfg.rep_average_dis:
        cum_q = s["CumQ"] + carry["ChanQ"]
        out["CumQ"] = cum_q
        out["avgdis"] = cum_q / d["TimeSinceStart"]
    out["DischargeM3Out"] = s["DischargeM3Out"] + torch.where(
        p["AtLastPointC"], carry["ChanQ"] * cfg.dt_sec, 0.0)

    # flow velocity diagnostic (routing.py:695-706)
    tcsa = torch.clamp_min(carry["ChanM3Kin"] * inv_dx, 0.01)
    velocity = torch.minimum(carry["ChanQKin"] / tcsa, 0.36 * carry["ChanQKin"] ** 0.24)
    velocity = velocity * torch.clamp_max(torch.sqrt(p["PixelArea"]) * inv_dx, 1)
    out["FlowVelocity"] = velocity
    out["TravelDistance"] = velocity * cfg.dt_sec

    # expand structure state to (P,) (lakes.py:280-297, reservoir.py:307-322)
    def expand(idx, cc):
        return place(torch.zeros(P, dtype=dtype, device=cc.device), idx, cc)

    if cfg.lakes:
        li = p["LakeIndex"]
        out["LakeStorageM3Balance"] = expand(li, carry["LakeStorageM3BalanceCC"])
        out["LakeStorageM3"] = expand(li, carry["LakeStorageM3CC"])
        out["LakeLevel"] = expand(li, carry["LakeLevelCC"])
        out["LakeInflowOld"] = expand(li, carry["LakeInflowOldCC"])
        out["LakeOutflow"] = expand(li, carry["LakeOutflowCC"])
        out["LakeInflowM3S"] = expand(li, carry["sumLakeInCC"] / cfg.dt_sec)
        out["LakeOutflowM3S"] = expand(li, carry["sumLakeOutCC"] / cfg.dt_sec)
    if cfg.reservoirs:
        ri = p["ReservoirIndex"]
        out["ReservoirStorageM3"] = expand(ri, carry["ReservoirStorageM3CC"])
        out["ReservoirFill"] = expand(ri, carry["ReservoirFillCC"])
        out["ReservoirInflowM3S"] = expand(ri, carry["sumResInCC"] / cfg.dt_sec)
        out["ReservoirOutflowM3S"] = expand(ri, carry["sumResOutCC"] / cfg.dt_sec)

    # split-routing mass balance (routing.py:645-691)
    if cfg.rep_mbts and cfg.split:
        sum1 = torch.where(p["AtLastPointC"], carry["sumDisDay"] / cfg.no_rout_steps, 0.0)
        out_step = catchtotal(sum1 * cfg.dt_sec)
        storage_step = carry["ChanM3Kin"] + carry["Chan2M3Kin"] - p["Chan2M3Start"]
        dis_structures = torch.zeros(P, dtype=dtype, device=dx.device)
        if cfg.reservoirs:
            storage_step = storage_step + out["ReservoirStorageM3"]
        if cfg.lakes:
            storage_step = storage_step + out["LakeStorageM3Balance"]
        if cfg.reservoirs or cfg.lakes:
            # water on its way into a structure at the end of the step
            dis_stru = torch.where(
                p["IsUpsOfStructureKinematicC"], carry["ChanQ"] * cfg.dt_routing, 0.0)
            if cfg.lakes:
                dis_stru = dis_stru + expand(p["LakeIndex"],
                                             0.5 * carry["LakeInflowCC"] * cfg.dt_routing)
            dis_structures = catchtotal(dis_stru) - s["DischargeM3StructuresIni"]
        storage_step1 = catchtotal(storage_step)
        mb_error = (-storage_step1 + s["StorageStepINIT"] - out_step - dis_structures
                    + carry["AddedTRUN"])
        out["MBErrorSplitRoutingM3"] = mb_error
        qout_corr = torch.where(p["AtLastPointC"], mb_error / cfg.dt_routing, 0.0)
        out["OutletDischargeErrorSplitRouting"] = catchtotal(qout_corr)
        out["StorageStepINIT"] = storage_step1 + dis_structures
    return out


def _post_routing_packed(cfg, p, s, d, carry_p, routers, carry_natural):
    """Packed-state epilogue: advances the pk$ routing state in position
    space and computes the natural-space diagnostics through _post_routing
    on unpacked views of `carry_p` and on `carry_natural` as it is."""
    kin = routers["kin"]
    p_pad = kin.ps.p_pad
    unpack = kin.unpack

    def view(v):
        return unpack(v) if v.dim() >= 1 and v.shape[-1] == p_pad else v

    carry_n = {k: view(v) for k, v in carry_p.items()}
    carry_n.update(carry_natural)
    s_n = dict(s)
    for key in ("sumDis", "CumQ", "avgdis", "DischargeM3Out", "TransCum"):
        if "pk$" + key in s:
            s_n[key] = unpack(s["pk$" + key])
    out = _post_routing(cfg, p, s_n, d, carry_n, carry_n["ChanQKin"].dtype)

    # the advancing state, in packed space (the same elementwise updates as
    # _post_routing's, in the permuted layout)
    for key in ("ChanQKin", "ChanM3Kin", "ChanQ", "Chan2QKin", "Chan2M3Kin",
                "CrossSection2Area", "Sideflow1Chan", "TransCum"):
        if key in carry_p:
            out["pk$" + key] = carry_p[key]
    out["pk$sumDis"] = s["pk$sumDis"] + carry_p["sumDisDay"]
    if cfg.init_lisflood or cfg.rep_average_dis:
        cum_q = s["pk$CumQ"] + carry_p["ChanQ"]
        out["pk$CumQ"] = cum_q
        out["pk$avgdis"] = cum_q / d["TimeSinceStart"]
    out["pk$DischargeM3Out"] = s["pk$DischargeM3Out"] + torch.where(
        p["kinp$AtLastPointC"], carry_p["ChanQ"] * cfg.dt_sec, 0.0)
    return out

"""Surface and channel routing of one model step — the port of
lisflood_tpu/ops/routing_ops.py (surface_routing.py:115-213,
routing.py:435-706, lakes.py:199-298, reservoir.py:173-323,
transmission.py:67-89, Lisflood_dynamic.py:176-230).

The port has one sub-step pipeline: the chunk-major loop of
ops/kinwave_substep.py, as the CUDA kernel on a CUDA device and as its plain
PyTorch version on the CPU. The JAX package's XLA formulations of the same
loop (the sequential scan and the chunk-major `channel_routing_pipelined`)
are schedules for XLA that the kernel replaces, and have no counterpart here.
"""
from __future__ import annotations

import torch

from .kinwave_packed import PackedRouter
from .kinwave_substep import WAVEFRONT_TABLES, SubstepSpec, kinwave_substep
from .physics import segment_spread


def surface_routing_step(cfg, p, s, d, routers):
    """Overland kinematic wave for 3 runoff lanes (surface_routing.py:115-213)."""
    soil_frac = p["SoilFraction"]
    surface_run_soil = soil_frac * torch.clamp_min(d["AvailableWaterForInfiltration"] - d["Infiltration"], 0)
    surface_runoff = d["DirectRunoff"] + surface_run_soil.sum(0)
    total_runoff = surface_runoff + d["UZOutflowPixel"] + d["LZOutflowToChannelPixel"]

    mmto_m3 = p["MMtoM3"]
    inv_pl = 1.0 / p["PixelLength"]
    inv_dt = 1.0 / cfg.dt_sec
    sideflow_direct = d["DirectRunoff"] * mmto_m3 * inv_pl * inv_dt
    sideflow_other = (surface_run_soil[0] + surface_run_soil[2]) * mmto_m3 * inv_pl * inv_dt
    sideflow_forest = surface_run_soil[1] * mmto_m3 * inv_pl * inv_dt

    beta = p["Beta"]
    # OFAlpha lanes [Other, Forest, Direct]; a_dx_div_dt = alpha * dx / dt
    dx = p["PixelLength"]
    adx = p["OFAlpha"] * dx / cfg.dt_sec
    q0 = torch.stack([s["OFQOther"], s["OFQForest"], s["OFQDirect"]])
    lat = torch.stack([sideflow_other, sideflow_forest, sideflow_direct]) * dx
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
    """Which implementation runs the sub-step loop: 'cuda' (the kernel) for
    a CUDA device, 'reference' (its plain PyTorch version) for the CPU, in
    float32 and float64 alike. Raises for a configuration the loop cannot
    take."""
    kin = routers["kin"]
    if not isinstance(kin, PackedRouter):
        raise NotImplementedError("the sub-step loop needs the packed router")
    structs = cfg.simulate_lakes or cfg.simulate_reservoirs
    if structs and not kin.struct_feeders_earlier:
        raise NotImplementedError(
            "a lake or reservoir is not chunked after all of its feeders; the "
            "sequential sub-step loop that serves such schedules is not ported")
    kind = torch.device(device).type
    if kind == "cuda":
        return "cuda"
    if kind == "cpu":
        return "reference"
    raise RuntimeError(f"no sub-step pipeline for device {kind!r}")


def kernel_operands(cfg, p, s, d, routers):
    """(SubstepSpec, operands) of the sub-step loop (ops/kinwave_substep.py),
    from the packed state and the step's diagnostics. Counterpart of the JAX
    package's pallas_operands."""
    kin = routers["kin"]
    ps = kin.ps
    pk = lambda name: p["kinp$" + name]
    spk = lambda k: s["pk$" + k]
    n, C = ps.n_chunks, ps.chunk
    split = cfg.split_routing
    dtype = spk("ChanQKin").dtype
    c2 = lambda x: x.reshape(n, C)
    xs = {
        "ToChan": c2(kin.pack(d["ToChanM3RunoffDt"])),
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
        xs["ev_up0"] = c2(kin.pack(d["EvaUpstream0"]))
        xs["ev_ups"] = pk("EvaUpsTable")
    elif cfg.open_water_evapo:
        # the chain ran outside (physics.evapowater_step)
        xs["eva"] = c2(kin.pack(d["EvaAddM3Dt"]))
    if cfg.water_use:
        xs["wuse"] = c2(kin.pack(d["withdrawal_CH_actual_M3_routStep"])
                        - kin.pack(d["returnflow_GwAbs2Channel_M3_routStep"]))
    if cfg.inflow:
        xs["qin_old"] = c2(kin.pack(d["QInM3OldLoop"]))
        xs["qdelta"] = c2(kin.pack(d["QDelta"]))
    if cfg.trans_loss:
        xs["uptrans"] = c2(pk("UpTrans").to(dtype))
        xs["tp1"] = c2(pk("TransPower1"))
        xs["tp2"] = c2(pk("TransPower2"))
        xs["tsub"] = c2(pk("TransSub"))
    # structure inflow at the start of the step: the previous sub-step's
    # discharge of its <=8 feeders (pre-cut graph)
    buf0 = lambda name: (spk("ChanQ")[pk(name + "UpsIdx")] * pk(name + "UpsW")).sum(1)
    if cfg.simulate_lakes:
        xs.update({
            "lk_pos": pk("LakePos"), "lk_fee": pk("LakeFee"), "lk_fee_w": pk("LakeUpsW"),
            "lk_factor": p["LakeFactor"], "lk_factorsqr": p["LakeFactorSqr"],
            "lk_area": p["LakeAreaCC"],
            "lk_st0": s["LakeStorageM3CC"], "lk_inold0": s["LakeInflowOldCC"],
            "lk_out0": s["LakeOutflowCC"], "lk_bal0": s["LakeStorageM3BalanceCC"],
            "lk_buf0": buf0("Lake"),
        })
    if cfg.simulate_reservoirs:
        xs.update({
            "rs_pos": pk("ResPos"), "rs_fee": pk("ResFee"), "rs_fee_w": pk("ResUpsW"),
            "rs_tot": p["TotalReservoirStorageM3CC"],
            "rs_cons": p["ConservativeStorageLimitCC"],
            "rs_norm": p["NormalStorageLimitCC"],
            "rs_flood": p["FloodStorageLimitCC"],
            "rs_nfl": p["Normal_FloodStorageLimitCC"],
            "rs_nondam": p["NonDamagingReservoirOutflowCC"],
            "rs_normout": p["NormalReservoirOutflowCC"],
            "rs_minout": p["MinReservoirOutflowCC"],
            "rs_do": p["DeltaO"], "rs_dln": p["DeltaLN"], "rs_dnfl": p["DeltaNFL"],
            "rs_st0": s["ReservoirStorageM3CC"], "rs_fill0": s["ReservoirFillCC"],
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
    ys = kinwave_substep(spec, xs)

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
        ct = lambda v: segment_spread(v, p["Catchments"], cfg.num_catchments)
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
    if "lk_pos" in xs:
        carry.update({
            "LakeStorageM3CC": ys["lk_st"], "LakeInflowOldCC": ys["lk_inold"],
            "LakeInflowCC": ys["lk_in"], "LakeOutflowCC": ys["lk_out"],
            "LakeStorageM3BalanceCC": ys["lk_bal"], "LakeLevelCC": ys["lk_level"],
            "sumLakeInCC": ys["lk_sumin"], "sumLakeOutCC": ys["lk_sumout"]})
    if "rs_pos" in xs:
        carry.update({
            "ReservoirStorageM3CC": ys["rs_st"], "ReservoirFillCC": ys["rs_fill"],
            "sumResInCC": ys["rs_sumin"], "sumResOutCC": ys["rs_sumout"]})
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
    catchtotal = lambda x: segment_spread(x, p["Catchments"], cfg.num_catchments)

    out = dict(carry)
    if cfg.inflow:
        # for the mass-balance module (Lisflood_dynamic.py:185-189)
        out["sumInWB"] = carry["QinADDEDM3"]
    if not cfg.split_routing:
        chan_m3 = carry["ChanM3Kin"]
    else:
        chan_m3 = carry["ChanM3Kin"] + carry["Chan2M3Kin"] - p["Chan2M3Start"]
    out["ChanM3"] = chan_m3
    out["TotalCrossSectionArea"] = chan_m3 * inv_dx
    out["sumDis"] = s["sumDis"] + carry["sumDisDay"]
    out["ChanQAvg"] = carry["sumDisDay"] / cfg.no_rout_steps
    if cfg.rep_average_dis:
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
        return torch.zeros(P, dtype=dtype, device=cc.device).index_copy_(0, idx, cc)

    if cfg.simulate_lakes:
        li = p["LakeIndex"]
        out["LakeStorageM3Balance"] = expand(li, carry["LakeStorageM3BalanceCC"])
        out["LakeStorageM3"] = expand(li, carry["LakeStorageM3CC"])
        out["LakeLevel"] = expand(li, carry["LakeLevelCC"])
        out["LakeInflowOld"] = expand(li, carry["LakeInflowOldCC"])
        out["LakeOutflow"] = expand(li, carry["LakeOutflowCC"])
        out["LakeInflowM3S"] = expand(li, carry["sumLakeInCC"] / cfg.dt_sec)
        out["LakeOutflowM3S"] = expand(li, carry["sumLakeOutCC"] / cfg.dt_sec)
    if cfg.simulate_reservoirs:
        ri = p["ReservoirIndex"]
        out["ReservoirStorageM3"] = expand(ri, carry["ReservoirStorageM3CC"])
        out["ReservoirFill"] = expand(ri, carry["ReservoirFillCC"])
        out["ReservoirInflowM3S"] = expand(ri, carry["sumResInCC"] / cfg.dt_sec)
        out["ReservoirOutflowM3S"] = expand(ri, carry["sumResOutCC"] / cfg.dt_sec)

    # split-routing mass balance (routing.py:645-691)
    if cfg.rep_mbts and cfg.split_routing:
        sum1 = torch.where(p["AtLastPointC"], carry["sumDisDay"] / cfg.no_rout_steps, 0.0)
        out_step = catchtotal(sum1 * cfg.dt_sec)
        storage_step = carry["ChanM3Kin"] + carry["Chan2M3Kin"] - p["Chan2M3Start"]
        dis_structures = torch.zeros(P, dtype=dtype, device=dx.device)
        if cfg.simulate_reservoirs:
            storage_step = storage_step + out["ReservoirStorageM3"]
        if cfg.simulate_lakes:
            storage_step = storage_step + out["LakeStorageM3Balance"]
        if cfg.simulate_reservoirs or cfg.simulate_lakes:
            # water on its way into a structure at the end of the step
            dis_stru = torch.where(
                p["IsUpsOfStructureKinematicC"], carry["ChanQ"] * cfg.dt_routing, 0.0)
            if cfg.simulate_lakes:
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
    if cfg.rep_average_dis:
        cum_q = s["pk$CumQ"] + carry_p["ChanQ"]
        out["pk$CumQ"] = cum_q
        out["pk$avgdis"] = cum_q / d["TimeSinceStart"]
    out["pk$DischargeM3Out"] = s["pk$DischargeM3Out"] + torch.where(
        p["kinp$AtLastPointC"], carry_p["ChanQ"] * cfg.dt_sec, 0.0)
    return out

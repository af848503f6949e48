"""Hydrological process functions on tensors — the port of
lisflood_tpu/ops/physics.py.

Each function reproduces one reference module's dynamic() semantics and
returns a dict of updated entries. Shapes: (P,) per pixel, (3, P) per
vegetation/landuse ([Rainfed/Other, Forest, Irrigated]).
"""
from __future__ import annotations

import torch

# per-segment totals in a fixed order (ops/segment_sum.py, K7 on the card):
# segment_spread(values, order) and scatter_to_downstream(values, order) take
# the step's SegmentOrder of the segment array (models/step.segment_orders)
from .segment_sum import scatter_to_downstream, segment_spread  # noqa: F401
# the soil's Courant tail (ops/soil_tail.py, K8 on the card)
from .soil_tail import soil_tail
from .soil_tail import unsat_conductivity as _unsat_conductivity


def take(x, idx):
    """x[idx] for an index into x's last axis; a rank's index of the
    multi-process step (parallel/shard_model.RankIndex) gathers the values
    from the ranks that own them."""
    return x[idx] if torch.is_tensor(idx) else idx.take(x)


def place(base, idx, vals):
    """base.index_copy_(0, idx, vals); a rank's index writes the entries its
    rank owns."""
    return base.index_copy_(0, idx.long(), vals) if torch.is_tensor(idx) else idx.place(base, vals)

# ---------------------------------------------------------------------------
# snow (snow.py:95-188)


def snow_step(cfg, p, s, f):
    lat_rad = p["lat_rad"]
    day = f["CalendarDay"]
    dt_day = cfg.dt_day
    hemisphere_n = lat_rad > 0
    snow_day_degrees = 360 / 365.25
    ice_day_degrees = 2 * snow_day_degrees
    snowmelt_coeff = torch.sin(torch.deg2rad((day - 81) * snow_day_degrees))
    seas_coef = p["SnowSeason"] * torch.where(hemisphere_n, snowmelt_coeff, -snowmelt_coeff) + p["SnowMeltCoef"]

    is_summer_n = (day > 165) & (day < 257)
    is_summer_s = (day > 347) | (day < 74)
    ice_coeff = torch.sin(torch.deg2rad((day - 165) * ice_day_degrees))
    summer_season = torch.where(hemisphere_n,
                                torch.where(is_summer_n, ice_coeff, 0.0),
                                torch.where(is_summer_s, ice_coeff, 0.0))

    precip = f["Precipitation"]
    tavg = f["Tavg"]
    cover = s["SnowCoverS"]
    new_cover = []
    snow = torch.zeros_like(precip)
    rain = torch.zeros_like(precip)
    melt = torch.zeros_like(precip)
    total_cover = torch.zeros_like(precip)
    for i in range(3):
        tavg_s = tavg + p["DeltaTSnow"] * (i - 1)
        snow_s = torch.where(tavg_s < p["TempSnow"], p["SnowFactor"] * precip, 0.0)
        rain_s = torch.where(tavg_s >= p["TempSnow"], precip, 0.0)
        melt_s = (tavg_s - p["TempMelt"]) * seas_coef * (1 + 0.01 * rain_s) * dt_day
        if i < 2:
            ice_melt = tavg * 7.0 * dt_day * summer_season
        else:
            ice_melt = tavg_s * 7.0 * dt_day * summer_season
        melt_s = torch.clamp_min(torch.minimum(melt_s + ice_melt, cover[i]), 0.0)
        cov_i = cover[i] + snow_s - melt_s
        new_cover.append(cov_i)
        snow = snow + snow_s
        rain = rain + rain_s
        melt = melt + melt_s
        total_cover = total_cover + cov_i
    snow = snow / 3
    rain = rain / 3
    melt = melt / 3
    total_cover = total_cover / 3
    return {
        "SnowCoverS": torch.stack(new_cover),
        "Snow": snow,
        "Rain": rain,
        "SnowMelt": melt,
        "SnowCover": total_cover,
        "TotalPrecipitation": s["TotalPrecipitation"] + snow + rain,
        "TotalPrecipitationWB": snow + rain,
    }


# ---------------------------------------------------------------------------
# frost (frost.py:61-93)


def frost_step(cfg, p, s, d):
    rate = -(1 - p["Afrost"]) * s["FrostIndex"] - d["Tavg"] * torch.exp(
        -0.04 * p["Kfrost"] * d["SnowCover"] / p["SnowWaterEquivalent"])
    fi = torch.clamp_min(s["FrostIndex"] + rate * cfg.dt_day, 0)
    fi = torch.where(fi > 57.0, 57.0, fi)
    return {"FrostIndex": fi, "isFrozenSoil": fi > p["FrostIndexThreshold"]}


# ---------------------------------------------------------------------------
# canopy: interception + Ta stress (soilloop.py:519-627, kernels 27-75)


def canopy_step(cfg, p, s, d):
    lai = d["LAI"]                       # (3, P)
    lai_term = torch.exp(-p["kgb"][None] * lai)
    rain = d["Rain"]
    one_minus_lai = 1.0 - lai_term
    ta_interception_max = d["EWRef"][None] * one_minus_lai

    # interception water balance (soilloop.py:27-70)
    cum = s["CumInterception"]
    smax = torch.where(lai <= 0.1, 0.0,
                       torch.where(lai <= 43.3, 0.935 + 0.498 * lai - 0.00575 * lai**2, 11.718))
    smax_pos = smax > 0
    interception = torch.where(
        smax_pos,
        torch.minimum(torch.minimum(smax - cum, smax * (1 - torch.exp(
            -0.046 * lai * rain[None] / torch.where(smax_pos, smax, 1.0)))), rain[None]),
        0.0)
    cum = torch.where(smax_pos, cum + interception, cum)
    has_cum = cum > 0
    ta_int = torch.where(has_cum, torch.clamp_min(torch.minimum(cum, ta_interception_max), 0.0), 0.0)
    cum2 = torch.clamp_min(cum - ta_int, 0.0)
    leaf_drainage = torch.where(has_cum, p["LeafDrainageK"] * cum2, 0.0)
    cum3 = torch.where(has_cum, torch.clamp_min(cum2 - leaf_drainage, 0.0), cum2)

    # potential transpiration (soilloop.py:73-75,546-559)
    transpir_max = p["CropCoef"] * d["ETRef"][None] * one_minus_lai
    potential_transpiration = torch.clamp_min(transpir_max - ta_int, 0)

    # soil water stress + actual transpiration (soilloop.py:564-627)
    w1a, w1b = s["W1a"], s["W1b"]
    w1 = w1a + w1b
    inv_dt_day = 1.0 / cfg.dt_day
    et_capped = torch.clamp_max(0.1 * d["ETRef"] * inv_dt_day, 1.0)
    swdf = 1 / (0.76 + 1.5 * et_capped[None]) - 0.10 * (5 - p["CropGroupNumber"])
    swdf = torch.where(p["CropGroupNumber"] <= 2.5,
                       swdf + (et_capped[None] - 0.6) / (p["CropGroupNumber"] * (p["CropGroupNumber"] + 3)),
                       swdf)
    swdf = torch.clamp(swdf, 0.0, 1.0)
    wcrit1 = (1 - swdf) * (p["WFC1"] - p["WWP1"]) + p["WWP1"]
    wcrit1a = (1 - swdf) * (p["WFC1a"] - p["WWP1a"]) + p["WWP1a"]
    wcrit1b = (1 - swdf) * (p["WFC1b"] - p["WWP1b"]) + p["WWP1b"]

    rws = torch.where(wcrit1 - p["WWP1"] > 0, (w1 - p["WWP1"]) / (wcrit1 - p["WWP1"]), 1.0)
    rws = torch.clamp(rws, 0.0, 1.0)
    transpirable = torch.clamp_min(w1 - p["WWP1"], 0)
    ta = torch.minimum(rws * potential_transpiration, transpirable)
    ta = torch.where(d["isFrozenSoil"][None], 0.0, ta)
    wc1a = torch.clamp_min(w1a - wcrit1a, 0)
    wc1b = torch.clamp_min(w1b - wcrit1b, 0)
    ta1a = torch.minimum(ta, wc1a)
    rest = torch.clamp_min(ta - ta1a, 0)
    ta1b = torch.minimum(rest, wc1b)
    rest = torch.clamp_min(rest - ta1b, 0)
    sa1a = torch.clamp_min(w1a - ta1a - p["WWP1a"], 0)
    sa1b = torch.clamp_min(w1b - ta1b - p["WWP1b"], 0)
    sa_tot = sa1a + sa1b
    avail = sa_tot > 0
    fr1a = torch.where(avail, sa1a / torch.where(avail, sa_tot, 1.0), 0.0)
    fr1b = torch.where(avail, sa1b / torch.where(avail, sa_tot, 1.0), 0.0)
    ta1a = ta1a + fr1a * rest
    ta1b = ta1b + fr1b * rest
    w1a = w1a - ta1a
    w1b = w1b - ta1b

    out = {
        "CumInterception": cum3,
        "Interception": interception,
        "TaInterception": ta_int,
        "LeafDrainage": leaf_drainage,
        "potential_transpiration": potential_transpiration,
        "RWS": rws,
        "Ta": ta,
        "W1a": w1a,
        "W1b": w1b,
        "LAITerm": lai_term,
    }
    # irrigation-layer fill levels needed by water abstraction
    # (soilloop.py:582-588, irrigated land use only)
    if cfg.water_use:
        out["WFilla"] = torch.minimum(wcrit1a[2], p["WPF3a"][2])
        out["WFillb"] = torch.minimum(wcrit1b[2], p["WPF3b"][2])
    return out


# ---------------------------------------------------------------------------
# soil column water balance (soilloop.py:78-356)


def soil_columns_step(cfg, p, s, d):
    dt_day = cfg.dt_day
    rain_plus_melt = d["Rain"] + d["SnowMelt"]
    w1a, w1b, w2 = s["W1a"], s["W1b"], s["W2"]
    dslr = s["DSLR"]
    frozen = d["isFrozenSoil"][None]

    avail_inf = torch.clamp_min(rain_plus_melt[None] + d["LeafDrainage"] - d["Interception"], 0.0)

    # bare soil evaporation (soilloop.py:137-162)
    dslr = torch.where(avail_inf > p["AvWaterThreshold"], 1.0, dslr + dt_day)
    es_max = d["ESRef"][None] * d["LAITerm"]
    es_act = es_max * (torch.sqrt(dslr) - torch.sqrt(dslr - 1))
    w1 = w1a + w1b
    es_act = torch.clamp_min(torch.minimum(es_act, w1 - p["WRes1"]), 0.0)
    supply1a = w1a - p["WRes1a"]
    es1a = torch.minimum(es_act, supply1a)
    es1b = torch.clamp_min(es_act - supply1a, 0.0)
    w1a_e = torch.maximum(w1a - es1a, p["WRes1a"])
    w1b_e = torch.maximum(w1b - es1b, p["WRes1b"])
    w1a = torch.where(frozen, w1a, w1a_e)
    w1b = torch.where(frozen, w1b, w1b_e)
    es_act = torch.where(frozen, 0.0, es_act)
    w1 = w1a + w1b

    # infiltration capacity (soilloop.py:164-211)
    rel_sat1 = torch.where(p["PoreSpaceNotZero1a"], torch.clamp_max(w1 / p["WS1"], 1.0), 0.0)
    sat_fraction = 1.0 - (1.0 - rel_sat1) ** p["b_Xinanjiang"][None]
    inf_pot = torch.where(frozen, 0.0,
                          p["StoreMaxPervious"] * (1 - sat_fraction) ** p["PowerInfPot"][None] * dt_day)
    pref_flow = (rel_sat1 ** p["PowerPrefFlow"][None]) * avail_inf
    avail_inf = avail_inf - pref_flow
    infiltration = torch.clamp_min(torch.minimum(avail_inf, inf_pot), 0.0)
    test_w1a = w1a + infiltration
    w1a = torch.minimum(p["WS1a"], test_w1a)
    w1b = w1b + torch.clamp_min(test_w1a - p["WS1a"], 0.0)

    # Darcy inter-layer seepage with per-pixel Courant sub-steps
    # (soilloop.py:213-321): sub-step 0 for the whole grid here, then
    # sub-steps 1..no_subs-1 of every lane in ops/soil_tail.py (K8 on the
    # card, one thread a lane; its plain version on the CPU)
    k1a0 = _unsat_conductivity(w1a, p["PoreSpaceNotZero1a"], p["WRes1a"], p["WS1a"], p["KSat1a"], p["GenuInvM1a"], p["GenuM1a"])
    k1b0 = _unsat_conductivity(w1b, p["PoreSpaceNotZero1b"], p["WRes1b"], p["WS1b"], p["KSat1b"], p["GenuInvM1b"], p["GenuM1b"])
    k20 = _unsat_conductivity(w2, p["PoreSpaceNotZero2"], p["WRes2"], p["WS2"], p["KSat2"], p["GenuInvM2"], p["GenuM2"])
    aw1a = w1a - p["WRes1a"]
    aw1b = w1b - p["WRes1b"]
    aw2 = w2 - p["WRes2"]
    courant_a = torch.where(aw1a == 0, 0.0, k1a0 * dt_day / torch.where(aw1a == 0, 1.0, aw1a))
    courant_b = torch.where(aw1b == 0, 0.0, k1b0 * dt_day / torch.where(aw1b == 0, 1.0, aw1b))
    courant_2 = torch.where(aw2 == 0, 0.0, k20 * dt_day / torch.where(aw2 == 0, 1.0, aw2))
    courant = torch.maximum(torch.maximum(courant_a, courant_b), courant_2)
    no_subs_raw = torch.clamp_min(torch.ceil(courant / p["CourantCrit"]), 1).to(torch.int32)
    no_subs = torch.clamp_max(no_subs_raw, cfg.max_soil_substeps)
    # the safety cap truncates the physics when it binds (a device flag,
    # read by the driver once per chunk of days)
    cap_hit = (no_subs_raw > cfg.max_soil_substeps).any()
    dt_sub = dt_day / no_subs.to(courant.dtype)
    cap1 = p["WS1b"] - w1b
    cap2 = p["WS2"] - w2

    # sub-step 0, whole grid (reuses the Courant conductivities)
    seep_a = torch.minimum(k1a0 * dt_sub, cap1)
    seep_b = torch.minimum(k1b0 * dt_sub, cap2)
    seep_gw = torch.minimum(k20 * dt_sub, aw2)
    aw1a_1 = aw1a - seep_a
    aw1b_1 = aw1b + seep_a - seep_b
    aw2_1 = aw2 + seep_b - seep_gw
    seep_a, seep_b, seep_gw = soil_tail((aw1a_1, aw1b_1, aw2_1), (seep_a, seep_b, seep_gw),
                                        no_subs, dt_sub, p)

    seep_a = torch.where(frozen, 0.0, seep_a)
    seep_b = torch.where(frozen, 0.0, seep_b)
    seep_gw = torch.where(frozen, 0.0, seep_gw)
    w1a = w1a - seep_a
    w1b = w1b + seep_a - seep_b
    w2 = w2 + seep_b - seep_gw
    infiltration = infiltration - torch.clamp_min(w1a - p["WS1a"], 0.0)
    w1a = torch.minimum(w1a, p["WS1a"])

    theta1a = torch.where(p["PoreSpaceNotZero1a"], w1a / torch.where(p["PoreSpaceNotZero1a"], p["SoilDepth1a"], 1.0), 0.0)
    theta1b = torch.where(p["PoreSpaceNotZero1b"], w1b / torch.where(p["PoreSpaceNotZero1b"], p["SoilDepth1b"], 1.0), 0.0)
    theta2 = torch.where(p["PoreSpaceNotZero2"], w2 / torch.where(p["PoreSpaceNotZero2"], p["SoilDepth2"], 1.0), 0.0)

    # upper zone transfer (soilloop.py:337-355)
    uz = s["UZ"]
    uz_outflow = torch.minimum(p["UpperZoneK"][None] * uz, uz)
    uz = torch.clamp_min(uz - uz_outflow, 0.0)
    if cfg.drained_irrigation:
        drained = p["DrainedFraction"]
        # [0, 0, 1] made on the device: a copy from the host would wait for
        # it, which a captured step refuses
        is_irrigated = (torch.arange(3, device=uz.device) == 2).to(uz.dtype)[:, None]
        uz_outflow = uz_outflow + is_irrigated * drained * seep_gw
        uz = uz + torch.where(is_irrigated > 0, (1 - drained) * seep_gw + pref_flow, seep_gw + pref_flow)
    else:
        uz = uz + seep_gw + pref_flow
    gw_perc_uzlz = torch.minimum(p["GwPercStep"][None], uz)
    uz = torch.clamp_min(uz - gw_perc_uzlz, 0.0)

    return {
        "W1a": w1a, "W1b": w1b, "W2": w2, "DSLR": dslr, "UZ": uz,
        "ESAct": es_act, "PrefFlow": pref_flow, "Infiltration": infiltration,
        "AvailableWaterForInfiltration": avail_inf,
        "SeepTopToSubA": seep_a, "SeepTopToSubB": seep_b, "SeepSubToGW": seep_gw,
        "Theta1a": theta1a, "Theta1b": theta1b, "Theta2": theta2,
        "UZOutflow": uz_outflow, "GwPercUZLZ": gw_perc_uzlz,
        "SoilCourantCapHit": cap_hit,
    }


# ---------------------------------------------------------------------------
# open water & sealed (opensealed.py:41-71)


def opensealed_step(cfg, p, s, d):
    rain_snowmelt = torch.clamp_min(d["Rain"] + d["SnowMelt"], 0.0)
    ewater_act = torch.clamp_min(torch.minimum(d["EWRef"], rain_snowmelt), 0.0)
    inter_sealed = torch.minimum(torch.clamp_min(p["SMaxSealed"] - s["CumInterSealed"], 0.0), rain_snowmelt)
    cum_sealed = s["CumInterSealed"] + inter_sealed
    ta_sealed = torch.clamp_min(torch.minimum(cum_sealed, d["EWRef"]), 0.0)
    cum_sealed = torch.clamp_min(cum_sealed - ta_sealed, 0.0)
    direct_runoff = d["DirectRunoffFraction"] * (rain_snowmelt - inter_sealed) + d["WaterFraction"] * (rain_snowmelt - ewater_act)
    return {
        "RainSnowmelt": rain_snowmelt,
        "EWaterAct": ewater_act,
        "CumInterSealed": cum_sealed,
        "TASealed": ta_sealed,
        "DirectRunoff": direct_runoff,
    }


# ---------------------------------------------------------------------------
# rice irrigation (riceirrigation.py:78-179)


def _with_row(x, i, row):
    """Copy of the (3, P) tensor `x` with row `i` replaced."""
    x = x.clone()
    x[i] = row
    return x


def _safe_div(num, den):
    """num / den where den > 0, else 0."""
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, 1.0), 0.0)


def rice_irrigation_step(cfg, p, s, d):
    day = d["CalendarDay"]
    ilanduse = 0  # Rainfed
    ws1 = p["WS1"][ilanduse]
    w1 = d["W1a"][ilanduse] + d["W1b"][ilanduse]
    mmto_m3 = p["MMtoM3"]
    dt_day = cfg.dt_day
    rice_frac = p["RiceFraction"]

    sat_demand = (ws1 - w1) * rice_frac * mmto_m3 * dt_day
    pl1, ha1 = p["RicePlantingDay1"], p["RiceHarvestDay1"]
    before = lambda day0, n: torch.where(day0 - n < 0, 365 + day0 - n, day0 - n)
    pl_20, pl_10 = before(pl1, 20), before(pl1, 10)
    ha_20, ha_10 = before(ha1, 20), before(ha1, 10)

    saturation = torch.where((day >= pl_20) & (day < pl_10), 0.1 * sat_demand, 0.0)
    rice_eva = torch.clamp_min(d["EWRef"] - (d["ESAct"][ilanduse] + d["Ta"][ilanduse]), 0)
    eva_demand = rice_eva * rice_frac * mmto_m3
    flooding_demand = p["RiceFlooding"] * rice_frac * mmto_m3 * dt_day
    flooding = torch.where((day >= pl_10) & (day < pl1), flooding_demand + eva_demand, 0.0)
    evaporation = torch.where((day >= pl1) & (day < ha_20), eva_demand, 0.0)
    perc_demand = p["RicePercolation"] * rice_frac * mmto_m3 * dt_day
    percolation = torch.where((day >= pl1) & (day < ha_20), perc_demand, 0.0)
    abstraction = saturation + flooding + evaporation + percolation

    drain_demand = (ws1 - p["WFC1"][ilanduse]) * rice_frac * mmto_m3 * dt_day
    drainage = torch.where((day >= ha_10) & (day < ha1), 0.1 * drain_demand, 0.0)

    soil_frac0 = p["SoilFraction"][ilanduse]
    uz = d["UZ"]
    uz0 = uz[ilanduse] + _safe_div((drainage + percolation) * p["M3toMM"], soil_frac0)
    return {"PaddyRiceWaterAbstractionFromSurfaceWaterM3": abstraction,
            "UZ": _with_row(uz, ilanduse, uz0)}


# ---------------------------------------------------------------------------
# water abstraction (waterabstraction.py:250-665)


def water_abstraction_step(cfg, p, s, d):
    mmto_m3 = p["MMtoM3"]
    m3to_mm = p["M3toMM"]
    regional = lambda x: segment_spread(x, p["seg$WUseRegionC"])
    zero = torch.zeros_like(d["Rain"])
    paddy = d["PaddyRiceWaterAbstractionFromSurfaceWaterM3"]

    dom_mm = d["DomesticDemandMM"]
    ind_mm = d["IndustrialDemandMM"]
    liv_mm = d["LivestockDemandMM"]
    ene_mm = d["EnergyDemandMM"]
    fgw = p["FractionGroundwaterUsed"]
    fnc = p["FractionNonConventionalWaterUsed"]
    fsw = p["FractionSurfaceWaterUseDomLivInd"]

    # livestock (waterabstraction.py:279-290)
    cons_req_liv = liv_mm * p["LivestockConsumptiveUseFraction"]
    cons_gw_liv = cons_req_liv * fgw
    cons_sw_liv = cons_req_liv * fsw
    abst_req_liv = liv_mm * mmto_m3
    abst_gw_liv = fgw * abst_req_liv
    abst_nc_liv = fnc * abst_req_liv
    abst_sw_liv = abst_req_liv - abst_gw_liv - abst_nc_liv

    # domestic (waterabstraction.py:292-305)
    dem_red_dom = dom_mm * p["DomesticWaterSavingConstant"]
    leak_dom = p["leak_demand_fraction"] * dem_red_dom
    abst_req_dom_mm = dem_red_dom + leak_dom
    abst_req_dom = abst_req_dom_mm * mmto_m3
    cons_req_dom = dem_red_dom * p["DomesticConsumptiveUseFraction"]
    cons_gw_dom = cons_req_dom * fgw
    cons_sw_dom = cons_req_dom * fsw
    abst_gw_dom = fgw * abst_req_dom
    abst_nc_dom = fnc * abst_req_dom
    abst_sw_dom = abst_req_dom - abst_gw_dom - abst_nc_dom

    # industry (waterabstraction.py:307-321)
    abst_req_ind = ind_mm * mmto_m3
    cons_req_ind = ind_mm * p["IndustryConsumptiveUseFraction"]
    cons_gw_ind = cons_req_ind * fgw
    cons_sw_ind = cons_req_ind * fsw
    abst_gw_ind = fgw * abst_req_ind
    abst_nc_ind = fnc * abst_req_ind
    abst_sw_ind = abst_req_ind - abst_gw_ind - abst_nc_ind

    # energy (waterabstraction.py:323-329)
    cons_req_ene = ene_mm * p["EnergyConsumptiveUseFraction"]
    abst_sw_ene = ene_mm * mmto_m3

    # irrigation (waterabstraction.py:331-354): recompute Ta on irrigated
    iveg = 2
    w1_irr = d["W1a"][iveg] + d["W1b"][iveg]
    ta_irr = torch.clamp_min(d["RWS"][iveg] * d["potential_transpiration"][iveg], 0.0)
    ta_irr = torch.clamp_min(torch.minimum(ta_irr, w1_irr - p["WWP1"][iveg]), 0.0)
    demand_irr_mm = (d["potential_transpiration"][iveg] - ta_irr) * p["SoilFraction"][iveg]
    demand_irr_mm = torch.where(d["isFrozenSoil"], 0.0, demand_irr_mm)
    cons_req_irr_mm = demand_irr_mm * p["IrrigationMult"]
    eff = p["IrrigationEfficiency"] * p["ConveyanceEfficiency"]
    abst_req_irr_mm = _safe_div(cons_req_irr_mm, eff)
    abst_req_irr = torch.clamp_min(abst_req_irr_mm * mmto_m3, 0.0)

    # treated waste-water reuse (waterabstraction.py:355-366)
    accum_reuse = torch.where(d["CalendarDay"] == 1, 0.0, s["ActualAccumulatedReUsedWaterM3"])
    avail_reuse = torch.minimum(
        torch.clamp_min(p["PotentialIrrigationWaterReUseM3Annual"] - accum_reuse, 0),
        p["PotentialIrrigationWaterReUseM3Daily"])
    abst_reuse_irr = torch.minimum(avail_reuse, abst_req_irr)
    accum_reuse = accum_reuse + abst_reuse_irr
    frac_swgw = 1.0 - _safe_div(abst_reuse_irr, abst_req_irr)
    abst_swgw_req_irr = frac_swgw * abst_req_irr
    cons_swgw_req_irr_mm = frac_swgw * cons_req_irr_mm

    gw_fed = p["GWfed_fraction_irrigation"]
    abst_gw_req_irr = gw_fed * abst_swgw_req_irr
    abst_sw_req_irr = torch.clamp_min(abst_swgw_req_irr - abst_gw_req_irr, 0)
    cons_gw_req_irr_mm = gw_fed * cons_req_irr_mm
    cons_sw_req_irr_mm = torch.clamp_min(cons_swgw_req_irr_mm - cons_gw_req_irr_mm, 0)
    abst_gw_act_irr = abst_gw_req_irr
    cons_gw_act_irr_mm = cons_gw_req_irr_mm

    # aggregation (waterabstraction.py:384-399)
    abst_all_req = abst_req_dom + abst_req_liv + abst_req_ind + abst_sw_ene + paddy + abst_req_irr
    abst_gw_noreturn = abst_gw_dom + abst_gw_liv + abst_gw_ind
    abst_sw_req = abst_sw_dom + abst_sw_liv + abst_sw_ind + abst_sw_ene + abst_sw_req_irr + paddy
    abst_swgw_req = abst_sw_req + abst_gw_req_irr + abst_gw_noreturn
    cons_gw_noreturn = (cons_gw_dom + cons_gw_liv + cons_gw_ind) * mmto_m3
    cons_sw_req_noreturn = (cons_sw_dom + cons_sw_liv + cons_sw_ind + cons_req_ene) * mmto_m3
    cons_swgw_req = ((cons_gw_req_irr_mm + cons_sw_req_irr_mm) * mmto_m3 + paddy
                     + cons_gw_noreturn + cons_sw_req_noreturn)
    withdrawal_sw_req = cons_sw_req_noreturn + abst_sw_req_irr + paddy
    areatotal_withdrawal_sw_req = regional(withdrawal_sw_req)
    is_sw_required = areatotal_withdrawal_sw_req > 0

    # groundwater abstraction (waterabstraction.py:401-411)
    abst_gw_actual = abst_gw_noreturn + abst_gw_act_irr
    lz = s["LZ"] - abst_gw_actual * m3to_mm
    irri_loss_cum = s["IrriLossCUM"] + abst_gw_actual
    returnflow_gw2chan_routstep = (abst_gw_noreturn - cons_gw_noreturn) / cfg.no_rout_steps

    # lakes and reservoirs abstraction (waterabstraction.py:418-467)
    dt_day = cfg.dt_day
    if cfg.reservoirs:
        pot_res = torch.minimum(0.02 * s["ReservoirStorageM3"],
                                0.01 * p["TotalReservoirStorageM3C"]) * dt_day
        pot_res = torch.where(torch.isnan(pot_res), 0.0, pot_res)
    else:
        pot_res = zero
    if cfg.lakes:
        pot_lake = 0.10 * s["LakeStorageM3"] * dt_day
        pot_lake = torch.where(torch.isnan(pot_lake), 0.0, pot_lake)
    else:
        pot_lake = zero
    pot_lakres = pot_lake + pot_res
    areatotal_pot_lakres = regional(pot_lakres)
    areatotal_lakres_req = p["FractionLakeReservoirWaterUsed"] * areatotal_withdrawal_sw_req
    areatotal_lakres_act = torch.minimum(areatotal_lakres_req, areatotal_pot_lakres)
    frac_by_lakres = torch.where(
        is_sw_required,
        areatotal_lakres_act / torch.where(is_sw_required, areatotal_withdrawal_sw_req, 1.0), 0.0)
    frac_emptying = _safe_div(areatotal_lakres_act, areatotal_pot_lakres)
    lake_abstraction = pot_lake * frac_emptying
    res_abstraction = pot_res * frac_emptying
    out = {}
    if cfg.lakes:
        out["LakeStorageM3"] = s["LakeStorageM3"] - lake_abstraction
        out["LakeStorageM3CC"] = s["LakeStorageM3CC"] - take(lake_abstraction, p["LakeIndex"])
    if cfg.reservoirs:
        out["ReservoirStorageM3"] = s["ReservoirStorageM3"] - res_abstraction
        out["ReservoirStorageM3CC"] = (s["ReservoirStorageM3CC"]
                                       - take(res_abstraction, p["ReservoirIndex"]))

    # channel withdrawal (waterabstraction.py:470-498)
    areatotal_ch_req = torch.clamp_min(areatotal_withdrawal_sw_req - areatotal_lakres_act, 0.0)
    pixel_avail_ch = torch.clamp_min(d["ChanM3Kin"] - p["EFlowThreshold"] * cfg.dt_sec, 0.0)
    areatotal_avail_ch = torch.clamp_min(regional(pixel_avail_ch), 0.0)
    areatotal_ch_act = torch.minimum(areatotal_avail_ch, areatotal_ch_req)
    frac_from_ch = torch.where(
        areatotal_avail_ch > 0,
        torch.clamp_max(areatotal_ch_act / torch.where(areatotal_avail_ch > 0, areatotal_avail_ch, 1.0), 1.0),
        0.0)
    withdrawal_ch_act = frac_from_ch * pixel_avail_ch
    withdrawal_ch_act_routstep = withdrawal_ch_act / cfg.no_rout_steps
    wateruse_cum = s["wateruseCum"] + withdrawal_ch_act
    areatotal_shortage_sw = torch.clamp_min(areatotal_ch_req - areatotal_ch_act, 0.0)
    withdrawal_sw_act = withdrawal_ch_act + lake_abstraction + res_abstraction

    # scarcity allocation (waterabstraction.py:508-547)
    abst_ch_req_irr = abst_sw_req_irr * (1 - frac_by_lakres)
    areatotal_abst_ch_req_irr = regional(abst_ch_req_irr)
    irrabs_minus_short = areatotal_abst_ch_req_irr - areatotal_shortage_sw
    areatotal_abst_ch_act_irr = torch.clamp_min(irrabs_minus_short, 0.0)
    frac_met_ch_irr = torch.clamp_max(
        _safe_div(areatotal_abst_ch_act_irr, areatotal_abst_ch_req_irr), 1.0)
    abst_ch_act_irr = abst_ch_req_irr * frac_met_ch_irr
    withdrawal_ch_req_noreturn = cons_sw_req_noreturn * (1 - frac_by_lakres)
    areatotal_wd_ch_req_noreturn = regional(withdrawal_ch_req_noreturn)
    areatotal_short_beyond_irr = torch.clamp_min(-irrabs_minus_short, 0.0)
    areatotal_wd_ch_act_noreturn = torch.clamp_min(
        areatotal_wd_ch_req_noreturn - areatotal_short_beyond_irr, 0.0)
    frac_met_ch_noreturn = torch.clamp_max(
        _safe_div(areatotal_wd_ch_act_noreturn, areatotal_wd_ch_req_noreturn), 1.0)
    cum_ch_withdrawal = s["cumulated_CH_withdrawal"] + withdrawal_ch_act

    # actual surface-water abstractions (waterabstraction.py:535-547)
    abst_sw_act_irr = abst_sw_req_irr * frac_by_lakres + abst_ch_act_irr
    frac_met_sw_irr = torch.clamp_max(frac_by_lakres + frac_met_ch_irr * (1 - frac_by_lakres), 1.0)
    frac_met_sw_noreturn = torch.clamp_max(
        frac_by_lakres + frac_met_ch_noreturn * (1 - frac_by_lakres), 1.0)

    # actual consumptions (waterabstraction.py:549-559)
    cons_act_irr_mm = cons_gw_act_irr_mm + cons_sw_req_irr_mm * frac_met_sw_irr
    cons_act_ene = cons_req_ene * frac_met_sw_noreturn
    cons_act_dom = cons_gw_dom + cons_sw_dom * frac_met_sw_noreturn
    cons_act_liv = cons_gw_liv + cons_sw_liv * frac_met_sw_noreturn
    cons_act_ind = cons_gw_ind + cons_sw_ind * frac_met_sw_noreturn
    cons_swgw_act = ((cons_act_irr_mm + cons_act_ene + cons_act_dom + cons_act_liv + cons_act_ind)
                     * mmto_m3 + paddy)

    # irrigation application to soil (waterabstraction.py:561-597)
    abst_swgw_act_irr = abst_sw_act_irr + abst_gw_act_irr
    irrigation_for_prescribed = torch.clamp_min(abst_swgw_act_irr, 0)
    soil_frac_irr = p["SoilFraction"][iveg]
    iwd = _safe_div(irrigation_for_prescribed * m3to_mm, soil_frac_irr)
    w1a_irr = d["W1a"][iveg]
    w1b_irr = d["W1b"][iveg]
    w_old = w1a_irr + w1b_irr
    wfilla = d["WFilla"]
    wfillb = d["WFillb"]
    iwd_b = torch.clamp_min(iwd - (wfilla - w1a_irr), 0)
    w1a_new = torch.where(w1a_irr >= wfilla, w1a_irr, torch.minimum(wfilla, w1a_irr + iwd))
    w1b_new = torch.where(w1b_irr >= wfillb, w1b_irr, torch.minimum(wfillb, w1b_irr + iwd_b))
    w_diff = (w1a_new + w1b_new) - w_old
    ta = _with_row(d["Ta"], iveg, ta_irr + iwd - w_diff)
    irri_loss_cum = (irri_loss_cum + irrigation_for_prescribed * p["efficiency_irrigation"]
                     - w_diff * mmto_m3 * soil_frac_irr)

    eflow_indicator = (d["ChanQ"] < p["EFlowThreshold"]).to(d["ChanQ"].dtype)

    out.update({
        "LZ": lz,
        "W1a": _with_row(d["W1a"], iveg, w1a_new),
        "W1b": _with_row(d["W1b"], iveg, w1b_new),
        "Ta": ta,
        # irrigated thetas (waterabstraction.py:655-664)
        "Theta1a": _with_row(d["Theta1a"], iveg, w1a_new / p["SoilDepth1a"][iveg]),
        "Theta1b": _with_row(d["Theta1b"], iveg, w1b_new / p["SoilDepth1b"][iveg]),
        "ActualAccumulatedReUsedWaterM3": accum_reuse,
        "IrriLossCUM": irri_loss_cum,
        "wateruseCum": wateruse_cum,
        "cumulated_CH_withdrawal": cum_ch_withdrawal,
        "withdrawal_CH_actual_M3": withdrawal_ch_act,
        "withdrawal_CH_actual_M3_routStep": withdrawal_ch_act_routstep,
        "returnflow_GwAbs2Channel_M3_routStep": returnflow_gw2chan_routstep,
        "abstraction_GW_actual_M3": abst_gw_actual,
        "abstraction_allSources_required_M3": abst_all_req,
        "abstraction_SW_required_M3": abst_sw_req,
        "abstraction_SwGw_required_M3": abst_swgw_req,
        "consumption_SwGw_required_M3": cons_swgw_req,
        "consumption_SwGw_actual_M3": cons_swgw_act,
        "areatotal_shortage_SW_M3": areatotal_shortage_sw,
        "areatotal_withdrawal_LakRes_actual_M3": areatotal_lakres_act,
        "areatotal_withdrawal_SW_actual_M3": regional(withdrawal_sw_act),
        "LakeAbstractionM3": lake_abstraction,
        "ReservoirAbstractionM3": res_abstraction,
        "EFlowIndicator": eflow_indicator,
        "abstraction_SwGw_actual_irrigation_M3": abst_swgw_act_irr,
        "abstraction_Reuse_irrigation_M3": abst_reuse_irr,
    })
    if cfg.rep_water_use:
        # per-sector per-step terms of the monthly accounting
        # (waterabstraction.py:631-646)
        out.update({
            "consumption_required_domestic_MM": cons_sw_dom + cons_gw_dom,
            "consumption_required_energy_MM": cons_req_ene,
            "consumption_required_industry_MM": cons_sw_ind + cons_gw_ind,
            "consumption_required_livestock_MM": cons_sw_liv + cons_gw_liv,
            "consumption_SwGw_required_irrigation_MM": cons_gw_req_irr_mm + cons_sw_req_irr_mm,
            "consumption_actual_irrigation_MM": cons_act_irr_mm,
            "abstraction_required_irrigation_M3": abst_req_irr,
            "abstraction_SwGw_required_irrigation_M3": abst_swgw_req_irr,
        })
    return out


# ---------------------------------------------------------------------------
# per-pixel aggregation (soil.py:471-514)


def soil_perpixel_step(cfg, p, s, d):
    soil_frac = p["SoilFraction"]
    veg_sum = lambda x: (soil_frac * x).sum(0)
    ta_interception_all = veg_sum(d["TaInterception"]) + p["DirectRunoffFraction"] * d["TASealed"]
    ta_pixel = veg_sum(d["Ta"])
    es_act_pixel = veg_sum(d["ESAct"]) + d["WaterFraction"] * d["EWaterAct"]
    tot_sm = d["W1a"] + d["W1b"] + d["W2"]
    theta = soil_frac * tot_sm / p["SoilDepthTotal"]
    frac_sum = soil_frac.sum(0)
    theta_all = torch.where(frac_sum > 0, theta.sum(0) / torch.where(frac_sum > 0, frac_sum, 1.0), 0.0)
    return {
        "TaInterceptionAll": ta_interception_all,
        "TaInterceptionCUM": s["TaInterceptionCUM"] + ta_interception_all,
        "TaInterceptionWB": ta_interception_all,
        "TaPixel": ta_pixel,
        "TaCUM": s["TaCUM"] + ta_pixel,
        "TaWB": ta_pixel,
        "ESActPixel": es_act_pixel,
        "ESActCUM": s["ESActCUM"] + es_act_pixel,
        "ESActWB": es_act_pixel,
        "PrefFlowPixel": veg_sum(d["PrefFlow"]),
        "InfiltrationPixel": veg_sum(d["Infiltration"]),
        "Theta": theta,
        "ThetaAll": theta_all,
        "SeepTopToSubPixelA": veg_sum(d["SeepTopToSubA"]),
        "SeepTopToSubPixelB": veg_sum(d["SeepTopToSubB"]),
        "SeepSubToGWPixel": veg_sum(d["SeepSubToGW"]),
        "Theta1aPixel": veg_sum(d["Theta1a"]),
        "Theta1bPixel": veg_sum(d["Theta1b"]),
        "Theta2Pixel": veg_sum(d["Theta2"]),
    }


# ---------------------------------------------------------------------------
# groundwater (groundwater.py:134-181)


def groundwater_step(cfg, p, s, d):
    lz = d["LZ"] if "LZ" in d else s["LZ"]
    lz_outflow = torch.minimum(p["LowerZoneK"] * lz, lz - p["LZThreshold"])
    lz_outflow = torch.clamp_min(lz_outflow, 0)
    lz = lz - lz_outflow
    soil_frac = p["SoilFraction"]
    uz_outflow_pixel = (soil_frac * d["UZOutflow"]).sum(0)
    gw_perc_pixel = (soil_frac * d["GwPercUZLZ"]).sum(0)
    lz = lz + gw_perc_pixel
    gw_loss_lz = torch.clamp_min(torch.minimum(p["GwLossStep"], lz), 0.0)
    lz = lz - gw_loss_lz
    lz_inflow_cum = torch.clamp_min(s["LZInflowCUM"] + gw_perc_pixel - gw_loss_lz, 0.0)
    lz_av_inflow = (lz_inflow_cum / cfg.dt_day) / d["TimeSinceStart"]
    return {
        "LZ": lz,
        "LZOutflow": lz_outflow,
        "LZOutflowToChannel": lz_outflow,
        "LZOutflowToChannelPixel": lz_outflow,
        "UZOutflowPixel": uz_outflow_pixel,
        "GwPercUZLZPixel": gw_perc_pixel,
        "GwLossPixel": gw_loss_lz,
        "GwLossWB": gw_loss_lz,
        "GwLossCUM": s["GwLossCUM"] + gw_loss_lz,
        "LZInflowCUM": lz_inflow_cum,
        "LZAvInflow": lz_av_inflow,
    }


# ---------------------------------------------------------------------------
# open-water evaporation: variable water fraction (evapowater.py:96-121)


def evapowater_init_step(cfg, p, s, d):
    """Variable water fraction (evapowater.py:96-121). The evaporation chain
    itself runs inside the channel-routing kernel (ops/kinwave_substep.py)
    when its graph fits the schedule window, else in evapowater_step."""
    if not (cfg.open_water_evapo and cfg.var_fraction_water):
        return {
            "WaterFraction": p["WaterFraction"],
            "OtherFraction_dyn": p["OtherFraction"],
            "ForestFraction_dyn": p["ForestFraction"],
            "IrrigationFraction_dyn": p["IrrigationFraction"],
            "DirectRunoffFraction": p["DirectRunoffFraction"],
            "PermeableFraction": p["PermeableFraction"],
        }
    # a tensor index goes through index_select, which reads nothing back on
    # the host (indexing with a 0-d device tensor does)
    month = d["VarWMonth"]
    rel_water = (p["varW"].index_select(0, month.reshape(1)).squeeze(0)
                 if torch.is_tensor(month) else p["varW"][month])
    var_water = rel_water * p["diffmaxwater"]
    water = p["WaterFraction"] + var_water
    other = torch.clamp_min(p["OtherFraction"] - var_water, 0)
    rest = torch.clamp_min(var_water - p["OtherFraction"], 0)
    forest = torch.clamp_min(p["ForestFraction"] - rest, 0)
    rest = torch.clamp_min(rest - p["ForestFraction"], 0)
    irrig = torch.clamp_min(p["IrrigationFraction"] - rest, 0)
    rest = torch.clamp_min(rest - p["IrrigationFraction"], 0)
    direct = torch.clamp_min(p["DirectRunoffFraction"] - rest, 0)
    return {
        "WaterFraction": water,
        "OtherFraction_dyn": other,
        "ForestFraction_dyn": forest,
        "IrrigationFraction_dyn": irrig,
        "DirectRunoffFraction": direct,
        "PermeableFraction": 1 - direct - water,
    }


# LDD keypad code -> (row shift, col shift), as in graph/ldd.py
_LDD_OFFSETS = {1: (1, -1), 2: (1, 0), 3: (1, 1), 4: (0, -1),
                6: (0, 1), 7: (-1, -1), 8: (-1, 0), 9: (-1, 1)}


def _shift2d(m, dr, dc):
    """m shifted so that out[r + dr, c + dc] = m[r, c] (zeros flow in)."""
    R, C = m.shape
    padded = torch.nn.functional.pad(m, (max(dc, 0), max(-dc, 0), max(dr, 0), max(-dr, 0)))
    return padded[max(-dr, 0):max(-dr, 0) + R, max(-dc, 0):max(-dc, 0) + C]


def scatter_down_stencil(x, codes2d, land_idx, nrows, ncols):
    """scatter_to_downstream as a 2-D LDD stencil: decompress, 8 masked
    shifted adds, compress. Equal to the scatter up to the order of the
    additions at cells with several upstream neighbours; unlike the atomic
    scatter its order is fixed, so two runs on the card agree bitwise. A
    rank of the multi-process step (`land_idx` a parallel/shard_model.
    GridIndex) runs it on the gathered grid and keeps its own pixels."""
    if not torch.is_tensor(land_idx):
        space = land_idx.space
        return space.own_of(scatter_down_stencil(space.gather(x), codes2d, land_idx.index,
                                                 nrows, ncols))
    g = x.new_zeros(nrows * ncols).index_copy_(0, land_idx, x).reshape(nrows, ncols)
    cd = codes2d.reshape(nrows, ncols)
    out = torch.zeros_like(g)
    for code, (dr, dc) in _LDD_OFFSETS.items():
        out = out + _shift2d(g * (cd == code), dr, dc)
    return out.reshape(-1)[land_idx]


def eva_uses_stencil(cfg, p, device):
    """Whether evapowater_step moves water down by the 2-D stencil (else by
    scatter_to_downstream over downEva)."""
    return bool(cfg.use_eva_stencil(device) and "evaDir2D" in p and cfg.grid_rows
                and cfg.grid_cols)


def evapowater_step(cfg, p, s, d):
    """Open-water evaporation moved downstream (evapowater.py:123-159), outside
    the routing kernel: the path of schedules whose evaporation edges leave
    the kernel's window."""
    upstream_eva = d["EWRef"] * p["MMtoM3"] * d["WaterFraction"]
    if eva_uses_stencil(cfg, p, upstream_eva.device):
        move_down = lambda x: scatter_down_stencil(
            x, p["evaDir2D"], p["landIdx"], cfg.grid_rows, cfg.grid_cols)
    else:
        move_down = lambda x: scatter_to_downstream(x, p["seg$downEva"])
    chan_m_iter = d["ChanM3Kin"]
    chan_left = chan_m_iter * 0.1
    eva_add = torch.zeros_like(upstream_eva)
    for _ in range(cfg.max_no_eva):
        chan_help = torch.maximum(chan_m_iter - upstream_eva, chan_left)
        eva_iter = torch.clamp_min(upstream_eva - (chan_m_iter - chan_help), 0)
        chan_m_iter = chan_help
        eva_add = eva_add + upstream_eva - eva_iter
        upstream_eva = move_down(eva_iter)
    return {
        "EvaAddM3": eva_add,
        "EvaAddM3Dt": eva_add / cfg.no_rout_steps,
        "EvaCumM3": s["EvaCumM3"] + eva_add,
        "EvaWBM3": eva_add,
    }


# ---------------------------------------------------------------------------
# water level (waterlevel.py:49-77)


def waterlevel_step(cfg, p, s, d):
    chan_csa = torch.where(
        p["IsChannelKinematic"],
        torch.minimum(d["TotalCrossSectionArea"], p["TotalCrossSectionAreaBankFull"]), 0.0)
    floodplain_csa = d["TotalCrossSectionArea"] - chan_csa
    chan_depth = 2 * chan_csa / (p["ChanUpperWidth"] + p["ChanBottomWidth"])
    floodplain_depth = floodplain_csa / p["FloodPlainWidth"]
    level = chan_depth + floodplain_depth
    return {"WaterLevel": torch.where(p["IsChannelKinematic"], level, 0.0)}


# ---------------------------------------------------------------------------
# pF soil-suction diagnostics (soilloop.py:673-704)


def pf_step(cfg, p, d):
    """Capillary pressure head per soil layer from the van Genuchten
    inversion; pF = log10(head[cm]), -1 where the head is zero. The (3, P)
    soil parameters broadcast against the (3, P) moisture states."""

    def pf(w, psnz, wres, ws, inv_alpha, inv_m, inv_n):
        sat = torch.where(psnz, torch.clamp((w - wres) / (ws - wres), 0.0, 1.0), 0.0)
        head_raw = inv_alpha * ((1.0 / torch.clamp_min(sat, 1e-30)) ** inv_m - 1.0) ** inv_n
        head = torch.where(sat == 0, p["HeadMax"], torch.clamp_max(head_raw, p["HeadMax"]))
        return torch.where(head > 0, torch.log10(torch.clamp_min(head, 1e-30)), -1.0)

    return {
        "pF0": pf(d["W1a"], p["PoreSpaceNotZero1a"], p["WRes1a"], p["WS1a"],
                  p["GenuInvAlpha1a"], p["GenuInvM1a"], p["GenuInvN1a"]),
        "pF1": pf(d["W1b"], p["PoreSpaceNotZero1b"], p["WRes1b"], p["WS1b"],
                  p["GenuInvAlpha1b"], p["GenuInvM1b"], p["GenuInvN1b"]),
        "pF2": pf(d["W2"], p["PoreSpaceNotZero2"], p["WRes2"], p["WS2"],
                  p["GenuInvAlpha2"], p["GenuInvM2"], p["GenuInvN2"]),
    }

"""The plain reference's land phase: meteo, snow, frost, canopy, soil,
open and sealed surfaces, groundwater and the open-water evaporation chain.

A frozen copy of the process functions of lisflood_tpu_torch/ops/physics.py
and of the plain soil tail of ops/soil_tail.py (commit c77b93b), trimmed to
the options the benchmark's configurations run (no water use, rice, pF,
variable water fraction or drained irrigation). Plain PyTorch on any device
and in any floating type; nothing here imports the program. Shapes: (P,) a
pixel, (3, P) a land use ([Rainfed/Other, Forest, Irrigated]).
"""
from __future__ import annotations

import torch


def scatter_to_downstream(values, down):
    """Each value moved to its downstream pixel (`down`, P at a pit, where
    it leaves the grid): np.bincount(down, values)[:P]."""
    P = values.shape[-1]
    out = values.new_zeros(P + 1)
    return out.index_add_(0, down, values)[:P]


FLOAT_KEYS = ("WRes1a", "WRes1b", "WRes2", "WS1a", "WS1b", "WS2",
              "KSat1a", "KSat1b", "KSat2", "GenuInvM1a", "GenuInvM1b",
              "GenuInvM2", "GenuM1a", "GenuM1b", "GenuM2")


MASK_KEYS = ("PoreSpaceNotZero1a", "PoreSpaceNotZero1b", "PoreSpaceNotZero2")


SOIL_KEYS = FLOAT_KEYS + MASK_KEYS


def unsat_conductivity(w, psnz, wres, ws, ksat, inv_m, m):
    """Van Genuchten unsaturated conductivity of a layer from its storage
    `w` (soilloop.py): ksat sqrt(sat) (1 - (1 - sat^(1/m))^m)^2."""
    sat = torch.where(psnz, torch.clamp((w - wres) / torch.where(psnz, ws - wres, 1.0), 0.0, 1.0), 0.0)
    return ksat * torch.sqrt(sat) * (1 - (1 - sat ** inv_m) ** m) ** 2


def soil_tail_reference(aw, seep, no_subs, dt_sub, q):
    """The plain version: `aw` the three layers' storage above the residual
    after sub-step 0, `seep` their seepage sums after it (updated in place
    and returned), `no_subs` (int32) and `dt_sub` each lane's count and
    sub-step length, `q` the parameters of SOIL_KEYS; all of one shape. The
    lanes with more than one sub-step are compacted and iterate together,
    a lane's update masked once its count is reached."""
    shape = no_subs.shape
    idx = torch.nonzero((no_subs > 1).reshape(-1)).squeeze(1)
    if not idx.numel():
        return seep
    g = lambda x: torch.broadcast_to(x, shape).reshape(-1)[idx]
    q = {k: g(q[k]) for k in SOIL_KEYS}
    ns_t, dtsub_t = g(no_subs), g(dt_sub)
    a1a, a1b, a2 = (g(x) for x in aw)
    sa, sb, sgw = (g(x) for x in seep)
    # caps recomputed from the current storage each sub-step, which equals
    # the explicit cap carry of soilloop.py
    for i in range(1, int(ns_t.max())):
        active = i < ns_t
        wt1a = a1a + q["WRes1a"]
        wt1b = a1b + q["WRes1b"]
        wt2 = a2 + q["WRes2"]
        k1a = unsat_conductivity(wt1a, q["PoreSpaceNotZero1a"], q["WRes1a"], q["WS1a"], q["KSat1a"], q["GenuInvM1a"], q["GenuM1a"])
        k1b = unsat_conductivity(wt1b, q["PoreSpaceNotZero1b"], q["WRes1b"], q["WS1b"], q["KSat1b"], q["GenuInvM1b"], q["GenuM1b"])
        k2 = unsat_conductivity(wt2, q["PoreSpaceNotZero2"], q["WRes2"], q["WS2"], q["KSat2"], q["GenuInvM2"], q["GenuM2"])
        s_a = torch.minimum(k1a * dtsub_t, q["WS1b"] - wt1b)
        s_b = torch.minimum(k1b * dtsub_t, q["WS2"] - wt2)
        s_g = torch.minimum(k2 * dtsub_t, a2)
        sel = lambda n, o: torch.where(active, n, o)
        a1a, a1b, a2 = sel(a1a - s_a, a1a), sel(a1b + s_a - s_b, a1b), sel(a2 + s_b - s_g, a2)
        sa, sb, sgw = sel(sa + s_a, sa), sel(sb + s_b, sb), sel(sgw + s_g, sgw)
    for full, comp in zip(seep, (sa, sb, sgw)):
        full.view(-1).index_copy_(0, idx, comp)
    return seep


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


def frost_step(cfg, p, s, d):
    rate = -(1 - p["Afrost"]) * s["FrostIndex"] - d["Tavg"] * torch.exp(
        -0.04 * p["Kfrost"] * d["SnowCover"] / p["SnowWaterEquivalent"])
    fi = torch.clamp_min(s["FrostIndex"] + rate * cfg.dt_day, 0)
    fi = torch.where(fi > 57.0, 57.0, fi)
    return {"FrostIndex": fi, "isFrozenSoil": fi > p["FrostIndexThreshold"]}


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
    return out


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
    # sub-steps 1..no_subs-1 of the lanes that have them
    k1a0 = unsat_conductivity(w1a, p["PoreSpaceNotZero1a"], p["WRes1a"], p["WS1a"], p["KSat1a"], p["GenuInvM1a"], p["GenuM1a"])
    k1b0 = unsat_conductivity(w1b, p["PoreSpaceNotZero1b"], p["WRes1b"], p["WS1b"], p["KSat1b"], p["GenuInvM1b"], p["GenuM1b"])
    k20 = unsat_conductivity(w2, p["PoreSpaceNotZero2"], p["WRes2"], p["WS2"], p["KSat2"], p["GenuInvM2"], p["GenuM2"])
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
    seep_a, seep_b, seep_gw = soil_tail_reference((aw1a_1, aw1b_1, aw2_1), (seep_a, seep_b, seep_gw),
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


def evapowater_init_step(cfg, p, s, d):
    """The land-use fractions of a step without a variable water fraction
    (evapowater.py:96-121)."""
    return {
        "WaterFraction": p["WaterFraction"],
        "OtherFraction_dyn": p["OtherFraction"],
        "ForestFraction_dyn": p["ForestFraction"],
        "IrrigationFraction_dyn": p["IrrigationFraction"],
        "DirectRunoffFraction": p["DirectRunoffFraction"],
        "PermeableFraction": p["PermeableFraction"],
    }


def evapowater_step(cfg, p, s, d):
    """Open-water evaporation moved downstream (evapowater.py:123-159), before
    the sub-step loop."""
    upstream_eva = d["EWRef"] * p["MMtoM3"] * d["WaterFraction"]
    move_down = lambda x: scatter_to_downstream(x, p["downEva"])
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



def land_phase(cfg, p, s, f):
    """The step up to the channel routing's loop, as the program's
    Step.land_phase runs it on the main path: the diagnostics namespace,
    seeded with the forcing. The evaporation chain is moved down before the
    loop (evapowater_step)."""
    d = dict(f)
    d["TimeSinceStart"] = s["TimeSinceStart"] + 1.0
    d["Precipitation"] = f["Precipitation"] * cfg.dt_day * p["PrScaling"]
    d["Tavg"] = f["Tavg"]
    d["ETRef"] = f["ETRef"] * cfg.dt_day * p["CalEvaporation"]
    d["EWRef"] = f["EWRef"] * cfg.dt_day * p["CalEvaporation"]
    d["ESRef"] = (d["EWRef"] + d["ETRef"]) / 2
    d["LAI"] = p["LAIX"][int(f["LAIInterval"])]
    d.update(evapowater_init_step(cfg, p, s, d))
    d.update(snow_step(cfg, p, s, d))
    d.update(frost_step(cfg, p, s, d))
    d.update(canopy_step(cfg, p, s, d))
    soil_in = dict(s)
    soil_in["W1a"], soil_in["W1b"] = d["W1a"], d["W1b"]
    d.update(soil_columns_step(cfg, p, soil_in, d))
    d.update(opensealed_step(cfg, p, s, d))
    d["PaddyRiceWaterAbstractionFromSurfaceWaterM3"] = torch.zeros_like(d["Rain"])
    d.update(soil_perpixel_step(cfg, p, s, d))
    d.update(groundwater_step(cfg, p, s, d))
    if cfg.open_water_evapo:
        eva_d = dict(d)
        eva_d["ChanM3Kin"] = s["ChanM3Kin"]
        d.update(evapowater_step(cfg, p, s, eva_d))
    return d

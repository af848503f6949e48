"""Water-security indicators and groundwater smoothing — the port of
lisflood_tpu/ops/indicators.py.

- `indicator_step`: monthly and annual Water Exploitation Indices (WEI-Dem,
  -Abs, -Cns, -Plus), Falkenmark per-capita figures, the dependency,
  sustainability and security indices, accumulated per water region
  (indicatorcalc.py:80-235). The reference computes the WEI family only at
  month end; like the JAX package the port computes it every step from the
  same running accumulators, which gives the same values at month end, and
  every one of those outputs is reported monthly (default_options.py:
  1152-1200).
- `groundwater_smooth`: LZ smoothing by a window average over groundwater
  bodies (waterabstraction.py:602-628), per ensemble member.
"""
from __future__ import annotations

import torch

from .physics import segment_spread

#: per-sector monthly accounting accumulators (repWaterUse,
#: waterabstraction.py:631-646 / indicatorcalc.py:218-235)
SECTORAL_MONTH_KEYS = (
    "consumption_required_domestic_MM_month",
    "consumption_required_energy_MM_month",
    "consumption_required_industry_MM_month",
    "consumption_required_livestock_MM_month",
    "consumption_required_irrigation_MM_month",
    "consumption_actual_irrigation_MM_month",
    "abstraction_allSources_required_irrigation_M3Month",
    "abstraction_allSources_actual_irrigation_M3Month",
    "abstraction_SwGw_required_irrigation_M3Month",
    "abstraction_SwGw_actual_irrigation_M3Month",
)

INDICATOR_KEYS_BASE = (
    "DayCounter", "MonthETpotMM", "MonthETactMM",
    "MonthAbstractionRequiredAllSourcesM3",
    "MonthAbstractionRequiredSurfaceGroundWaterM3",
    "MonthAbstractionRequiredSurfaceWaterM3",
    "MonthConsumptionActualM3", "MonthConsumptionRequiredM3",
    "MonthDisM3", "MonthInternalFlowM3",
    "RegionMonthIrrigationShortageM3",
    "MonthWaterAbstractedfromLakesReservoirsM3",
)


def indicator_keys(cfg):
    """Monthly-accumulator state keys for this configuration."""
    keys = list(INDICATOR_KEYS_BASE)
    if cfg.rep_water_use:
        keys += list(SECTORAL_MONTH_KEYS)
    return tuple(keys)


def indicator_state_zero(cfg, P, dtype, device=None):
    """Monthly accumulators reset to zero (indicatorcalc.py:201-235
    dynamic_setzero); DayCounter is a scalar."""
    z = torch.zeros(P, dtype=dtype, device=device)
    out = {k: z for k in indicator_keys(cfg)}
    out["DayCounter"] = torch.zeros((), dtype=dtype, device=device)
    return out


def indicator_step(cfg, p, s, d):
    """Monthly accumulation and the WEI / Falkenmark / regional outputs
    (indicatorcalc.py:80-198), line for line with the reference, its
    `/(X+1)` small-denominator guards (indicatorcalc.py:167-185) and the
    domestic M3MonthRegion sum that it leaves in mm (no MMtoM3 factor,
    indicatorcalc.py:219) included."""
    regional = lambda x: segment_spread(x, p["seg$WUseRegionC"])
    out = {}
    out["DayCounter"] = s["DayCounter"] + 1
    month_etpot = s["MonthETpotMM"] + d["ETRef"]
    month_etact = (s["MonthETactMM"] + (p["SoilFraction"] * d["TaInterception"]).sum(0)
                   + d["TaPixel"] + d["ESActPixel"])
    if cfg.open_water_evapo:
        month_etact = month_etact + d["EvaAddM3"] * p["M3toMM"]
    out["MonthETpotMM"] = month_etpot
    out["MonthETactMM"] = month_etact
    out["MonthETdifMM"] = torch.clamp_min((month_etpot - month_etact) * p["LandUseMask"], 0.0)

    acc = lambda key, term: s[key] + d[term]
    out["MonthAbstractionRequiredAllSourcesM3"] = acc(
        "MonthAbstractionRequiredAllSourcesM3", "abstraction_allSources_required_M3")
    out["MonthAbstractionRequiredSurfaceGroundWaterM3"] = acc(
        "MonthAbstractionRequiredSurfaceGroundWaterM3", "abstraction_SwGw_required_M3")
    out["MonthAbstractionRequiredSurfaceWaterM3"] = acc(
        "MonthAbstractionRequiredSurfaceWaterM3", "abstraction_SW_required_M3")
    out["MonthConsumptionRequiredM3"] = acc(
        "MonthConsumptionRequiredM3", "consumption_SwGw_required_M3")
    out["MonthConsumptionActualM3"] = acc("MonthConsumptionActualM3", "consumption_SwGw_actual_M3")
    out["MonthDisM3"] = s["MonthDisM3"] + d["ChanQAvg"] * cfg.dt_sec
    out["MonthWaterAbstractedfromLakesReservoirsM3"] = (
        s["MonthWaterAbstractedfromLakesReservoirsM3"] + d["ReservoirAbstractionM3"]
        + d["LakeAbstractionM3"])
    out["RegionMonthIrrigationShortageM3"] = acc(
        "RegionMonthIrrigationShortageM3", "areatotal_shortage_SW_M3")
    out["MonthInternalFlowM3"] = acc("MonthInternalFlowM3", "ToChanM3Runoff")

    # per-sector monthly accounting (waterabstraction.py:631-646)
    if cfg.rep_water_use:
        paddy_m3 = d["PaddyRiceWaterAbstractionFromSurfaceWaterM3"]
        paddy_mm = paddy_m3 * p["M3toMM"]
        for sector in ("domestic", "energy", "industry", "livestock"):
            key = f"consumption_required_{sector}_MM"
            out[key + "_month"] = s[key + "_month"] + d[key]
        out["consumption_required_irrigation_MM_month"] = (
            s["consumption_required_irrigation_MM_month"]
            + d["consumption_SwGw_required_irrigation_MM"] + paddy_mm)
        out["consumption_actual_irrigation_MM_month"] = (
            s["consumption_actual_irrigation_MM_month"]
            + d["consumption_actual_irrigation_MM"] + paddy_mm)
        out["abstraction_allSources_required_irrigation_M3Month"] = (
            s["abstraction_allSources_required_irrigation_M3Month"]
            + d["abstraction_required_irrigation_M3"] + paddy_m3)
        out["abstraction_allSources_actual_irrigation_M3Month"] = (
            s["abstraction_allSources_actual_irrigation_M3Month"]
            + d["abstraction_SwGw_actual_irrigation_M3"] + d["abstraction_Reuse_irrigation_M3"]
            + paddy_m3)
        out["abstraction_SwGw_required_irrigation_M3Month"] = (
            s["abstraction_SwGw_required_irrigation_M3Month"]
            + d["abstraction_SwGw_required_irrigation_M3"] + paddy_m3)
        out["abstraction_SwGw_actual_irrigation_M3Month"] = (
            s["abstraction_SwGw_actual_irrigation_M3Month"]
            + d["abstraction_SwGw_actual_irrigation_M3"] + paddy_m3)

    # the month-end block (indicatorcalc.py:120-198), every step
    region_internal = regional(out["MonthInternalFlowM3"])
    # external inflow: the region total, at the water-region inflow points,
    # of the upstream sum of MonthDisM3 over the pre-cut downstruct
    # (indicatorcalc.py:139-141)
    region_external = regional(torch.where(p["WaterRegionInflowPoints"],
                                           d["UpstreamSumMonthDis"], 0.0))
    region_demand_all = regional(out["MonthAbstractionRequiredAllSourcesM3"])
    region_abs_swgw = regional(out["MonthAbstractionRequiredSurfaceGroundWaterM3"])
    region_abs_sw = regional(out["MonthAbstractionRequiredSurfaceWaterM3"])
    region_cons_req = regional(out["MonthConsumptionRequiredM3"])
    region_cons_act = regional(out["MonthConsumptionActualM3"])
    out["RegionMonthExternalInflowM3"] = region_external
    out["RegionMonthInternalFlowM3"] = region_internal
    out["RegionMonthAbstractionRequiredAllSourcesM3"] = region_demand_all
    out["RegionMonthAbstractionRequiredSurfaceGroundWaterM3"] = region_abs_swgw
    out["RegionMonthAbstractionRequiredSurfaceWaterM3"] = region_abs_sw
    out["RegionMonthConsumptionRequiredM3"] = region_cons_req
    out["RegionMonthConsumptionActualM3"] = region_cons_act
    if cfg.lakes and cfg.reservoirs:
        # indicatorcalc.py:126-131
        out["RegionMonthReservoirAndLakeStorageM3"] = regional(
            d["ReservoirStorageM3"] + d["LakeStorageM3"])
        out["RegionMonthWaterAbstractedfromLakesReservoirsM3"] = regional(
            out["MonthWaterAbstractedfromLakesReservoirsM3"])

    upstream_inflow = region_external
    local_fresh = region_internal
    local_demand = region_demand_all
    remaining = torch.clamp_min(local_demand - local_fresh, 0.0)
    upstream_used = torch.minimum(remaining, upstream_inflow)
    fossil_used = torch.clamp_min(remaining - upstream_used, 0.0)
    freshwater_total = upstream_inflow + local_fresh
    avail = freshwater_total > 0
    safe_fresh = torch.where(avail, freshwater_total, 1.0)
    out["UpstreamInflowM3"] = upstream_inflow
    out["LocalFreshwaterM3"] = local_fresh
    out["LocalTotalWaterDemandM3"] = local_demand
    out["FossilGroundwaterUsedM3"] = fossil_used
    out["WEI_Dem"] = torch.where(avail, local_demand / safe_fresh, 0.0)
    out["WEI_Abs"] = torch.where(avail, region_abs_swgw / safe_fresh, 0.0)
    out["WEI_Cns"] = torch.where(avail, region_cons_req / safe_fresh, 0.0)
    out["WEI_Plus"] = torch.where(avail, region_cons_act / safe_fresh, 0.0)
    # the '+1' denominators are the reference's own guards
    out["WaterSustainabilityIndex"] = torch.where(
        local_demand > 0, fossil_used / (local_demand + 1), 0.0)
    out["WaterDependencyIndex"] = torch.where(
        local_demand > 0, upstream_used / (local_demand + 1), 0.0)
    out["WaterSecurityIndex"] = torch.where(
        upstream_inflow > 0, upstream_used / (upstream_inflow + 1), 0.0)
    pop = p["RegionPopulation"]
    out["FalkenmarkM3Capita1"] = torch.where(pop > 0, region_internal * 12 / pop, 0.0)
    out["FalkenmarkM3Capita2"] = torch.where(pop > 0, local_fresh * 12 / pop, 0.0)
    out["FalkenmarkM3Capita3"] = torch.where(pop > 0, freshwater_total * 12 / pop, 0.0)
    out["UpstreamInflowUsedM3"] = upstream_used

    # sectoral regional sums (indicatorcalc.py:187-198); the domestic sum
    # stays in mm, as in the reference
    if cfg.rep_water_use:
        mmto_m3 = p["MMtoM3"]
        out["consumption_required_domestic_M3MonthRegion"] = regional(
            out["consumption_required_domestic_MM_month"])
        for key in ("energy", "industry", "livestock", "irrigation"):
            out[f"consumption_required_{key}_M3MonthRegion"] = regional(
                out[f"consumption_required_{key}_MM_month"] * mmto_m3)
        out["consumption_actual_irrigation_M3MonthRegion"] = regional(
            out["consumption_actual_irrigation_MM_month"] * mmto_m3)
        for key in ("allSources_required", "allSources_actual", "SwGw_required", "SwGw_actual"):
            out[f"abstraction_{key}_irrigation_M3MonthRegion"] = regional(
                out[f"abstraction_{key}_irrigation_M3Month"])
    return out


def _window_total(a, k):
    """Sum over the k x k window around every cell of the grids `a` (..., R,
    C), zeros beyond their edges: a summed-area table (two cumulative
    sums)."""
    half = k // 2
    pad = torch.nn.functional.pad(a, (half, k - half, half, k - half))
    sat = torch.nn.functional.pad(pad.cumsum(-2).cumsum(-1), (1, 0, 1, 0))
    total = sat[..., k:, k:] - sat[..., :-k, k:] - sat[..., k:, :-k] + sat[..., :-k, :-k]
    return total[..., :a.shape[-2], :a.shape[-1]]


def groundwater_smooth(cfg, p, lz, land_rows, land_cols, nrows, ncols):
    """LZ smoothing by a window average over groundwater bodies
    (waterabstraction.py:602-628).

    land_rows / land_cols are the pixels' 2-D coordinates. A whole-cell
    window matches PCRaster's area-weighted windowtotal exactly for an odd
    LZSmoothRange (the shipped settings use 5) and approximates even ones.

    An ensemble's members (cfg.members, models/ensemble.py) are stacked in
    the grid's rows, nrows / members rows each, and in the pixel axis,
    cfg.num_pixels / members pixels each: every member gets its own window
    sums and its own mean correction."""
    M = cfg.members
    k = int(p["LZSmoothRangeCells"])
    is_gw = p["GroundwaterBodies"] > 0
    grid_lz = lz.new_zeros(nrows, ncols)
    grid_lz[land_rows, land_cols] = torch.where(is_gw, lz, 0.0)
    grid_cnt = lz.new_zeros(nrows, ncols)
    grid_cnt[land_rows, land_cols] = is_gw.to(lz.dtype)
    by_member = lambda g: _window_total(g.view(M, nrows // M, ncols), k).reshape(nrows, ncols)
    tot = by_member(grid_lz)[land_rows, land_cols]
    cnt = by_member(grid_cnt)[land_rows, land_cols]
    smooth = torch.where(cnt == 0, 0.0, tot / torch.where(cnt == 0, 1.0, cnt))
    lz_new = torch.where(is_gw, 0.9 * lz + 0.1 * smooth, lz)
    # average-error correction: one mean of (smooth - LZ) over all cells of
    # GroundwaterCatch, subtracted there (waterabstraction.py:145-146)
    in_area = p["GroundwaterCatch"] != 0
    diff_sum = torch.where(in_area, smooth - lz, 0.0).view(M, -1).sum(1, keepdim=True)
    n_area = in_area.to(lz.dtype).view(M, -1).sum(1, keepdim=True)
    corr = 0.1 * torch.where(n_area > 0, diff_sum / torch.where(n_area > 0, n_area, 1.0), 0.0)
    return torch.where(in_area, (lz_new.view(M, -1) - corr).view(-1), lz_new)

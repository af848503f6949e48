"""Static model configuration — the port's copy of
lisflood_tpu/models/config.py.

Every boolean here selects a physics path inside the step function, mirroring
the reference's option-gated module dispatch (Lisflood_dynamic.py:38-268).
`routing_kernel` picks the router and with it the sub-step loop: 'packed'
runs the chunk-major sub-step kernel, 'sharded' (on `num_shards` logical
shards) and 'scan' (the natural-order schedule) the sequential loop around
K6's sweep. The JAX package's
`routing_pipeline`, a choice among XLA schedules of the loop, has no
counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ModelConfig:
    # physics options
    init_lisflood: bool = False
    init_lisflood_without_split: bool = False
    split_routing: bool = False
    simulate_lakes: bool = False
    simulate_reservoirs: bool = False
    simulate_polders: bool = False
    open_water_evapo: bool = False
    var_fraction_water: bool = False
    rice_irrigation: bool = False
    water_use: bool = False
    water_use_region: bool = False
    transient_water_demand: bool = False
    transient_landuse: bool = False
    water_demand_ave_year: bool = False
    drained_irrigation: bool = False
    groundwater_smooth: bool = False
    trans_loss: bool = False
    inflow: bool = False
    indicator: bool = False
    simulate_water_levels: bool = False
    simulate_pf: bool = False
    temperature_in_kelvin: bool = False
    rep_mbts: bool = False
    rep_average_dis: bool = False
    rep_total_water_storage: bool = False
    rep_water_use: bool = False
    # kinematic-wave implementation: 'packed' (default) or 'sharded'
    # (subcatchment-partitioned sweep); the JAX package's 'scan' is not ported
    routing_kernel: str = "packed"
    # logical shard count for routing_kernel='sharded' (fixed independently
    # of the number of devices, so that results do not depend on it)
    num_shards: int = 1
    # open-water evaporation formulation outside the routing kernel: the
    # 2-D LDD stencil or the segment-sum scatter ('auto', True or False)
    eva_stencil: object = "auto"
    # discretisation
    no_rout_steps: int = 24
    dt_sec: float = 86400.0
    # structure counts (static shapes)
    num_lakes: int = 0
    num_reservoirs: int = 0
    num_catchments: int = 0
    num_wregions: int = 0
    num_pixels: int = 0
    grid_rows: int = 0
    grid_cols: int = 0
    max_no_eva: int = 5
    # soil Courant sub-stepping cap (the reference's per-pixel loop is
    # unbounded, soilloop.py:249; this is only a safety cap)
    max_soil_substeps: int = 100
    # ensemble members folded into the pixel axis (models/ensemble.py): the
    # counts above are then the ensemble's, member m holding pixels
    # [m P, (m+1) P) of P = num_pixels / members; 1 for a single model
    members: int = 1

    def use_eva_stencil(self, device):
        """'auto' picks the stencil form only on small grids on an
        accelerator; CPU runs keep the segment-sum form. The grid is a
        member's: a folded ensemble chooses as its single model does (the
        JAX package's vmap keeps the member's pixel count). The JAX package
        asks its default backend; the port asks the device it runs on."""
        if self.eva_stencil == "auto":
            if not (0 < self.num_pixels // self.members <= 200_000):
                return False
            return torch.device(device).type != "cpu"
        return bool(self.eva_stencil)

    # the InitLisflood prerun routes a single lane and simulates no lake,
    # reservoir or polder: what the step runs of those options
    @property
    def split(self):
        return self.split_routing and not self.init_lisflood

    @property
    def lakes(self):
        return self.simulate_lakes and not self.init_lisflood

    @property
    def reservoirs(self):
        return self.simulate_reservoirs and not self.init_lisflood

    @property
    def polders(self):
        return self.simulate_polders and not self.init_lisflood

    @property
    def dt_day(self):
        return self.dt_sec / 86400.0

    @property
    def dt_routing(self):
        return self.dt_sec / self.no_rout_steps

    @classmethod
    def from_settings(cls, settings, **overrides):
        """The configuration the settings' options and bindings select, as the
        JAX package's ModelConfig.from_settings; `overrides` are the counts
        build_model works out. RoutingShards (default 4) is read for
        RoutingKernel sharded, as the JAX package reads it; a RoutingKernel
        the port does not have is kept, and building the step refuses it.
        The JAX package's RoutingPipeline chooses among XLA schedules, which
        the port does not have: it is not read."""
        o = settings.options
        dt_sec = float(settings.binding["DtSec"])
        dt_sec_channel = float(settings.binding["DtSecChannel"])
        no_rout = max(1, int(round(dt_sec / dt_sec_channel)))
        if o.get("InitLisflood"):
            no_rout = 1
        kw = dict(
            init_lisflood=bool(o.get("InitLisflood")),
            init_lisflood_without_split=bool(o.get("InitLisfloodwithoutSplit")),
            split_routing=bool(o.get("SplitRouting")),
            simulate_lakes=bool(o.get("simulateLakes")),
            simulate_reservoirs=bool(o.get("simulateReservoirs")),
            simulate_polders=bool(o.get("simulatePolders")),
            open_water_evapo=bool(o.get("openwaterevapo")),
            var_fraction_water=bool(o.get("varfractionwater")),
            rice_irrigation=bool(o.get("riceIrrigation")),
            water_use=bool(o.get("wateruse")),
            water_use_region=bool(o.get("wateruseRegion")),
            transient_water_demand=bool(o.get("TransientWaterDemandChange")),
            transient_landuse=bool(o.get("TransientLandUseChange")),
            water_demand_ave_year=bool(o.get("useWaterDemandAveYear")),
            drained_irrigation=bool(o.get("drainedIrrigation")),
            groundwater_smooth=bool(o.get("groundwaterSmooth")),
            trans_loss=bool(o.get("TransLoss")),
            inflow=bool(o.get("inflow")),
            indicator=bool(o.get("indicator")),
            simulate_water_levels=bool(o.get("simulateWaterLevels")),
            simulate_pf=bool(o.get("simulatePF")),
            temperature_in_kelvin=bool(o.get("TemperatureInKelvin")),
            rep_mbts=bool(o.get("repMBTs")),
            rep_average_dis=bool(o.get("repAverageDis")),
            rep_total_water_storage=bool(o.get("repTotalWaterStorageMaps")),
            rep_water_use=bool(o.get("repWaterUse")),
            routing_kernel=str(settings.binding.get("RoutingKernel", "packed")),
            num_shards=int(settings.binding.get("RoutingShards", 4)
                           if str(settings.binding.get("RoutingKernel", "packed")) == "sharded"
                           else 1),
            eva_stencil={"True": True, "False": False}.get(
                str(settings.binding.get("EvaStencil", "auto")), "auto"),
            no_rout_steps=no_rout,
            dt_sec=dt_sec,
        )
        kw.update(overrides)
        return cls(**kw)

"""Static model configuration — the port's copy of
lisflood_tpu/models/config.py.

Every boolean here selects a physics path inside the step function, mirroring
the reference's option-gated module dispatch (Lisflood_dynamic.py:38-268).
The port has a single sub-step pipeline (the chunk-major routing kernel and
its plain PyTorch version), so the JAX package's `routing_pipeline` field has
no counterpart here; nor have the sub-options of options the port does not
run yet (water use, the sharded router), which come with those options.
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
    transient_landuse: bool = False
    drained_irrigation: bool = False
    trans_loss: bool = False
    inflow: bool = False
    indicator: bool = False
    simulate_water_levels: bool = False
    simulate_pf: bool = False
    temperature_in_kelvin: bool = False
    rep_mbts: bool = False
    rep_average_dis: bool = False
    rep_total_water_storage: bool = False
    # kinematic-wave implementation; the port has 'packed' only
    routing_kernel: str = "packed"
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
    num_pixels: int = 0
    grid_rows: int = 0
    grid_cols: int = 0
    max_no_eva: int = 5
    # soil Courant sub-stepping cap (the reference's per-pixel loop is
    # unbounded, soilloop.py:249; this is only a safety cap)
    max_soil_substeps: int = 100

    def use_eva_stencil(self, device):
        """'auto' picks the stencil form only on small grids on an
        accelerator; CPU runs keep the segment-sum form. The JAX package asks
        its default backend; the port asks the device it runs on."""
        if self.eva_stencil == "auto":
            if not (0 < self.num_pixels <= 200_000):
                return False
            return torch.device(device).type != "cpu"
        return bool(self.eva_stencil)

    @property
    def dt_day(self):
        return self.dt_sec / 86400.0

    @property
    def dt_routing(self):
        return self.dt_sec / self.no_rout_steps

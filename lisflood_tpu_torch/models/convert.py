"""Carry a model built by the JAX package over to the port.

`from_reference` reads the JAX package's (cfg, params, state, aux) — NumPy
arrays and plain objects from `build_synthetic_model` or `build_model` — by
duck typing: dataclass fields of the config, and `chunks` / `downstream` /
`num_pixels` / `chunk_size` of the schedules. It imports nothing of the JAX
package. The tests use it to feed both packages identical inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device, to_device
from ..graph.ldd import RoutingSchedule
from .config import ModelConfig
from .step import build_routers, device_params, prepare_state


def config_from_reference(cfg):
    """The port's ModelConfig with every field the JAX config shares."""
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg) if f.name in names})


def schedule_from_reference(schedule):
    return RoutingSchedule(chunks=np.asarray(schedule.chunks),
                           downstream=np.asarray(schedule.downstream),
                           num_pixels=int(schedule.num_pixels),
                           chunk_size=int(schedule.chunk_size))


def from_reference(cfg, params_np, state_np, aux, device=None, dtype=torch.float64):
    """Returns the port's (ModelConfig, device parameters, prepared packed
    state, routers); `models.step.Step(cfg, params, routers, device)` runs
    them."""
    device = resolve_device(device)
    cfg_t = config_from_reference(cfg)
    aux_t = {k: schedule_from_reference(aux[k]) for k in ("schedule_kin", "schedule_tochan")}
    routers = build_routers(cfg_t, aux_t, device)
    params = device_params(cfg_t, params_np, routers, device, dtype)
    state = prepare_state(cfg_t, routers, to_device(state_np, device, dtype))
    return cfg_t, params, state, routers

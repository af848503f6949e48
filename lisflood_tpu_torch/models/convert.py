"""Carry a model built by the JAX package over to the port.

`from_reference` reads the JAX package's (cfg, params, state, aux) — NumPy
arrays and plain objects from `build_synthetic_model` or `build_model` — by
duck typing: dataclass fields of the config, `chunks` / `downstream` /
`num_pixels` / `chunk_size` of the schedules, and `downstream` / `ldd` /
`num_pixels` of the channel and overland graphs that the sharded router
partitions. It imports nothing of the JAX package. The tests use it to feed
both packages identical inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph.ldd import FlowGraph, RoutingSchedule
from .config import ModelConfig
from .step import build_step


# the JAX-config field that chooses among XLA schedules of the sub-step
# loop; the port ignores it
_SCHEDULE_FIELDS = ("routing_pipeline",)


def config_from_reference(cfg):
    """The port's ModelConfig with every field the JAX config shares. A field
    the port lacks raises ValueError when it is set to anything but its
    default, so that no option is dropped silently."""
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    lost = [f.name for f in dataclasses.fields(cfg)
            if f.name not in names and f.name not in _SCHEDULE_FIELDS
            and getattr(cfg, f.name) != f.default]
    if lost:
        raise ValueError(f"configuration fields without a counterpart in the port: {lost}")
    return ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg) if f.name in names})


def schedule_from_reference(schedule):
    return RoutingSchedule(chunks=np.asarray(schedule.chunks),
                           downstream=np.asarray(schedule.downstream),
                           num_pixels=int(schedule.num_pixels),
                           chunk_size=int(schedule.chunk_size))


def graph_from_reference(graph):
    return FlowGraph(downstream=np.asarray(graph.downstream), ldd=np.asarray(graph.ldd),
                     num_pixels=int(graph.num_pixels))


def from_reference(cfg, params_np, state_np, aux, device=None, dtype=torch.float64):
    """Returns the port's (ModelConfig, device parameters, prepared state,
    routers); `models.step.Step(cfg, params, routers, device)` runs
    them. The model reaches the device as a model of the port's own does,
    through models.step.build_step."""
    cfg_t = config_from_reference(cfg)
    aux_t = {k: schedule_from_reference(aux[k]) for k in ("schedule_kin", "schedule_tochan")}
    aux_t.update({k: graph_from_reference(aux[k]) for k in ("graph_kin", "graph_tochan")
                  if k in aux})
    step, params = build_step(cfg_t, params_np, aux_t, dtype, device)
    return cfg_t, params, step.prepare_state(state_np), step.routers

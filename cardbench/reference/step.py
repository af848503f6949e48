"""The plain reference's daily step, on the benchmark's own inputs.

`ReferenceModel(model, device, dtype)` takes the reference's model (a dict:
`cfg`, the option switches and counts; `params`, NumPy parameter maps in
natural pixel order; the graphs `down_kin` (the channel graph cut at the
structures), `down_order` (the uncut channel graph, which orders the
structures after their feeders), `downstruct` and `down_tochan` (the
overland graph), each a downstream pixel per pixel, -1 at a pit) and
`step(states, forcing)` advances the members' natural states one day.
Nothing here imports the program or takes anything it made.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from .land import land_phase
from .routing import (ChannelPlan, Sweep, channel_routing, post_routing, surface_routing_step,
                      waterbalance)

# what the channel loop reads of a member's state and land phase
LOOP_STATE = ("ChanQKin", "ChanM3Kin", "ChanQ", "Chan2QKin", "Chan2M3Kin", "CrossSection2Area",
              "Sideflow1Chan", "LakeStorageM3CC", "LakeInflowOldCC", "LakeOutflowCC",
              "LakeStorageM3BalanceCC", "LakeLevelCC", "ReservoirStorageM3CC", "ReservoirFillCC")
LOOP_DIAG = ("ToChanM3RunoffDt", "EvaAddM3Dt")


def reference_cfg(fields):
    """The reference's configuration namespace from the model's `cfg`."""
    c = SimpleNamespace(**{"max_soil_substeps": 100, "max_no_eva": 5, "rep_mbts": False,
                           **fields})
    c.dt_day = c.dt_sec / 86400.0
    c.dt_routing = c.dt_sec / c.no_rout_steps
    c.lakes, c.reservoirs = c.num_lakes > 0, c.num_reservoirs > 0
    return c


def device_params(params, device, dtype):
    """NumPy parameters on the device: floats in `dtype`, booleans as bool,
    integers as int64; scalars stay Python numbers."""
    out = {}
    for k, v in params.items():
        if np.ndim(v) == 0:
            out[k] = float(v) if np.asarray(v).dtype.kind == "f" else int(v)
            continue
        a = np.asarray(v)
        if a.dtype.kind == "f":
            out[k] = torch.as_tensor(a, dtype=dtype, device=device)
        elif a.dtype.kind == "b":
            out[k] = torch.as_tensor(a, device=device)
        else:
            out[k] = torch.as_tensor(a.astype(np.int64), device=device)
    return out


class ReferenceModel:
    def __init__(self, model, device, dtype=torch.float64):
        self.cfg = reference_cfg(model["cfg"])
        self.device, self.dtype = torch.device(device), dtype
        self.p = device_params(model["params"], device, dtype)
        structures = {}
        if self.cfg.lakes:
            structures["lake"] = model["params"]["LakeIndex"]
        if self.cfg.reservoirs:
            structures["reservoir"] = model["params"]["ReservoirIndex"]
        self.plan = ChannelPlan(model["down_kin"], model["down_order"], model["downstruct"],
                                structures, self.cfg.no_rout_steps, device)
        self.overland = Sweep(model["down_tochan"], device)

    def to_state(self, state):
        """A state (NumPy or tensors) in the reference's type on its device."""
        out = {}
        for k, v in state.items():
            t = torch.as_tensor(v, device=self.device)
            out[k] = t.to(self.dtype) if t.is_floating_point() else t
        return out

    def step(self, states, forcing):
        """One day of every member: `states` a list of natural states (the
        program's state keys), `forcing` the day's (meteo, CalendarDay,
        LAIInterval). Returns the new states, each with the keys it was
        given."""
        cfg, p = self.cfg, self.p
        f = self.to_state(forcing)
        states = [self.to_state(s) for s in states]
        diags = []
        for s in states:
            d = land_phase(cfg, p, s, f)
            d.update(surface_routing_step(cfg, p, s, d, self.overland))
            diags.append(d)
        present = lambda keys, src: [k for k in keys if k in src[0]]
        s_all = {k: torch.stack([s[k] for s in states]) for k in present(LOOP_STATE, states)}
        d_all = {k: torch.stack([d[k] for d in diags]) for k in present(LOOP_DIAG, diags)}
        carry = channel_routing(cfg, p, s_all, d_all, self.plan)
        out = []
        for m, (s, d) in enumerate(zip(states, diags)):
            d.update(post_routing(cfg, p, s, d, {k: v[m] for k, v in carry.items()}))
            if cfg.rep_mbts:
                d.update(waterbalance(cfg, p, s, d))
            new = {k: d.get(k, s[k]) for k in s}
            new["TimeSinceStart"] = d["TimeSinceStart"]
            out.append(new)
        return out

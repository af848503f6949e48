"""Ensemble simulation — Monte Carlo and the Ensemble Kalman Filter; the
port of lisflood_tpu/models/ensemble.py.

The reference runs an ensemble as one OS process per member
(main.py:98-115, Lisflood_monteCarlo.py, Lisflood_EnKF.py); the JAX package
advances all members in one device program, `jax.vmap` of the step over the
state with shared parameters and forcing. The port folds the members into
the pixel axis instead: an M-member ensemble of a P-pixel model is ONE
model of M * P pixels (`ensemble_model`), whose member m holds pixels
[m P, (m+1) P), lakes [m NL, (m+1) NL) and so on, every index parameter
offset into its member's range. Its routing schedule interleaves the
members' chunks, chunk j of member m at position j M + m, so the one
sub-step kernel launch of a step serves all members, as M independent
wavefronts whose tickets alternate. With RoutingKernel sharded the single
model's partition and sharded schedules are replicated, member m's shard s
being shard m S + s (ops/kinwave_sharded.replicate_sharded_schedule); with
RoutingKernel scan the natural schedules are replicated as above. Either
way one launch of K6 a sub-step sweeps the M members' forests, and every
member's positions keep their single model's order, so its sums (K6's
sources, K7's pieces) add in the same order and a member equals the single
step bit for bit. The step's code is the single model's; the one sum over
all pixels, groundwater smoothing's mean correction, is taken per member
(cfg.members).

The members share parameters and forcing (a step's forcing is tiled over
the members, `tile_forcing`) and each has its own state. On the card the
folded step, the tiling included, advances as a captured CUDA graph
(`EnsembleRunner.stepper`, models/graph.py), the counterpart of the JAX
package's `jax.jit(jax.vmap(step))`. `EnsembleRunner`
holds the folded state; `member_states` / `fold_states` convert between it
and per-member states in the single model's layout (the JAX package's, with
its `pk$` schedule-packed routing entries), which is also the layout of the
`stateVar_{m}_{step}.npz` dumps, so a dump of either package loads in the
other.

The analysis of `enkf_analysis` is the JAX package's stochastic EnKF:
K = P H^T (H P H^T + R)^-1 from the ensemble anomalies, X_a = X_f + K (y +
eps - H X_f), on a set of prognostic fields, observing discharge at gauge
pixels; the (n_obs, n_obs) solve runs on the host in NumPy, the anomaly
products over the state on the device (`torch.matmul`).

An ensemble of a settings-driven run comes from its `LisfloodRunner`
(models/driver.py) through `EnsembleRunner.from_runner`: the members start
from the runner's state, take each day's forcing from `runner.forcing_for`
(tiled over the members) and, with outputs, each reports its slice of the
day's diagnostics through an OutputManager of its own into PathOut/<m>/ (the
reference MonteCarloFramework layout). `run_from_settings` (MonteCarlo /
EnKF from the settings, as lisfloodexe runs it) and `run_montecarlo` are the
JAX package's.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time

import numpy as np
import torch

from ..graph.ldd import RoutingSchedule
from ..ops.kinwave_sharded import replicate_sharded_schedule
from . import graph
from .driver import OutputManager, to_host
from .step import build_step, sharded_schedules

# prognostic fields updated by the EnKF analysis (clamped at 0 after it)
DEFAULT_ANALYSIS_FIELDS = ("ChanQKin", "ChanM3Kin", "UZ", "LZ", "W1a", "W1b", "W2")

# index parameters, by how a member's copy is offset: pixel positions;
# downstream pixels with P as the pit; labels offset by a count of the config
_PIXEL_INDEX = ("LakeIndex", "ReservoirIndex")
_DOWNSTREAM_INDEX = ("downstruct", "downEva")
_LABELS = {"Catchments": "num_catchments", "WUseRegionC": "num_wregions",
           "LandRows": "grid_rows"}
# integer parameters that are tiled as they are: column coordinates, the
# groundwater area (only `!= 0` is read) and the 2-D grid's LDD codes
_TILED_INTEGERS = ("LandCols", "GroundwaterCatch", "evaDir2D")


def replicate_schedule(schedule, M):
    """The routing schedule of M copies of `schedule`'s graph, copy m on
    pixels [m P, (m+1) P), with the copies' chunks interleaved: chunk j of
    copy m is chunk j M + m. Every edge stays between a copy's own chunks,
    so each lands 1..W M chunks later (W the single schedule's window) and
    every structure stays later than its feeders. O(M P) NumPy."""
    P = int(schedule.num_pixels)
    chunks = np.asarray(schedule.chunks, np.int64)              # (n, C), P = padding
    off = (np.arange(M, dtype=np.int64) * P)[:, None, None]
    rep = np.where(chunks[None] < P, chunks[None] + off, M * P)    # (M, n, C)
    inter = rep.transpose(1, 0, 2).reshape(-1, chunks.shape[1])
    down = np.asarray(schedule.downstream, np.int64)[:P]        # P = pit
    down_m = np.where(down[None] < P, down[None] + off[:, :, 0], M * P).reshape(-1)
    return RoutingSchedule(chunks=inter.astype(np.int32),
                           downstream=np.append(down_m, M * P).astype(np.int32),
                           num_pixels=M * P, chunk_size=int(schedule.chunk_size))


def ensemble_model(cfg, params, aux, M):
    """The M-member ensemble of the model `(cfg, params, aux)` as one model
    `(cfg, params, aux)` of M P pixels (module docstring). Parameters are
    NumPy arrays or scalars: per-pixel, per-lake and per-reservoir arrays
    are tiled along their last axis, index parameters offset into each
    member's range; an integer array of unknown meaning raises ValueError.
    `aux` keeps the single model's forcing entries; the schedules are
    replicated (replicate_schedule), and with RoutingKernel sharded the
    single model's sharded schedules too (`aux["sharded"]`,
    replicate_sharded), built from its graphs unless `aux` holds them."""
    if cfg.members != 1:
        raise ValueError("ensemble_model takes a single model")
    P = cfg.num_pixels
    counts = {P, cfg.num_lakes or -1, cfg.num_reservoirs or -1}
    grid = cfg.grid_rows * cfg.grid_cols
    m_ = np.arange(M, dtype=np.int64)

    def tiled(v, offset=0):
        return np.concatenate([v + m * offset if offset else v for m in range(M)], axis=-1)

    out = {}
    for k, v in params.items():
        if np.isscalar(v) or np.ndim(v) == 0:
            out[k] = v
            continue
        v = np.asarray(v)
        if k in _PIXEL_INDEX:
            out[k] = tiled(v.astype(np.int64), P)
        elif k in _DOWNSTREAM_INDEX:
            v = v.astype(np.int64)
            out[k] = np.where(v[None] < P, v[None] + (m_ * P)[:, None], M * P).reshape(-1)
        elif k in _LABELS:
            out[k] = tiled(v.astype(np.int64), getattr(cfg, _LABELS[k]))
        elif k == "landIdx":
            out[k] = tiled(v.astype(np.int64), grid)
        elif k == "evaDir2D" or v.shape[-1] in counts:
            if v.dtype.kind in "iu" and k not in _TILED_INTEGERS:
                raise ValueError(f"{k}: an integer parameter the ensemble cannot offset")
            out[k] = tiled(v)
        else:
            raise ValueError(f"{k}: last axis {v.shape[-1]} is neither pixels ({P}), lakes "
                             f"nor reservoirs")
    cfg_e = dataclasses.replace(
        cfg, num_pixels=M * P, num_lakes=M * cfg.num_lakes, num_reservoirs=M * cfg.num_reservoirs,
        num_catchments=M * cfg.num_catchments, num_wregions=M * cfg.num_wregions,
        grid_rows=M * cfg.grid_rows, members=M)
    aux_e = {k: v for k, v in aux.items() if k not in ("schedule_kin", "schedule_tochan")
             and not k.startswith("graph")}
    aux_e["schedule_kin"] = replicate_schedule(aux["schedule_kin"], M)
    aux_e["schedule_tochan"] = replicate_schedule(aux["schedule_tochan"], M)
    if cfg.routing_kernel == "sharded":
        aux_e["sharded"] = replicate_sharded(aux["sharded"] if "sharded" in aux
                                             else sharded_schedules(cfg, aux), M)
    return cfg_e, out, aux_e


def replicate_sharded(sched, M):
    """The sharded schedules of an M-member ensemble (for build_routers'
    `aux["sharded"]`) from the single model's (step.sharded_schedules):
    both graphs' schedules replicated (replicate_sharded_schedule), member
    m's shard s numbered m S + s, the single model's partition statistics,
    and in `seconds` the single model's parts and the replication's."""
    t0 = time.perf_counter()
    S = int(sched["kin"].n_shards)
    shard_of = np.asarray(sched["shard_of"], np.int64)
    out = {key: replicate_sharded_schedule(sched[key], M) for key in ("kin", "tochan")}
    out["shard_of"] = np.concatenate([shard_of + m * S for m in range(M)]).astype(np.int32)
    out["partition_stats"] = sched["partition_stats"]
    out["seconds"] = {**sched["seconds"], "replicate": time.perf_counter() - t0}
    return out


def fold_states(states, chunk):
    """One folded ensemble state (NumPy) from the members' states in the
    single model's layout: natural entries joined along their last axis,
    `pk$` entries (schedule-packed, `chunk` lanes a chunk) interleaved chunk
    by chunk as replicate_schedule orders them. A scalar entry is one for
    all members (the step counters): members that differ there raise."""
    M = len(states)
    out = {}
    for k in states[0]:
        vals = [np.asarray(s[k]) for s in states]
        if vals[0].ndim == 0:
            if any(v != vals[0] for v in vals[1:]):
                raise ValueError(f"{k}: the members differ in a scalar the ensemble shares")
            out[k] = vals[0]
        elif k.startswith("pk$"):
            out[k] = np.stack(vals).reshape(M, -1, chunk).transpose(1, 0, 2).reshape(-1)
        else:
            out[k] = np.concatenate(vals, axis=-1)
    return out


def member_state(state, m, M, chunk):
    """Member m's state in the single model's layout from a folded state,
    the inverse of fold_states; the entries are views of the folded ones,
    tensors or NumPy arrays as the state holds them."""
    out = {}
    for k, v in state.items():
        if v.ndim == 0:
            out[k] = v
        elif k.startswith("pk$"):
            out[k] = v.reshape(-1, M, chunk)[:, m].reshape(-1)
        else:
            out[k] = v.reshape(tuple(v.shape[:-1]) + (M, -1))[..., m, :]
    return out


def tile_forcing(forcing, M, P):
    """A step's forcing for the folded ensemble: every entry with a pixel
    axis (last axis P) repeated for the M members; scalars as they are."""
    return {k: (v.repeat(*([1] * (v.dim() - 1)), M) if v.dim() and v.shape[-1] == P else v)
            for k, v in forcing.items()}


def _member_slice(v, m, M):
    """Member m's part of a folded diagnostic (host array): its slice of the
    last axis (pixels, lakes, reservoirs or catchments); a scalar is every
    member's."""
    return v if v.ndim == 0 else v.reshape(v.shape[:-1] + (M, -1))[..., m, :]


def perturb_state(generator, state, fields, sigma=0.05, min_val=0.0):
    """Multiplicative Gaussian perturbation of the named state fields
    (reference perturbState, add1.py:918-945): v * (1 + sigma N(0, 1)),
    clamped below at min_val; the noise comes from `generator`, field by
    field in the given order. Other entries are passed on as they are."""
    out = dict(state)
    for field in fields:
        v = state[field]
        noise = torch.randn(v.shape, generator=generator, dtype=v.dtype, device=v.device)
        out[field] = torch.clamp_min(v * (1.0 + sigma * noise), min_val)
    return out


class EnsembleRunner:
    """M members of one model advanced by one step program (module
    docstring): the counterpart of the JAX package's vmapped EnsembleRunner,
    built from a single model `(cfg, params, state, aux)` of NumPy arrays, or
    from a `LisfloodRunner` (from_runner). The members start from the model's
    state, each with its own perturbation of `perturb_fields` drawn from
    `seed`."""

    def __init__(self, model, n_members, seed=0,
                 perturb_fields=("UZ", "LZ", "W1a", "W1b", "W2"), sigma=0.05,
                 dtype=torch.float32, device=None):
        cfg, params, state, aux = model
        self.n = n_members
        self.pixels = cfg.num_pixels
        self.runner = None          # the settings-driven run, from_runner
        self.outputs = None
        cfg_e, params_e, aux_e = ensemble_model(cfg, params, aux, n_members)
        self.step, self.params = build_step(cfg_e, params_e, aux_e, dtype, device)
        # the step as advance runs it: on the card a replay of the folded
        # step captured with the forcing's tiling (models/graph.py)
        self.stepper = graph.stepper(self.step, functools.partial(tile_forcing, M=n_members,
                                                                  P=cfg.num_pixels))
        self.cfg = cfg_e
        self.chunk = self.step.routers["kin"].ps.chunk
        generator = torch.Generator(device=self.step.device).manual_seed(seed)
        self.state = perturb_state(generator, self.fold([state] * n_members),
                                   perturb_fields, sigma)

    @classmethod
    def from_runner(cls, runner, n_members, seed=0, with_outputs=False, **kw):
        """The ensemble of a LisfloodRunner's model, in its dtype and on its
        device, the members starting from the runner's state. With
        `with_outputs` each member m writes the settings' outputs into
        PathOut/<m+1>/."""
        t0 = time.perf_counter()
        state = {k: v.cpu().numpy() for k, v in runner.state.items()}
        aux = runner.aux
        routers = runner.step.routers
        if runner.config.routing_kernel == "sharded":
            # the runner's own partition and schedules, replicated
            aux = {**aux, "sharded": {"kin": routers["kin"].ps, "tochan": routers["tochan"].ps,
                                      "shard_of": routers["shard_of"],
                                      "partition_stats": routers["partition_stats"],
                                      "seconds": {}}}
        ens = cls((runner.config, runner.params_np, state, aux), n_members, seed,
                  dtype=runner.dtype, device=runner.device, **kw)
        ens.runner = runner
        # host seconds: the folded model built and perturbed, the days
        # (steps, copies and reports), the step's capture as a CUDA graph on
        # the card, the EnKF analyses and the dumps
        ens.seconds = {"build": time.perf_counter() - t0, "days": 0.0, "capture": 0.0,
                       "enkf": 0.0, "dumps": 0.0}
        if with_outputs:
            ens.outputs = []
            for m in range(n_members):
                s_m = runner.settings.for_subdir(str(m + 1))
                os.makedirs(s_m.output_dir, exist_ok=True)
                ens.outputs.append(OutputManager(s_m, runner.grid, runner.params_np,
                                                 runner.aux, runner.config))
        return ens

    def fold(self, states):
        """The members' states (single-model layout, natural or `pk$`
        packed) as the ensemble step's state on its device."""
        folded = fold_states(states, self.chunk)
        return self.step.prepare_state(folded, self.params["ChanLength"].dtype)

    def member_states(self):
        """The members' states in the single model's layout, as NumPy
        arrays."""
        host = {k: v.detach().cpu().numpy() for k, v in self.state.items()}
        return [member_state(host, m, self.n, self.chunk) for m in range(self.n)]

    def advance(self, forcing_stack):
        """Advance all members over the steps of `forcing_stack` (the single
        model's forcing, every entry with a leading step axis, on the
        ensemble's device), each step through `stepper`. Returns the state
        and the last step's diagnostics."""
        n_steps = len(next(iter(forcing_stack.values())))
        diag = None
        for t in range(n_steps):
            self.state, diag = self.stepper(self.state, {k: v[t] for k, v in forcing_stack.items()},
                                            None if t == n_steps - 1 else ())
        self.state = self.stepper.keep(self.state)
        return self.state, diag

    def advance_days(self, offsets):
        """Advance all members over the runner's step offsets `offsets`
        (from_runner), each day's forcing from runner.forcing_for, and report
        each member's outputs: the fields the day reports are copied to the
        host once a day for all members, member m's slice of each to its
        OutputManager. Returns the state and the last day's reported
        fields."""
        runner = self.runner
        start, end = runner.settings.step_start_int, runner.settings.step_end_int
        diag = None
        captured = getattr(self.stepper, "capture_seconds", None) or 0.0
        t0 = time.perf_counter()
        for offset in offsets:
            date = runner.dates[offset]
            step = start + offset
            fields = self.outputs[0].fields_at(step, step == end) if self.outputs else ()
            self.state, diag = self.stepper(self.state, runner.forcing_for(offset, date), fields)
            if self.outputs:
                host = to_host(diag)
                for m, man in enumerate(self.outputs):
                    man.report(step, date,
                               {k: _member_slice(v, m, self.n) for k, v in host.items()},
                               is_last=(step == end))
        self.state = self.stepper.keep(self.state)
        capture = (getattr(self.stepper, "capture_seconds", None) or 0.0) - captured
        self.seconds["days"] += time.perf_counter() - t0 - capture
        self.seconds["capture"] += capture
        return self.state, diag

    def close_outputs(self):
        """Flush and close every member's outputs."""
        for man in self.outputs or ():
            man.close()

    # ------------------------------------------------------------------
    def enkf_analysis(self, obs_values, obs_pixels, obs_sigma,
                      fields=DEFAULT_ANALYSIS_FIELDS, seed=1):
        """Stochastic EnKF analysis of the ensemble (JAX
        EnsembleRunner.enkf_analysis): obs_values (n_obs,) observed discharge
        [m3/s] at the single model's pixels obs_pixels (n_obs,), obs_sigma
        the observation error (scalar or (n_obs,)). The observation noise
        comes from numpy's default_rng(seed), as in the JAX package; the
        gain is applied in the state's dtype."""
        N = self.n
        obs_pixels = np.asarray(obs_pixels)
        y = np.asarray(obs_values, np.float64)
        n_obs = y.shape[0]
        r_std = np.broadcast_to(np.asarray(obs_sigma, np.float64), (n_obs,))

        # forecast observations per member, H X_f, and the (n_obs, n_obs)
        # system on the host
        hx = self._gauge_discharge(obs_pixels)                     # (N, n_obs)
        hx_anom = hx - hx.mean(0)
        s = hx_anom.T @ hx_anom / (N - 1) + np.diag(r_std**2)
        s_inv = np.linalg.inv(s)
        rng = np.random.default_rng(seed)
        eps = rng.normal(size=(N, n_obs)) * r_std                  # perturbed obs
        innov = (y[None] + eps - hx) @ s_inv                       # (N, n_obs)

        dtype, device = self.params["ChanLength"].dtype, self.step.device
        innov_d = torch.as_tensor(innov, dtype=dtype, device=device)
        hx_anom_d = torch.as_tensor(hx_anom, dtype=dtype, device=device)
        new_state = dict(self.state)
        for field in (f if f in self.state else "pk$" + f for f in fields):
            flat = self._members_major(field)                     # (N, dim)
            anom = flat - flat.mean(0)
            gain = torch.matmul(anom.T, hx_anom_d) / (N - 1)     # (dim, n_obs)
            upd = torch.matmul(innov_d, gain.T)                    # (N, dim)
            new_state[field] = self._fold_members(field, torch.clamp_min(flat + upd, 0.0))
        self.state = new_state
        return new_state

    def _members_major(self, field):
        """(N, dim) view of a folded field, row m member m's entries in the
        single model's order."""
        v, N = self.state[field], self.n
        if field.startswith("pk$"):
            return v.view(-1, N, self.chunk).transpose(0, 1).reshape(N, -1)
        return v.reshape(v.shape[:-1] + (N, -1)).movedim(-2, 0).reshape(N, -1)

    def _fold_members(self, field, flat):
        """Inverse of _members_major."""
        v, N = self.state[field], self.n
        if field.startswith("pk$"):
            return flat.view(N, -1, self.chunk).transpose(0, 1).reshape(-1)
        lead = v.shape[:-1]
        return flat.view((N,) + lead + (-1,)).movedim(0, -2).reshape(v.shape)

    def _gauge_discharge(self, obs_pixels):
        """(N, n_obs) member discharge at the single model's pixel indices,
        read from ChanQ: schedule-packed with the packed router, natural with
        the sharded and the scan router."""
        natural = (np.arange(self.n)[:, None] * self.pixels + obs_pixels[None]).reshape(-1)
        if "pk$ChanQ" in self.state:
            pos = self.step.routers["kin"].ps.inv_perm[natural]
            q = self.state["pk$ChanQ"][torch.as_tensor(pos, device=self.step.device)]
        else:
            q = self.state["ChanQ"][torch.as_tensor(natural, device=self.step.device)]
        return q.double().cpu().numpy().reshape(self.n, -1)

    # ------------------------------------------------------------------
    def dump_states(self, directory, step):
        """Each member's state as `stateVar_{m}_{step}.npz`, m from 1, in the
        single model's layout and keys (stateVar.py:37-143 analogue, npz
        instead of pickles)."""
        os.makedirs(directory, exist_ok=True)
        for m, member in enumerate(self.member_states()):
            np.savez(os.path.join(directory, f"stateVar_{m + 1}_{step}.npz"), **member)

    def load_states(self, directory, step):
        """The ensemble's state from the members' `stateVar_{m}_{step}.npz`."""
        members = []
        for m in range(self.n):
            with np.load(os.path.join(directory, f"stateVar_{m + 1}_{step}.npz")) as data:
                members.append({k: data[k] for k in data.files})
        self.state = self.fold(members)


def run_from_settings(runner, settings, seed=0):
    """MonteCarlo / EnKF from the settings file (reference main.py:98-115),
    the JAX package's: `EnsMembers` members of the runner's model (the
    reference forks a process per sample, setForkSamples, main.py:104-106),
    each writing its outputs into PathOut/<m>/; at each of the `FilterSteps`
    the members' states are dumped (stateVar.dynamic, stateVar.py:37-143)
    and the analysis assimilates the ensemble mean of the outlets' discharge
    with 10% error (the reference's setObservations is a random placeholder,
    Lisflood_EnKF.py:50-63)."""
    ens = EnsembleRunner.from_runner(runner, settings.ens_members, seed=seed, with_outputs=True)
    start, end = settings.step_start_int, settings.step_end_int
    n_steps = end - start + 1
    filter_offsets = sorted(st - start + 1 for st in settings.filter_steps if start <= st <= end)
    state_dir = os.path.join(settings.output_dir, "stateVar")
    obs_pixels = np.flatnonzero(np.asarray(runner.params_np["AtLastPointC"]))
    try:
        prev = 0
        for off in filter_offsets:
            ens.advance_days(range(prev, off))
            t0 = time.perf_counter()
            ens.dump_states(state_dir, start + off - 1)
            t1 = time.perf_counter()
            if obs_pixels.size:
                y = ens._gauge_discharge(obs_pixels).mean(0)
                sigma = np.maximum(0.1 * np.abs(y), 1e-6)
                ens.enkf_analysis(y, obs_pixels, sigma, seed=seed + off)
            ens.seconds["dumps"] += t1 - t0
            ens.seconds["enkf"] += time.perf_counter() - t1
            prev = off
        if prev < n_steps:
            ens.advance_days(range(prev, n_steps))
    finally:
        ens.close_outputs()
        runner.forcing.close()
    return ens


def run_montecarlo(runner, n_members, seed=0, max_steps=None, with_outputs=False):
    """Monte Carlo run (main.py:98-106 analogue, members folded, not
    forked): the perturbed ensemble of the runner's model advanced to the
    end, or `max_steps` days; returns the EnsembleRunner."""
    ens = EnsembleRunner.from_runner(runner, n_members, seed=seed, with_outputs=with_outputs)
    n = runner.settings.step_end_int - runner.settings.step_start_int + 1
    try:
        ens.advance_days(range(n if max_steps is None else min(n, max_steps)))
    finally:
        ens.close_outputs()
        runner.forcing.close()
    return ens

"""The benchmark's harness: one cell of BENCHMARK.json, run once.

A cell names a configuration (`configs/<config>.json`, whose `generator` is
a module `inputs/<generator>.py`) and a traffic mix (`traffic/<mix>.json`);
its limits are `checks/<cell>.json`; each per-layer metric is a reader
`metrics/<metric>.py`. All are found by name, so a cell, a mix or a metric
is added by adding files.

A run (`run_cell`): set-up (inputs made from the seed, the program built
from them and moved to the device, its step captured and warmed up on the
shapes the window uses), then the window (calls of the program's entry,
each advancing `days_per_call` daily steps, the forcing taken from a ring of
days held on the device), or with `trace` a profiled stretch of calls, and
last the check of what the timed path produced against the plain reference
(reference/), once the window has closed and the program is freed.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
# the packages no process of the benchmark may hold once its window has
# closed, by top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "lisflood_tpu")
GIB = 2.0 ** 30


def read_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_cell(name, root=ROOT):
    """(bench, cell, config, traffic, limits) of the cell `name`, each found
    by its name under the checkout `root`."""
    root = Path(root)
    bench = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = read_json(root / entry["file"])
    traffic = read_json(root / "cardbench" / "traffic" / f"{cell['traffic']}.json")
    limits = read_json(root / "cardbench" / "checks" / f"{name}.json")
    return bench, cell, config, traffic, limits


def generator(config):
    """The input generator module of a configuration, by its name."""
    return importlib.import_module(f"cardbench.inputs.{config['generator']}")


def quantity(name):
    """What a metric reads: its name up to the first dot. `cell_steps_per_s`
    and `cell_steps_per_s.ens` are one quantity under bounds of their own."""
    return name.split(".")[0]


def reported(bench, cell):
    """(end-to-end, per-layer) metric entries of BENCHMARK.json that `cell`
    reports: an entry with `workloads` where that lists the cell; an
    end-to-end one without, in every cell; a per-layer one without, where
    the cell reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per


def metric_reader(name, root=ROOT):
    """The reader module of the per-layer metric `name`, loaded from its
    file under `root`: `metrics/<name>.py`, or where there is none, the
    reader of its quantity, `metrics/<quantity>.py`."""
    path = Path(root) / "cardbench" / "metrics" / f"{name}.py"
    if not path.is_file():
        path = path.with_name(f"{quantity(name)}.py")
    spec = importlib.util.spec_from_file_location(f"cardbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules():
    """The forbidden packages this process holds, by top-level name."""
    import sys
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Program:
    """The system under test: the program's timed entry on the model of the
    inputs. One model: `build_multi_step`'s `multi(state, forcing_stack)`,
    a replay of the captured step each day; M members: the folded
    `EnsembleRunner.advance`, its members perturbed from `seed`."""

    def __init__(self, torch, model, traffic, seed, dtype, device):
        self.members = int(traffic["members"])
        if self.members == 1:
            from lisflood_tpu_torch.models.step import build_multi_step
            cfg, params, state, aux = model
            self.multi, _ = build_multi_step(cfg, params, aux, dtype=dtype, device=device)
            self.state = self.multi.prepare_state(state)
            self.stepper = self.multi.stepper
            self.step = self.multi.step
        else:
            from lisflood_tpu_torch.models.ensemble import EnsembleRunner
            self.ens = EnsembleRunner(model, self.members, seed=seed,
                                      perturb_fields=tuple(traffic["perturb"]),
                                      sigma=traffic["sigma"], dtype=dtype, device=device)
            self.state = self.ens.state
            self.stepper = self.ens.stepper
            self.step = self.ens.step
        self.pixels = model[0].num_pixels * self.members

    def call(self, state, forcing):
        """One call of the timed entry over the days of `forcing`."""
        if self.members == 1:
            return self.multi(state, forcing)[0]
        self.ens.state = state
        return self.ens.advance(forcing)[0]

    def members_natural(self, state):
        """The members' natural states on the host (NumPy), from a state of
        the entry's: the program's own unpacking, split by member."""
        nat = {k: v.detach().cpu().numpy() for k, v in self.step.natural_state(state).items()}
        M = self.members
        return [{k: (v if v.ndim == 0 else v.reshape(v.shape[:-1] + (M, -1))[..., m, :])
                 for k, v in nat.items()} for m in range(M)]


class Clock:
    """Bounds the calls in flight on a card to two, by an event after each
    call, so that the host's clock stays within a call of the device's; the
    events also time each call on the device (`call_ms`)."""

    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = device.type == "cuda"
        self.events = []

    def mark(self):
        if not self.cuda:
            return
        if len(self.events) >= 2 and not self.events[-2].query():
            self.events[-2].synchronize()
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def call_ms(self):
        """Device ms between consecutive calls' events since the last reset."""
        ev = self.events
        out = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
        self.events = []
        return out


def setup(torch, config, traffic, seed, device, workdir):
    """Everything before the window: returns the run's context."""
    dtype = getattr(torch, config["dtype"])
    gen = generator(config)
    t0 = time.perf_counter()
    inputs = gen.make_inputs(config, seed, workdir, traffic)
    t_inputs = time.perf_counter() - t0
    model = gen.build_program(torch, inputs, traffic, dtype, device)
    prog = Program(torch, model, traffic, seed, dtype, device)
    del model
    ring = gen.forcing_ring(torch, inputs, traffic["ring_days"], seed, device, dtype)
    D = int(traffic["days_per_call"])
    if traffic["ring_days"] % D:
        raise ValueError("ring_days must be a multiple of days_per_call")
    slices = [{k: v[j * D:(j + 1) * D] for k, v in ring.items()}
              for j in range(traffic["ring_days"] // D)]
    # the start of the check: the program's initial state, as it built it
    t1 = time.perf_counter()
    start = prog.members_natural(prog.state)
    t_start_copy = time.perf_counter() - t1
    clock = Clock(torch, device)
    state = prog.state
    for k in range(int(traffic["warmup_calls"])):
        state = prog.call(state, slices[k % len(slices)])
        clock.mark()
    clock.sync()
    return SimpleNamespace(gen=gen, inputs=inputs, prog=prog, ring=ring, slices=slices, D=D,
                           state=state, calls=int(traffic["warmup_calls"]), start=start,
                           clock=clock, dtype=dtype, t_inputs=t_inputs,
                           t_excluded=t_start_copy)


def run_calls(ctx, seconds=None, n_calls=None):
    """Calls of the timed entry from the context's state, until `seconds`
    have passed on the host's clock or after `n_calls`; ends synchronised.
    Returns (calls made, wall seconds); the context keeps the state before
    the last call, the last call's forcing and the state it returned."""
    prog, clock = ctx.prog, ctx.clock
    state, k = ctx.state, 0
    clock.call_ms()
    clock.mark()
    t0 = time.perf_counter()
    while (n_calls is None or k < n_calls) and (seconds is None or
                                                 time.perf_counter() - t0 < seconds):
        j = (ctx.calls + k) % len(ctx.slices)
        forcing = ctx.slices[j]
        ctx.before_last, ctx.last_forcing, ctx.last_slice = state, forcing, j
        state = prog.call(state, forcing)
        clock.mark()
        k += 1
    clock.sync()
    wall = time.perf_counter() - t0
    ctx.state, ctx.calls = state, ctx.calls + k
    ctx.call_ms = clock.call_ms()
    return k, wall


def host_forcing(forcing, t):
    """Day t of a forcing stack, on the host."""
    return {k: v[t].detach().cpu().numpy() for k, v in forcing.items()}


def replay_last_call(torch, ctx, seed):
    """The window's last call again, day by day through the entry's own
    stepper from the state it started from: the states around one day of
    it drawn from the seed, and the keys of the state in which the replayed
    end state differs from the window's by a bit."""
    prog = ctx.prog
    t_star = int(np.random.default_rng([int(seed), 7]).integers(ctx.D))
    state = ctx.before_last
    for t in range(ctx.D):
        f = {k: v[t] for k, v in ctx.last_forcing.items()}
        if t == t_star:
            before = prog.members_natural(state)
        state, _ = prog.stepper.run(state, f)
        if t == t_star:
            after = prog.members_natural(state)
    mismatched = [k for k, v in ctx.state.items()
                  if not torch.equal(v, state[k])]
    day = ctx.last_slice * ctx.D + t_star
    return t_star, before, after, (day, host_forcing(ctx.last_forcing, t_star)), mismatched


def free_program(torch, ctx):
    """Drop every device tensor of the program."""
    for name in ("prog", "ring", "slices", "state", "before_last", "last_forcing", "clock"):
        if hasattr(ctx, name):
            delattr(ctx, name)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

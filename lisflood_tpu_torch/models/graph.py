"""The step as one device program: the port's counterpart of the JAX
package's `jax.jit` of the step (lisflood_tpu/models/step.py:452), of the
`lax.scan` of `build_multi_step` over a chunk of days (step.py:466-487) and
of the ensemble's `jax.jit(jax.vmap(step))` (lisflood_tpu/models/ensemble.py:60).

On the card a step is ~750-4,900 kernel launches from the host. A
`GraphedStep` captures one step as a `torch.cuda.CUDAGraph` and replays it:

  - static buffers: one device tensor for each state entry (`state_keys`)
    and each forcing entry the step is given;
  - warm-up: the first call runs the step eagerly on those buffers, on the
    stream it captures on; that is the first day's step, and it builds what
    the kernels build at first use (libraries, tile tables, per-device
    queries) before the capture;
  - capture: the step, then every new state entry copied back into the
    static state, so that a replay advances the state in place;
  - replay: a call copies the day's forcing (and a state that is not the
    static one) into the static buffers and replays.

What a replay leaves in the graph's buffers is overwritten by the next one:
`GraphedStep.__call__` returns copies of the diagnostics asked for, and
`keep(state)` a copy of the state, for what a caller holds across days. A
forcing entry must be a tensor: a Python number would be frozen into the
graph at its capture value. The kernel wrappers count their launches in
Python (`<wrapper>.launches`), which a replay does not run: the increase a
capture recorded is added at every replay (`counted_apart`, `add_launches`).
K7's segment orders keep scratch that serves one call at a time; the graph
runs on copies of them with scratch of its own (`SegmentOrder.own_scratch`),
which the capture claims for the graph.

On the CPU the entry points run the eager step (`EagerStep`, the same
interface); a GraphedStep there runs its captured region's body, the
static-buffer step, eagerly at each call, which is what the CPU tests hold
to the eager step. A capture that fails raises, naming the line of the
step where it failed: no path carries on eagerly on the card.
"""
from __future__ import annotations

import copy
import os
import time
import traceback

import torch

from ..ops import kinwave_packed, kinwave_sharded, kinwave_substep, segment_sum, soil_tail
from ..ops.segment_sum import SegmentOrder
from .step import state_keys

# the kernel wrappers' launch counters, by kernel: (module, wrapper name),
# read through the module so that a wrapper put in its place is counted
COUNTERS = {"kinwave_substep": (kinwave_substep, "kinwave_substep"),
            "kinwave_sweep": (kinwave_packed, "kinwave_sweep"),
            "kinwave_sharded": (kinwave_sharded, "kinwave_sharded_sweep"),
            "segment_sum": (segment_sum, "segment_total"),
            "soil_tail": (soil_tail, "soil_tail")}


def launch_counts():
    """Every kernel wrapper's launch count, by kernel."""
    return {k: getattr(mod, name).launches for k, (mod, name) in COUNTERS.items()}


def set_launches(counts):
    """Sets the wrappers' launch counts to `counts` (by kernel)."""
    for k, (mod, name) in COUNTERS.items():
        getattr(mod, name).launches = counts[k]


def add_launches(delta):
    """Adds `delta` (by kernel) to the wrappers' launch counts."""
    for k, n in delta.items():
        mod, name = COUNTERS[k]
        getattr(mod, name).launches += n


def counted_apart(fn):
    """`fn()` with the launches the wrappers count during it taken back out
    of their counters: returns (its result, those launches by kernel). A
    capture runs the wrappers but launches nothing; what they counted is
    what every replay launches."""
    before = launch_counts()
    try:
        out = fn()
    finally:
        after = launch_counts()
        set_launches(before)
    return out, {k: after[k] - before[k] for k in after}


def _storage(v):
    return v.untyped_storage().data_ptr()


_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _failed_at(err):
    """Where a failed capture stopped: the innermost line of the port's code
    in the traceback of the error that broke it (the capture's own end
    raises another, whose context that error is)."""
    first = err
    while first.__context__ is not None:
        first = first.__context__
    frames = [f for f in traceback.extract_tb(first.__traceback__)
              if f.filename.startswith(_PACKAGE) and f.filename != __file__]
    if not frames:
        return str(first)
    f = frames[-1]
    return (f"{os.path.relpath(f.filename, os.path.dirname(_PACKAGE))}:{f.lineno} "
            f"({f.line}): {first}")


class EagerStep:
    """The eager step behind GraphedStep's interface, as the entry points run
    it on the CPU: `run(state, forcing)` is one step (through `prepare`,
    where given, on the forcing), `__call__(state, forcing, keys)` the same
    with the diagnostics among `keys` (all where None), `keep(state)` the
    state itself (no later call changes it)."""

    def __init__(self, step, prepare=None):
        self.step = step
        self.prepare = prepare

    def run(self, state, forcing):
        return self.step(state, forcing if self.prepare is None else self.prepare(forcing))

    def __call__(self, state, forcing, keys=None):
        state, diag = self.run(state, forcing)
        return state, (diag if keys is None else {k: diag[k] for k in keys if k in diag})

    def keep(self, state):
        return state


class GraphedStep:
    """One step of `step` (a models/step.Step, or a folded ensemble's with
    `prepare` = its tile_forcing, applied inside the captured region) as a
    captured CUDA graph on the card, replayed at every call after the first
    (module docstring); on the CPU the same static-buffer step run eagerly.

    After the capture: `capture_seconds`, `pool_bytes` (the device memory the
    graph's private pool reserved) and `captured` (the kernel launches of one
    replay, by kernel)."""

    def __init__(self, step, prepare=None):
        self.step = copy.copy(step)
        # the graph's own segment orders: their scratch serves its replays
        self.step.params = {k: v.own_scratch() if isinstance(v, SegmentOrder) else v
                            for k, v in step.params.items()}
        self.prepare = prepare
        self.device = step.device
        self.keys = state_keys(step.cfg)
        self.state = None
        self.forcing = None
        self.graph = None
        self.diag = None
        self.captured = None
        self.capture_seconds = None
        self.pool_bytes = None
        self.stream = None

    def _load(self, state, forcing):
        """The state (where its tensors are not the static ones) and the
        forcing into the static buffers; at the first call the buffers are
        made from them."""
        if self.state is None:
            for k, v in forcing.items():
                if not torch.is_tensor(v):
                    raise TypeError(f"forcing {k!r} is a {type(v).__name__}, not a tensor: the "
                                    "captured step would keep its first value")
            for k, v in [*forcing.items(), *((k, state[k]) for k in self.keys)]:
                if v.device.type != self.device.type:
                    raise ValueError(f"{k} lies on {v.device}, the step on {self.device}")
            self.state = {k: state[k].clone() for k in self.keys}
            self.forcing = {k: v.clone() for k, v in forcing.items()}
            return
        if set(forcing) != set(self.forcing):
            raise KeyError(f"forcing keys {sorted(set(forcing) ^ set(self.forcing))} differ "
                           "from the captured step's")
        for buffers, new in ((self.state, {k: state[k] for k in self.keys}),
                             (self.forcing, forcing)):
            for k, v in new.items():
                b = buffers[k]
                if v is b:
                    continue
                if not torch.is_tensor(v) or v.shape != b.shape or v.dtype != b.dtype \
                        or v.device != b.device:
                    raise TypeError(f"{k}: {getattr(v, 'shape', type(v).__name__)} "
                                    f"{getattr(v, 'dtype', '')} on {getattr(v, 'device', '')}, "
                                    f"the captured step's buffer {tuple(b.shape)} {b.dtype} on "
                                    f"{b.device}")
                b.copy_(v)

    def _body(self):
        """The captured region: the step on the static buffers, then the new
        state copied into the static state. Diagnostics and new state entries
        that alias a static state buffer are copied before the state moves
        on. Returns the step's diagnostics."""
        f = self.forcing if self.prepare is None else self.prepare(self.forcing)
        new, diag = self.step(self.state, f)
        static = {_storage(v) for v in self.state.values()}
        aliased = lambda v: torch.is_tensor(v) and _storage(v) in static
        diag = {k: v.clone() if aliased(v) else v for k, v in diag.items()}
        new = {k: v.clone() if v is not self.state[k] and aliased(v) else v
               for k, v in new.items()}
        for k, v in new.items():
            b = self.state[k]
            if v is b:
                continue
            if v.shape != b.shape or v.dtype != b.dtype:
                raise TypeError(f"state {k}: the step returns {tuple(v.shape)} {v.dtype}, its "
                                f"buffer is {tuple(b.shape)} {b.dtype}")
            b.copy_(v)
        return diag

    def _warm_up_and_capture(self):
        """The first call: the body run eagerly on the capture stream (this
        call's step), then the capture. Returns the warm-up's diagnostics."""
        self.stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            diag = self._body()
        current.wait_stream(self.stream)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()

        def capture():
            with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="thread_local"):
                reserved = torch.cuda.memory_reserved(self.device)
                self.diag = self._body()
            return reserved

        try:
            reserved, self.captured = counted_apart(capture)
        except Exception as err:
            raise RuntimeError(f"capturing the step failed at {_failed_at(err)}") from err
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph = graph
        return diag

    def run(self, state, forcing):
        """One step from `state` with `forcing`: (the static state, the
        graph's diagnostic buffers), both overwritten by the next call."""
        self._load(state, forcing)
        if self.device.type != "cuda":
            return dict(self.state), self._body()
        if self.graph is None:
            return dict(self.state), self._warm_up_and_capture()
        self.graph.replay()
        add_launches(self.captured)
        return dict(self.state), self.diag

    def __call__(self, state, forcing, keys=None):
        """run, with copies of the diagnostics among `keys` (every one where
        None)."""
        state, diag = self.run(state, forcing)
        keys = diag.keys() if keys is None else [k for k in keys if k in diag]
        return state, {k: diag[k].clone() if torch.is_tensor(diag[k]) else diag[k] for k in keys}

    def keep(self, state):
        """A copy of `state` that no later call changes."""
        return {k: v.clone() for k, v in state.items()}


def stepper(step, prepare=None):
    """The step as the entry points run it: a GraphedStep on the card, the
    eager step (EagerStep) on the CPU."""
    if step.device.type == "cuda":
        return GraphedStep(step, prepare)
    return EagerStep(step, prepare)

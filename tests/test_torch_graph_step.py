"""The step as one captured CUDA graph (lisflood_tpu_torch/models/graph.py)
on the CPU, where nothing is captured: the captured region's body, the
static-buffer step (forcing and state copied into static buffers, the step,
the new state copied back), runs eagerly at each call of a GraphedStep and
is held bit for bit, state and every diagnostic of every day, to the eager
step on six paths (main, all options, the InitLisflood prerun, RoutingKernel
sharded and scan on a 48x40 write_catchment, a 2-member folded ensemble);
fields kept from a day do not change when the next day runs; the operation
record of two days of the every-option step that differ in the calendar,
LAI interval, month end, water fraction's month and inflow is the same and
reads no value back on the host, so no day's value is baked into a
capture; the launch counters' capture arithmetic and K7's stream guard;
build_multi_step against the JAX package's (lax.scan) within 1e-10 in
float64; run_scanned's chunking changes no bit of what it writes."""
import dataclasses
import datetime
import functools
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp
from lisflood_tpu.models.step import build_multi_step as jax_build_multi_step
from lisflood_tpu.models.synthetic import build_synthetic_model as jax_synthetic_model
from lisflood_tpu_torch.config import load_settings
from lisflood_tpu_torch.device import to_device
from lisflood_tpu_torch.io import csf
from lisflood_tpu_torch.io.tss import read_tss
from lisflood_tpu_torch.models import graph
from lisflood_tpu_torch.models.convert import from_reference
from lisflood_tpu_torch.models.driver import LisfloodRunner
from lisflood_tpu_torch.models.ensemble import EnsembleRunner, tile_forcing
from lisflood_tpu_torch.models.initial import build_model, meteo_forcing
from lisflood_tpu_torch.models.step import build_multi_step, build_step
from lisflood_tpu_torch.models.synthetic import (EVERY_OPTION, build_synthetic_model,
                                                 synthetic_forcing, with_options,
                                                 write_catchment)
from lisflood_tpu_torch.ops import kinwave, kinwave_packed, kinwave_sharded, kinwave_substep
from lisflood_tpu_torch.ops import physics, routing_ops, segment_sum
from lisflood_tpu_torch.ops.segment_sum import SegmentOrder, _claim_stream

DAYS = 3
DT = torch.float64


def synthetic_days(cfg, aux, n=DAYS):
    """n days of forcing that differ in every entry: the meteo, the
    calendar day, the LAI interval and, with the options, the inflow and the
    month end (every other day)."""
    days = []
    for t in range(n):
        f = {**synthetic_forcing(cfg.num_pixels, seed=t), **aux.get("forcing_options", {})}
        f["CalendarDay"] = np.float64(150 + 17 * t)
        f["LAIInterval"] = np.int32(12 + t)
        if "QInM3" in f:
            f["QInM3"] = f["QInM3"] * (1.0 + 0.5 * t)
            f["MonthEnd"] = np.bool_(t % 2 == 1)
        days.append(to_device(f, "cpu", DT))
    return days


@pytest.fixture(scope="module")
def synthetic():
    return build_synthetic_model(16, 16)


@pytest.fixture(scope="module")
def catchment(tmp_path_factory):
    """A 48x40 catchment (split routing, lakes, reservoirs, open-water
    evaporation, mass-balance reports) with its outputs bound, 5 days."""
    path = write_catchment(tmp_path_factory.mktemp("graph"), 48, 40, seed=0, n_steps=5,
                           outputs=True)
    settings = load_settings(path)
    model = build_model(settings)
    days = [to_device(f, "cpu", DT) for f in meteo_forcing(settings, model[0], model[3])]
    return path, model, days


def path_case(name, synthetic, catchment):
    """(step, prepared state, days of forcing, prepare) of a path."""
    if name in ("sharded", "scan"):
        _, (cfg, params, state, aux), days = catchment
        extra = {"num_shards": 2} if name == "sharded" else {}
        step, _ = build_step(dataclasses.replace(cfg, routing_kernel=name, **extra), params, aux,
                             DT, "cpu")
        return step, step.prepare_state(state), days[:DAYS], None
    cfg, params, state, aux = with_options(synthetic) if name == "all-options" else synthetic
    days = synthetic_days(cfg, aux)
    if name == "ensemble":
        ens = EnsembleRunner((cfg, params, state, aux), 2, seed=3, dtype=DT, device="cpu")
        return ens.step, ens.state, days, functools.partial(tile_forcing, M=2, P=cfg.num_pixels)
    if name == "prerun":
        cfg = dataclasses.replace(cfg, init_lisflood=True)
    step, _ = build_step(cfg, params, aux, DT, "cpu")
    return step, step.prepare_state(state), days, None


def bits(v):
    """A tensor as integers of its bits (NaNs compare)."""
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}
    return v.view(ints[v.dtype]) if v.dtype in ints else v


def assert_same_bits(got, want, what):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, w in want.items():
        if torch.is_tensor(w):
            assert torch.equal(bits(got[k]), bits(w)), (what, k)
        else:
            assert got[k] == w, (what, k)


@pytest.mark.parametrize("name", ["main", "all-options", "prerun", "sharded", "scan",
                                  "ensemble"])
def test_static_buffer_body_bitwise(synthetic, catchment, name):
    """The GraphedStep's body against the eager step from the same state over
    DAYS days: every state entry and every diagnostic, bit for bit."""
    step, state, days, prepare = path_case(name, synthetic, catchment)
    graphed = graph.GraphedStep(step, prepare)
    s_e, s_g = state, state
    for i, f in enumerate(days):
        s_e, d_e = step(s_e, f if prepare is None else prepare(f))
        s_g, d_g = graphed(s_g, f)
        assert_same_bits(s_g, s_e, (name, i, "state"))
        assert_same_bits(d_g, d_e, (name, i, "diagnostics"))
    assert graphed.graph is None and graphed.captured is None


def test_kept_fields_do_not_change(synthetic):
    """What a caller keeps from day 1 (the diagnostics GraphedStep copies
    out, among them the forcing that seeds them and a state entry passed
    through, and `keep` of the state) is the same after day 2 runs on the
    same static buffers; the inflow of the last step (QInM3OldLoop, the
    static state's own QInM3Old) is day 1's inflow on day 2, as in the eager
    step; through build_multi_step and EnsembleRunner.advance as well."""
    cfg, params, state, aux = with_options(synthetic)
    days = synthetic_days(cfg, aux)
    step, _ = build_step(cfg, params, aux, DT, "cpu")
    graphed = graph.GraphedStep(step)
    s1, d1 = graphed(step.prepare_state(state), days[0])
    kept_state = graphed.keep(s1)
    snap = ({k: v.clone() for k, v in d1.items()}, {k: v.clone() for k, v in kept_state.items()})
    _, d2 = graphed(s1, days[1])
    assert_same_bits(d1, snap[0], "day 1's diagnostics")
    assert_same_bits(kept_state, snap[1], "day 1's state")
    assert torch.equal(d1["CalendarDay"], days[0]["CalendarDay"])
    assert torch.equal(bits(d2["QInM3OldLoop"]), bits(days[0]["QInM3"]))
    assert torch.equal(bits(d2["QInM3Old"]), bits(days[1]["QInM3"]))

    multi, _ = build_multi_step(cfg, params, aux, output_keys=("ChanQAvg",), dtype=DT,
                                device="cpu")
    stack = {k: torch.stack([f[k] for f in days[:2]]) for k in days[0]}
    s_a, outs_a = multi(multi.prepare_state(state), stack)
    held = ({k: v.clone() for k, v in s_a.items()}, outs_a["ChanQAvg"].clone())
    multi(s_a, stack)
    assert_same_bits(s_a, held[0], "build_multi_step's state")
    assert torch.equal(bits(outs_a["ChanQAvg"]), bits(held[1]))

    ens = EnsembleRunner((cfg, params, state, aux), 2, seed=3, dtype=DT, device="cpu")
    s_e, d_e = ens.advance(stack)
    held = ({k: v.clone() for k, v in s_e.items()}, {k: v.clone() for k, v in d_e.items()})
    ens.advance(stack)
    assert_same_bits(s_e, held[0], "the ensemble's state")
    assert_same_bits(d_e, held[1], "the ensemble's diagnostics")


def describe(x):
    """An operation argument as the record holds it: a tensor by shape and
    dtype, containers item by item, anything else by its repr."""
    if torch.is_tensor(x):
        return ("tensor", tuple(x.shape), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(describe(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, describe(v)) for k, v in sorted(x.items()))
    return repr(x)


class Record(TorchDispatchMode):
    """The ATen operations of a run: name, arguments (describe); a kernel
    wrapper's call is one entry (`opaque`), its plain version unrecorded."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            self.ops.append((str(func), describe(args), describe(kwargs or {})))
        return func(*args, **(kwargs or {}))

    def opaque(self, name, fn):
        def call(*args):
            self.ops.append((name, describe([a for a in args if not isinstance(a, SegmentOrder)])))
            self.paused = True
            try:
                return fn(*args)
            finally:
                self.paused = False
        return call


@pytest.fixture(scope="module")
def every_option(tmp_path_factory):
    """A 48x40 catchment with every option from maps (synthetic.EVERY_OPTION:
    inflow, the indicators, the variable water fraction, transient land use,
    drained irrigation, ...) on 31/12/1999 and 01/01/2000, across a month
    and a year end: (cfg, params, state, aux) and the 2 days of forcing."""
    path = write_catchment(tmp_path_factory.mktemp("every"), 48, 40, seed=3, n_steps=2,
                           options=EVERY_OPTION, start=datetime.date(1999, 12, 31))
    settings = load_settings(path)
    model = build_model(settings)
    return model, [to_device(f, "cpu", DT) for f in meteo_forcing(settings, model[0], model[3])]


# operations that read a tensor's value back on the host: a captured step
# refuses them
HOST_READS = ("aten._local_scalar_dense", "aten.nonzero", "aten.is_nonzero", "aten.item")


def test_two_days_record_the_same_operations(every_option, monkeypatch):
    """The body of the every-option step on 31/12/1999 and 01/01/2000, days
    that differ in CalendarDay, LAIInterval, MonthEnd (the indicators on),
    VarWMonth and the inflow: the same operations on the same shapes,
    dtypes and non-tensor arguments, and none that reads a value back on
    the host. A value the host took from a day would show as an argument
    that differs; a capture would freeze it."""
    (cfg, params, state, aux), days = every_option
    assert cfg.indicator and cfg.water_use and cfg.inflow and cfg.var_fraction_water
    for k in ("CalendarDay", "LAIInterval", "MonthEnd", "VarWMonth", "QInM3"):
        assert not torch.equal(days[0][k], days[1][k]), k
    step, _ = build_step(cfg, params, aux, DT, "cpu")
    graphed = graph.GraphedStep(step)
    s = step.prepare_state(state)
    record = Record()
    wrappers = [(kinwave_substep, "kinwave_substep"), (routing_ops, "kinwave_substep"),
                (kinwave_packed, "kinwave_sweep"), (kinwave_sharded, "kinwave_sharded_sweep"),
                (kinwave, "kinwave_sharded_sweep"), (segment_sum, "_run"),
                (physics, "soil_tail")]
    for module, name in wrappers:
        monkeypatch.setattr(module, name, record.opaque(name, getattr(module, name)))
    records = []
    for f in days:
        graphed._load(s, f)
        record.ops = []
        with record:
            graphed._body()
        records.append(record.ops)
        s = graphed.state
    names = [op[0] for op in records[0]]
    assert names.count("kinwave_substep") == 1 and names.count("kinwave_sweep") == 1
    assert names.count("soil_tail") == 1 and names.count("_run") > 0 and len(names) > 500
    assert not [n for n in names if n.startswith(HOST_READS)]
    assert records[0] == records[1]


def test_forcing_must_be_tensors(synthetic):
    """A forcing entry that is not a tensor is refused: a capture would keep
    its first value."""
    cfg, params, state, aux = synthetic
    step, _ = build_step(cfg, params, aux, DT, "cpu")
    f = dict(synthetic_days(cfg, aux, 1)[0])
    f["CalendarDay"] = 150.0
    with pytest.raises(TypeError, match="CalendarDay"):
        graph.GraphedStep(step)(step.prepare_state(state), f)


def test_launch_counter_arithmetic():
    """counted_apart takes what the wrappers counted during a capture back
    out of their counters and returns it; add_launches adds it at a replay."""
    start = graph.launch_counts()
    try:
        graph.set_launches(dict.fromkeys(start, 5))

        def capture():
            kinwave_substep.kinwave_substep.launches += 1
            segment_sum.segment_total.launches += 13
            kinwave_sharded.kinwave_sharded_sweep.launches += 25
            return "graph"

        out, captured = graph.counted_apart(capture)
        assert out == "graph" and graph.launch_counts() == dict.fromkeys(start, 5)
        assert captured == {"kinwave_substep": 1, "kinwave_sweep": 0, "kinwave_sharded": 25,
                            "segment_sum": 13, "soil_tail": 0}
        for _ in range(3):
            graph.add_launches(captured)
        assert graph.launch_counts() == {"kinwave_substep": 8, "kinwave_sweep": 5,
                                         "kinwave_sharded": 80, "segment_sum": 44,
                                         "soil_tail": 5}
    finally:
        graph.set_launches(start)


def test_segment_order_stream_guard():
    """K7's guard on fake stream handles: an order serves the stream of its
    first call; a call made while capturing claims it for the graph, after
    which an eager call raises, and so does a capture on another stream;
    own_scratch is the same order with zeroed scratch of its own, on no
    stream yet."""
    order = SegmentOrder.build(np.repeat(np.arange(3), 1500), 3)
    assert order.n_multi_items > 0
    _claim_stream(order, 0x10)
    _claim_stream(order, 0x10)
    with pytest.raises(RuntimeError, match="stream"):
        _claim_stream(order, 0x20)
    mine = order.own_scratch()
    assert mine.tickets is not order.tickets and mine.partial is not order.partial
    assert not mine.stream and not bool(mine.tickets.any())
    assert torch.equal(mine.perm, order.perm) and mine.items is order.items
    _claim_stream(mine, 0x30)
    _claim_stream(mine, 0x30, capturing=True)
    with pytest.raises(RuntimeError, match="captured"):
        _claim_stream(mine, 0x30)
    with pytest.raises(RuntimeError, match="stream"):
        _claim_stream(mine, 0x40, capturing=True)
    _claim_stream(order, 0x10)
    values = torch.arange(4500, dtype=torch.float64)
    assert torch.equal(segment_sum.segment_total(values, mine),
                       segment_sum.segment_total(values, order))


def test_multi_step_matches_jax_scan():
    """The port's build_multi_step over 4 steps against the JAX package's
    lax.scan (its sequential `substeps` routing), the same NumPy inputs
    carried across by from_reference: the end state and the stacked
    outputs within 1e-10 of each field's max in float64."""
    cfg, params, state, aux = jax_synthetic_model(16, 16)
    days = [synthetic_forcing(cfg.num_pixels, seed=t) for t in range(4)]
    stack_np = {k: np.stack([f[k] for f in days]) for k in days[0]}
    keys = ("ChanQAvg", "DischargeM3Out", "LakeStorageM3")
    multi_j, _ = jax_build_multi_step(dataclasses.replace(cfg, routing_pipeline="substeps"),
                                      params, aux, output_keys=keys, dtype=jnp.float64)
    cv = lambda v: jnp.asarray(v, jnp.float64 if np.asarray(v).dtype.kind == "f" else None)
    s_j, outs_j = multi_j(multi_j.prepare_state({k: cv(v) for k, v in state.items()}),
                          {k: cv(v) for k, v in stack_np.items()})
    ref = {k: np.asarray(v) for k, v in multi_j.natural_state(s_j).items()}
    ref.update({"out$" + k: np.asarray(v) for k, v in outs_j.items()})

    cfg_t, _, s_t, _ = from_reference(cfg, params, state, aux, device="cpu", dtype=DT)
    multi, _ = build_multi_step(cfg_t, params, {k: aux[k] for k in ("schedule_kin",
                                                                    "schedule_tochan")},
                                output_keys=keys, dtype=DT, device="cpu")
    s, outs = multi(s_t, to_device(stack_np, "cpu", DT))
    got = {k: v.numpy() for k, v in multi.natural_state(s).items()}
    got.update({"out$" + k: v.numpy() for k, v in outs.items()})
    assert set(got) == set(ref) and outs["ChanQAvg"].shape == (4, cfg.num_pixels)
    for k, r in ref.items():
        if r.dtype.kind == "f":
            scale = max(float(np.abs(r).max()), 1e-30)
            assert float(np.abs(got[k] - r).max()) <= 1e-10 * scale, k
        else:
            np.testing.assert_array_equal(got[k], r, err_msg=k)


def same_outputs(a, b):
    """The output directories hold the same files, every TSS (ids, steps,
    rows) and every map with the same bits."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        fa, fb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".tss"):
            (ia, ra, sa), (ib, rb, sb) = read_tss(fa), read_tss(fb)
            assert ia == ib and np.array_equal(sa, sb) and np.array_equal(ra, rb), name
        else:
            ma, mb = csf.read_map(fa), csf.read_map(fb)
            assert np.array_equal(ma.mv_mask, mb.mv_mask), name
            assert np.array_equal(ma.data, mb.data, equal_nan=True), name
    return names


def test_run_scanned_chunking_changes_no_bit(catchment, tmp_path):
    """run_scanned with chunks of 2 days over 5 (a short last chunk) writes
    what chunks of 16 write, bit for bit, and ends in the same state."""
    path = catchment[0]
    states = {}
    for chunk in (2, 16):
        out = tmp_path / f"chunk{chunk}"
        out.mkdir()
        runner = LisfloodRunner(load_settings(path, vars_to_set={"PathOut": str(out)}),
                                device="cpu")
        assert len(runner.dates) == 5
        states[chunk] = runner.run_scanned(chunk_steps=chunk)
    names = same_outputs(tmp_path / "chunk2", tmp_path / "chunk16")
    assert "dis.tss" in names and any(n.endswith(".map") for n in names)
    assert_same_bits(states[2], states[16], "end state")

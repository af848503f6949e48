"""A run driven on the CPU past the look for a card, on a small grid, with
its timed path broken underneath: `correct` has to come out false for each
fault a cell can have (a step that returns its state unchanged, half of an
ensemble's members left unadvanced, an answer altered where it is
produced: over the whole field, or at one outlet alone), true for the sound
program, and the control (the reference in bfloat16 in the program's
place, judged by the same verdict) has to come out not correct. The program
runs in float64 here, so that the sound run sits far inside the limits set
for the float32 card."""
import time

import numpy as np
import pytest
import torch

from cardbench import run
from cardbench.tests.conftest import small


def overrides(cell, **traffic):
    o = small(cell, **traffic)
    o["config"]["dtype"] = "float64"
    return o


def run_small(cell, fault=None, control=False, **traffic):
    return run.run_cell(cell, 2**31 + 12345, 0.01, False, device="cpu", t0=time.perf_counter(),
                        overrides=overrides(cell, **traffic), fault=fault, control=control)


def breaking(change):
    """A fault: the program's step, its new state passed through
    change(old, new)."""
    def fault(ctx):
        stepper = ctx.prog.stepper
        step = stepper.step

        def broken(s, f):
            new, diag = step(s, f)
            return change(s, dict(new)), diag
        stepper.step = broken
    return fault


def unchanged(old, new):
    return {k: old[k] for k in new}


def altered(old, new):
    key = "pk$ChanQ" if "pk$ChanQ" in new else "ChanQ"
    new[key] = new[key] * 1.01
    return new


def at_outlet(ctx):
    """A fault: the program's step, ChanQ 10% off at one pixel alone, the
    outlet (a pit of the channel graph) of largest discharge."""
    down = np.asarray(ctx.gen.reference_model(ctx.inputs)["down_order"])
    outlets = torch.as_tensor(np.flatnonzero(down < 0))
    step = ctx.prog.step

    def change(old, new):
        q = step.natural_state(new)["ChanQ"].reshape(-1)
        value = q[outlets[int(q[outlets].argmax())]]
        key = "pk$ChanQ" if "pk$ChanQ" in new else "ChanQ"
        v = new[key].clone()
        assert int((v == value).sum()) == 1
        v[v == value] = value * 1.1
        new[key] = v
        return new
    breaking(change)(ctx)


def half_members(M, chunk):
    def change(old, new):
        for k, v in new.items():
            if v.dim() == 0 or k == "TimeSinceStart":
                continue
            shape = (-1, M, chunk) if k.startswith("pk$") else tuple(v.shape[:-1]) + (M, -1)
            v = v.clone()
            v.reshape(shape)[..., M // 2:, :] = old[k].reshape(shape)[..., M // 2:, :]
            new[k] = v
        return new
    return change


@pytest.mark.parametrize("cell", ["continental.single", "catchment.packed", "catchment.scan",
                                  "continental.ens8"])
def test_sound_run_is_correct_and_control_fails(cell):
    r = run_small(cell, control=True, **({"members": 2} if cell.endswith("ens8") else {}))
    assert r["correct"] and r["failed"] == 0
    assert not r["control"]["correct"]
    assert any(v["value"] > v["limit"] for v in r["control"]["check"].values())


@pytest.mark.parametrize("cell", ["continental.single", "catchment.packed", "catchment.scan"])
@pytest.mark.parametrize("change", [unchanged, altered], ids=["unchanged", "altered"])
def test_broken_step_is_not_correct(cell, change):
    r = run_small(cell, fault=breaking(change))
    assert not r["correct"]


@pytest.mark.parametrize("cell", ["continental.single", "catchment.packed", "catchment.scan"])
def test_fault_at_one_outlet_is_not_correct(cell):
    """On a grid of 1,920 cells, where the quantile of day_gap is not the
    largest entry, one outlet's discharge 10% off passes day_gap and fails
    site_gap."""
    o = overrides(cell)
    o["config"].update(nrows=48, ncols=40)
    r = run.run_cell(cell, 2**31 + 4321, 0.01, False, device="cpu", t0=time.perf_counter(),
                     overrides=o, fault=at_outlet)
    check = r["check"]
    assert not r["correct"]
    assert check["day_gap"]["value"] <= check["day_gap"]["limit"]
    assert check["site_gap"]["value"] > check["site_gap"]["limit"]


def test_ensemble_half_members_unadvanced_is_not_correct():
    sound = run_small("continental.ens8", members=2)
    assert sound["correct"]
    r = run_small("continental.ens8", fault=breaking(half_members(2, 64)), members=2)
    assert not r["correct"] and r["failed"] >= 1


@pytest.mark.card
def test_cell_on_the_card(card):
    """One short run of the first cell on the card, correct."""
    r = run.run_cell("continental.single", 2**31 + 99, 2.0, False, t0=time.perf_counter())
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert torch.cuda.max_memory_allocated() > 0

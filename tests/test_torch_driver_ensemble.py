"""The port's settings-driven ensemble (lisflood_tpu_torch/models/ensemble.py
run_from_settings and run_montecarlo, through models/driver.lisfloodexe) on
a catchment of models/synthetic.write_catchment (48x40 cells, netCDF-4,
outputs bound), on the CPU.

The JAX package's ensemble cannot be held value by value: it perturbs with
jax.random (the port with a torch.Generator) and steps through
jax.jit(jax.vmap(step)), which is off by up to 2.9% on XLA's CPU backend
(ROADMAP.md Queue 3). So its layout is held to the JAX package's — the
per-member directories, their TSS and map file names and TSS headers, the
`stateVar_{m}_{step}.npz` dumps' names, keys, shapes and dtypes — and its
values to the port's single runs: each member's outputs up to the filter
step equal a LisfloodRunner's run from that member's perturbed start, and
each run_montecarlo member's end state the single run from its start, in
float64 within 1e-10 (CrossSection2Area on the Chan2M3Kin/4000 scale, as
in tests/test_torch_driver.py). The analysis itself is held to the JAX
package's in tests/test_torch_ensemble.py."""
import os
import re

import numpy as np
import pytest
import torch

from lisflood_tpu.config import load_settings as jax_load_settings
from lisflood_tpu.models.driver import lisfloodexe as jax_lisfloodexe
from lisflood_tpu_torch.config import load_settings
from lisflood_tpu_torch.io import csf
from lisflood_tpu_torch.io.tss import read_tss
from lisflood_tpu_torch.models.driver import LisfloodRunner, lisfloodexe
from lisflood_tpu_torch.models.ensemble import EnsembleRunner, run_montecarlo
from lisflood_tpu_torch.models.synthetic import write_catchment

DAYS, MEMBERS, FILTER_STEP = 4, 3, 2


@pytest.fixture(scope="module")
def catchment(tmp_path_factory):
    """The main path's catchment with MonteCarlo and EnKF on, EnsMembers 3
    and one filter step, after day 2 of 4; meteo as netCDF-4 stacks."""
    return write_catchment(tmp_path_factory.mktemp("ensemble"), 48, 40, seed=0, n_steps=DAYS,
                           outputs=True, meteo_format="netcdf",
                           options={"MonteCarlo": True, "EnKF": True},
                           user={"EnsMembers": MEMBERS, "FilterSteps": FILTER_STEP})


@pytest.fixture(scope="module")
def runs(catchment, tmp_path_factory):
    """Both packages' lisfloodexe of the ensemble's settings, each into its
    own PathOut: (JAX output dir, port output dir, the port's settings)."""
    out = tmp_path_factory.mktemp("ensemble_runs")
    dirs = [os.path.join(out, pkg) for pkg in ("jax", "port")]
    for d in dirs:
        os.makedirs(d)
    # the JAX package's sequential sub-step scan (a binding the port ignores)
    js = jax_load_settings(catchment, sys_args=["-v"],
                           vars_to_set={"PathOut": dirs[0], "RoutingPipeline": "substeps"})
    ts = load_settings(catchment, sys_args=["-v"], vars_to_set={"PathOut": dirs[1]})
    assert ts.ens_members == MEMBERS and ts.filter_steps == [FILTER_STEP]
    jax_lisfloodexe(js)
    lisfloodexe(ts, device="cpu")
    return dirs[0], dirs[1], ts


def _tss_header(path):
    with open(path) as fh:
        lines = fh.read().splitlines()
    return [re.sub(r"settingsfile: .* date: .*", "", lines[0])] + lines[1:2 + int(lines[1])]


def test_layout_against_jax(runs):
    """The same directories and file names, per member and at the top
    (only stateVar/ there), the same TSS headers (but the settings path and
    date) and rows' steps, and the same dumps: names, keys, shapes and
    dtypes."""
    jax_dir, port_dir, _ = runs
    assert sorted(os.listdir(jax_dir)) == sorted(os.listdir(port_dir)) == [
        "1", "2", "3", "stateVar"]
    for m in ("1", "2", "3"):
        names = sorted(os.listdir(os.path.join(jax_dir, m)))
        assert names == sorted(os.listdir(os.path.join(port_dir, m)))
        assert "dis.tss" in names and "chanqend.map" in names and "lz000000.004" in names
        for n in names:
            if n.endswith(".tss"):
                a, b = os.path.join(jax_dir, m, n), os.path.join(port_dir, m, n)
                assert _tss_header(a) == _tss_header(b), n
                assert np.array_equal(read_tss(a)[2], read_tss(b)[2]), n
    dumps = sorted(os.listdir(os.path.join(jax_dir, "stateVar")))
    assert dumps == [f"stateVar_{m}_{FILTER_STEP}.npz" for m in (1, 2, 3)]
    assert dumps == sorted(os.listdir(os.path.join(port_dir, "stateVar")))
    for n in dumps:
        with np.load(os.path.join(jax_dir, "stateVar", n)) as a, \
                np.load(os.path.join(port_dir, "stateVar", n)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, (n, k)


def _held(key, ref, got, state):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape and np.array_equal(np.isnan(ref), np.isnan(got)), key
    if key in ("CrossSection2Area", "crosssection2end"):
        scale = np.abs(np.asarray(state["Chan2M3Kin"])).max() / 4000.0
    else:
        scale = max(float(np.nanmax(np.abs(ref))) if ref.size else 0.0, 1e-30)
    assert np.nanmax(np.abs(ref - got)) / scale <= 1e-10, key


def _single_run(settings, start_state):
    """A LisfloodRunner's run_scanned of `settings` from `start_state` (a
    member's state in the single model's layout)."""
    runner = LisfloodRunner(settings, device="cpu")
    runner.state = runner.step.prepare_state(start_state)
    runner.run_scanned()
    return runner


def _starts(settings):
    """The members' perturbed starts, as run_from_settings draws them."""
    runner = LisfloodRunner(settings, device="cpu")
    try:
        return EnsembleRunner.from_runner(runner, MEMBERS, seed=0).member_states()
    finally:
        runner.forcing.close()


def test_members_equal_single_runs(runs, tmp_path):
    """Each member's TSS rows and LZ maps up to the filter step, and its dump
    there, equal a single run of the first two days from the member's
    perturbed start."""
    _, port_dir, settings = runs
    for m, start in enumerate(_starts(settings), 1):
        single_dir = os.path.join(tmp_path, str(m))
        os.makedirs(single_dir)
        s = load_settings(settings.settings_path, opts_to_unset=["MonteCarlo", "EnKF"],
                          vars_to_set={"PathOut": single_dir, "StepEnd": "02/01/2000 00:00"})
        single = _single_run(s, start)
        member_dir = os.path.join(port_dir, str(m))
        for n in os.listdir(single_dir):
            a, b = os.path.join(single_dir, n), os.path.join(member_dir, n)
            if n.endswith(".tss"):
                (ia, da, sa), (ib, db, sb) = read_tss(a), read_tss(b)
                assert ia == ib and list(sa) == [1, 2] and list(sb[:2]) == [1, 2], n
                _held(n, da, db[:2], single.state)
            elif n.startswith("lz0"):
                ma, mb = csf.read_map(a), csf.read_map(b)
                _held(n, np.where(ma.mv_mask, np.nan, ma.data),
                      np.where(mb.mv_mask, np.nan, mb.data), single.state)
        with np.load(os.path.join(port_dir, "stateVar", f"stateVar_{m}_{FILTER_STEP}.npz")) as d:
            dump = single.step.natural_state({k: torch.as_tensor(d[k]) for k in d.files})
        for k, v in single.state.items():
            _held(k, v.numpy(), dump[k].numpy(), single.state)


def test_run_montecarlo_members(catchment, tmp_path):
    """run_montecarlo without outputs over the first two days: every member's
    end state equals the single run from its start."""
    s = load_settings(catchment, opts_to_unset=["MonteCarlo", "EnKF"],
                      vars_to_set={"PathOut": str(tmp_path), "StepEnd": "02/01/2000 00:00"})
    starts = _starts(s)
    ens = run_montecarlo(LisfloodRunner(s, device="cpu"), MEMBERS, seed=0)
    assert ens.outputs is None and os.listdir(tmp_path) == []
    for m, (start, end) in enumerate(zip(starts, ens.member_states())):
        single = _single_run(s, start)
        natural = single.step.natural_state({k: torch.as_tensor(v) for k, v in end.items()})
        assert set(natural) == set(single.state)
        for k, v in single.state.items():
            _held(k, v.numpy(), natural[k].numpy(), single.state)
        for k in ("LZ", "W1a"):
            assert not np.array_equal(start[k], starts[(m + 1) % MEMBERS][k]), k

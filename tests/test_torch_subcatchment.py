"""A subcatchment run of the port (MaskMap bound to a subcatchment's mask, as
calibration runs each subcatchment), on the CPU: the 48x40 write_catchment
with submask=True (SubMask.map, the land cells upstream of the second gauge,
on the same clone), 4 days in float64, through lisfloodexe.

Held, with the options and gate of tests/test_prerun_subcatch.py:66-94
(SplitRouting, lakes, reservoirs, open-water evaporation and drained
irrigation off):
  - the port's subcatchment run against its full run on the subcatchment's
    cells: ChanQKin, LZ, FrostIndex, W1a and UZ within rtol 1e-9, atol
    1e-10. The two runs are not bitwise in general: the schedules, chunks
    and the order of upstream sums change with the mask;
  - the port's subcatchment run against the JAX package's: the output files
    and the end state within 1e-10 of each field's max (the JAX run on its
    sequential sub-step scan, RoutingPipeline "substeps");
  - the gauges inside the subcatchment against the same gauges of the full
    run in dis.tss, at the first gate;
  - build_model on the subcatchment's mask: both packages bit for bit, with
    its channel and overland schedules, its one catchment and its
    partition into 4 shards (RoutingKernel sharded)."""
import os

import numpy as np
import pytest

from lisflood_tpu.config import load_settings as jax_load_settings
from lisflood_tpu.models.driver import lisfloodexe as jax_lisfloodexe
from lisflood_tpu.models.initial import build_model as jax_build_model
from lisflood_tpu.parallel.partition import catchment_partition as jax_partition
from lisflood_tpu_torch.config import load_settings
from lisflood_tpu_torch.io.tss import read_tss
from lisflood_tpu_torch.models.driver import lisfloodexe
from lisflood_tpu_torch.models.initial import build_model
from lisflood_tpu_torch.models.synthetic import write_catchment
from lisflood_tpu_torch.parallel.partition import catchment_partition
from test_torch_build_model import _same_arrays
from test_torch_driver import JAX_PIPELINE, held_outputs, held_state

DAYS = 4
OFF = ["SplitRouting", "simulateLakes", "simulateReservoirs", "openwaterevapo",
       "drainedIrrigation"]
SUB = {"MaskMap": "$(PathMaps)/SubMask.map"}
KEYS = ("ChanQKin", "LZ", "FrostIndex", "W1a", "UZ")


@pytest.fixture(scope="module")
def catchment(tmp_path_factory):
    return write_catchment(tmp_path_factory.mktemp("sub"), 48, 40, seed=0, n_steps=DAYS,
                           outputs=True, meteo_format="netcdf", submask=True)


def _run(pkg, path, out, **vars_to_set):
    """lisfloodexe of `pkg` into `out`, the options of the module off."""
    os.makedirs(out)
    if pkg == "jax":
        s = jax_load_settings(path, opts_to_unset=OFF, sys_args=["-v"],
                              vars_to_set={**JAX_PIPELINE, "PathOut": out, **vars_to_set})
        return jax_lisfloodexe(s)
    s = load_settings(path, opts_to_unset=OFF, sys_args=["-v"],
                      vars_to_set={"PathOut": out, **vars_to_set})
    return lisfloodexe(s, device="cpu")


@pytest.fixture(scope="module")
def runs(catchment, tmp_path_factory):
    """The port's full and subcatchment runs and the JAX package's
    subcatchment run: (runner, PathOut) by name."""
    root = tmp_path_factory.mktemp("sub_runs")
    cases = {"full": ("port", {}), "sub": ("port", SUB), "jax sub": ("jax", SUB)}
    return {name: (_run(pkg, catchment, str(root / name.replace(" ", "_")), **kw),
                   str(root / name.replace(" ", "_")))
            for name, (pkg, kw) in cases.items()}


def _on_sub(full, sub, key):
    """`key` of the full and the subcatchment run on the subcatchment's
    cells (both grids are the same clone)."""
    a = full.grid.decompress(np.asarray(full.state[key], np.float64))
    b = sub.grid.decompress(np.asarray(sub.state[key], np.float64))
    sel = ~np.isnan(b)
    return a[sel], b[sel]


def test_subcatchment_against_full(runs):
    """The subcatchment run reproduces the full run on its cells within
    rtol 1e-9, atol 1e-10."""
    (full, _), (sub, _) = runs["full"], runs["sub"]
    g_full, g_sub = full.grid, sub.grid
    assert (g_sub.nrows, g_sub.ncols, g_sub.west, g_sub.north) == \
        (g_full.nrows, g_full.ncols, g_full.west, g_full.north)
    # a mid-sized part of the catchment, with channel cells, inside it
    assert not (g_sub.land_flat & ~g_full.land_flat).any()
    assert 0.25 < g_sub.num_pixels / g_full.num_pixels < 0.75
    assert sub.params_np["IsChannel"].sum() > 50
    for key in KEYS:
        a, b = _on_sub(full, sub, key)
        np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-10, err_msg=key)


def test_subcatchment_against_jax(runs):
    """The port's subcatchment run and the JAX package's: the same files
    within the gates of tests/test_torch_driver.py, the end state within
    1e-10."""
    (jax_runner, jax_out), (port_runner, port_out) = runs["jax sub"], runs["sub"]
    names = held_outputs(jax_out, port_out, False, jax_runner.state)
    assert {"dis.tss", "lzend.map", "lz000000.004"} <= set(names)
    held_state(jax_runner.state, port_runner.state, False)



def test_subcatchment_gauge(runs):
    """The gauges inside the subcatchment (its outlet, the second gauge, and
    the third, upstream of it) read in dis.tss what they read in the full
    run, within the gate above."""
    (_, full_out), (_, sub_out) = runs["full"], runs["sub"]
    (full_ids, full_rows, full_steps) = read_tss(os.path.join(full_out, "dis.tss"))
    (sub_ids, sub_rows, sub_steps) = read_tss(os.path.join(sub_out, "dis.tss"))
    assert list(full_ids) == [1, 2, 3] and list(sub_ids) == [2, 3]
    assert np.array_equal(full_steps, sub_steps) and len(sub_steps) == DAYS
    np.testing.assert_allclose(sub_rows, full_rows[:, 1:], rtol=1e-9, atol=1e-10)


def test_subcatchment_build_model(catchment):
    """Both build_models with MaskMap the subcatchment's: params and state
    bit for bit, the schedules' chunks and downstream, Catchments, and
    catchment_partition of the channel graph at 4 shards."""
    jax_model = jax_build_model(jax_load_settings(catchment, opts_to_unset=OFF, vars_to_set=SUB))
    port_model = build_model(load_settings(catchment, opts_to_unset=OFF, vars_to_set=SUB))
    _same_arrays(jax_model, port_model)
    (_, _, _, ja), (cfg, tp, _, ta) = jax_model, port_model
    for k in ("schedule_kin", "schedule_tochan"):
        np.testing.assert_array_equal(ja[k].chunks, ta[k].chunks)
        np.testing.assert_array_equal(ja[k].downstream, ta[k].downstream)
    # one catchment: the subcatchment drains through its outlet alone
    assert cfg.num_pixels == ta["grid"].num_pixels and len(np.unique(tp["Catchments"])) == 1
    ref, _ = jax_partition(ja["graph_kin"], 4)
    got, _ = catchment_partition(ta["graph_kin"], 4)
    assert np.array_equal(got, ref)

"""The sequential sub-step loop (ops/routing_ops.channel_routing_substeps)
in the port against the JAX package's, on the cases the other routers'
tests hold: the InitLisflood prerun with the reports off,
InitLisfloodwithoutSplit, the indicators across a month end and transient
land use, each with RoutingKernel sharded on 1, 3 and 4 shards and with
RoutingKernel scan. The synthetic 24x20 model with every option of
with_options, three steps, float64, every state entry (and each case's
diagnostics) within 1e-10 of each field's max; the JAX steps run its
sequential loop (`routing_pipeline substeps`)."""
import numpy as np
import pytest
import torch

from lisflood_tpu_torch.models.step import LANDUSE_FRACTIONS
from lisflood_tpu_torch.models.synthetic import build_synthetic_model, with_options
from test_torch_prerun_options import (INDICATOR_OUTPUTS, SIZE, assert_close, forcings,
                                       run_both)

STEPS = 3
ROUTERS = {"sharded1": dict(routing_kernel="sharded", num_shards=1),
           "sharded3": dict(routing_kernel="sharded", num_shards=3),
           "sharded4": dict(routing_kernel="sharded", num_shards=4),
           "scan": dict(routing_kernel="scan", num_shards=1)}
# each case's options, diagnostics and the steps whose MonthEnd is set
CASES = {
    "prerun": (dict(init_lisflood=True, rep_total_water_storage=False, rep_mbts=False,
                    indicator=False), ("ChanQAvg", "TransCum"), ()),
    "without_split": (dict(init_lisflood_without_split=True), (), ()),
    "indicators": ({}, INDICATOR_OUTPUTS, (1,)),
    "landuse": (dict(transient_landuse=True), ("MBError", "AverageFractions", "ChanQAvg"), ()),
}


@pytest.fixture(scope="module")
def model():
    return with_options(build_synthetic_model(**SIZE))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("router", list(ROUTERS))
def test_substeps_case_matches_jax(model, router, case):
    """One case on one router: every step's state and diagnostics within
    1e-10 of each field's max."""
    options, diagnostics, month_end = CASES[case]
    ref, got, port = run_both(model, "f64", STEPS, diagnostics, month_end=month_end,
                              **ROUTERS[router], **options)
    assert port.pipeline == "substeps"
    assert not any(k.startswith("pk$") for k in got[-1])
    cfg, params, state, aux = model
    if case == "prerun":
        assert "Chan2QKin" not in got[-1] and got[-1]["CumQ"].max() > 0
    if case == "without_split":
        np.testing.assert_array_equal(got[-1]["ChanQ"], state["ChanQ"])
    if case == "indicators":
        assert [float(g["DayCounter"]) for g in got] == [1.0, 0.0, 1.0]
        assert got[2]["MonthDisM3"].max() > 0
    if case == "landuse":
        # the fractions change from step to step, the segment arrays and the
        # step's orders over them do not
        assert np.abs(got[1]["WaterInit"] - got[0]["WaterInit"]).max() > 0
        f = {k: torch.as_tensor(v) for k, v in forcings(port.cfg, aux, 1)[0].items()}
        p_f = port.step_params(f)
        assert not torch.equal(p_f["SoilFraction"], port.params["SoilFraction"])
        changed = set(LANDUSE_FRACTIONS) | {"SoilFraction", "PermeableFraction"}
        assert all(p_f[k] is v for k, v in port.params.items() if k not in changed)
        assert {"seg$Catchments", "seg$WUseRegionC"} <= set(port.params)
    for r, g in zip(ref, got):
        assert_close(r, g, 1e-10)

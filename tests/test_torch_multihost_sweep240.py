"""The synthetic 240x200 case of tests/test_torch_multihost.py's layout
checks (RoutingKernel sharded on 8 logical shards, channel edges between
ranks): its layout and K6 on each rank's tables against the one-process
sweep, bit for bit. A file of its own so that the tier-1 run (files whole
to a worker) runs it beside the rest of that file."""
import pytest
import torch

from test_torch_multihost import (build_layouts, build_rank_routers, case_id,
                                  check_layout_halo, check_rank_sweep)

LAYOUT_CASES = [("synthetic", (240, 200), 8)]


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    return build_layouts(LAYOUT_CASES, tmp_path_factory, None)


@pytest.fixture(scope="module")
def rank_routers(layouts):
    return build_rank_routers(LAYOUT_CASES, layouts)


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=case_id)
def test_layout_halo(layouts, case):
    """check_layout_halo on the case."""
    check_layout_halo(layouts, case)


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=case_id)
@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rank_sweep_bitwise(layouts, rank_routers, case, dt):
    """check_rank_sweep on the case."""
    check_rank_sweep(layouts, rank_routers, case, dt)

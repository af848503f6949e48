"""The benchmark's own tests: CPU tests of the harness, the reference and
the yardstick; tests marked `card` run only where a CUDA device is."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card runs this test (cardbench/README.md)")
    return torch.device("cuda")


# small grids of the two configurations and short traffic, for the CPU
SMALL = {"continental": {"config": {"nrows": 24, "ncols": 20, "chunk": 64}},
         "catchment": {"config": {"nrows": 24, "ncols": 20}}}
SHORT = {"warmup_calls": 1, "trace_calls": 1, "days_per_call": 2, "ring_days": 4}


def small(cell, **traffic):
    """The overrides that run `cell` on a small grid with short traffic."""
    kind = "continental" if cell.startswith("continental") else "catchment"
    return {"config": dict(SMALL[kind]["config"]), "traffic": {**SHORT, **traffic}}

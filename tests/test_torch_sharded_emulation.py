"""The plain emulation of K6's launch (tests/test_torch_sharded_tiles.py's
`emulate`, csrc/kinwave_sharded.cu block by block under its plan on an
H100) on every graph of that file at caps 1, 64 and 1024, in float32 and
float64: the bits of the plain `_sweep_sharded`, with the copies landing late
and, for the ring tiles, at once; at the default cap the wrapper on the CPU
gives them too. A file of its own so that the tier-1 run (files whole to a
worker) runs it beside the rest of test_torch_sharded_tiles.py."""
import numpy as np
import pytest
import torch

from lisflood_tpu_torch.ops import kinwave_sharded as S
from lisflood_tpu_torch.ops.wavefront import SWEEP_CAP
from test_torch_sharded_tiles import (BETA, CAPS, GRAPHS, _bits, _operands, _plain_q, _plan,
                                      _router, emulate, graphs)  # noqa: F401 (graphs: fixture)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("name", GRAPHS)
def test_emulation_bitwise(graphs, name, cap, dtype):
    """The kernel's launch, emulated under its plan on an H100 (the copies
    landing late, and at once for the ring tiles), gives the bits of the
    plain version `_sweep_sharded`; and the wrapper on the CPU runs the
    plain version."""
    _, (const_p, adx_p) = _operands(graphs, name, dtype)
    router = _router(graphs, name)
    tiles = router.sweep_tiles(cap)
    ref = _plain_q(graphs, name, dtype, const_p, adx_p)
    plan = _plan(tiles, const_p.shape[0], const_p.element_size())
    got = emulate(const_p, adx_p, tiles, plan)
    assert torch.equal(_bits(got), _bits(ref))
    if plan["ring_tiles"]:
        assert torch.equal(_bits(emulate(const_p, adx_p, tiles, plan, late=False)), _bits(ref))
    if cap == SWEEP_CAP:
        wrapped = S.kinwave_sharded_sweep(const_p, adx_p, tiles, BETA)
        assert torch.equal(_bits(wrapped), _bits(ref))

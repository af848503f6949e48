"""The frozen plain reference against the program's CPU step, float64, on a
small grid of each configuration: one day from the program's own state
after two days, every state entry within 1e-10 of its field's largest
magnitude or of 1 (the floodplain's cross-section is a difference of two
storages and near 0 on a small grid; measured 1.6e-14 on the continental
grid, 5.8e-13 on the catchment). And the reference's start against the program's: the members'
initial states bit for bit, the ensemble's perturbation included."""
import numpy as np
import pytest
import torch

from cardbench import harness
from cardbench.reference.start import members_start
from cardbench.reference.step import ReferenceModel


def program_and_inputs(config_name, router, tmp_path, members=1):
    config = harness.read_json(harness.ROOT / "cardbench" / "configs" / f"{config_name}.json")
    config.update(nrows=24, ncols=20, chunk=64)
    traffic = {"router": router, "members": members, "ring_days": 4, "days_per_call": 2,
               "perturb": ["UZ", "LZ", "W1a", "W1b", "W2"], "sigma": 0.05}
    gen = harness.generator(config)
    inputs = gen.make_inputs(config, 5, str(tmp_path), traffic)
    model = gen.build_program(torch, inputs, traffic, torch.float64, "cpu")
    prog = harness.Program(torch, model, traffic, 5, torch.float64, torch.device("cpu"))
    ring = gen.forcing_ring(torch, inputs, 4, 5, torch.device("cpu"), torch.float64)
    return gen, inputs, traffic, prog, ring


@pytest.mark.parametrize("config_name,router", [("continental_synth", "packed"),
                                                ("continental_synth", "scan"),
                                                ("catchment_maps", "packed"),
                                                ("catchment_maps", "scan")])
def test_reference_day_against_program(config_name, router, tmp_path):
    gen, inputs, traffic, prog, ring = program_and_inputs(config_name, router, tmp_path)
    state = prog.call(prog.state, {k: v[:2] for k, v in ring.items()})
    before = prog.members_natural(state)
    after = prog.members_natural(prog.call(state, {k: v[2:3] for k, v in ring.items()}))
    ref = ReferenceModel(gen.reference_model(inputs), "cpu")
    host = {k: v[2].numpy() for k, v in ring.items()}
    out = ref.step(before, gen.reference_forcing(inputs, 2, host))[0]
    for k, v in after[0].items():
        if v.dtype.kind != "f":
            continue
        r = out[k].numpy()
        scale = max(np.abs(r).max(initial=0.0), 1.0)
        assert np.abs(v - r).max(initial=0.0) <= 1e-10 * scale, k


@pytest.mark.parametrize("config_name,members", [("continental_synth", 1),
                                                 ("continental_synth", 3),
                                                 ("catchment_maps", 1)])
def test_reference_start_is_the_programs(config_name, members, tmp_path):
    gen, inputs, traffic, prog, _ = program_and_inputs(config_name, "packed", tmp_path, members)
    ref = members_start(torch, gen.reference_model(inputs)["state"], traffic, 5,
                        torch.device("cpu"), torch.float64)
    got = prog.members_natural(prog.state)
    assert len(got) == members
    for g, r in zip(got, ref):
        for k, v in g.items():
            assert np.allclose(v, r[k], rtol=1e-13, atol=0), k

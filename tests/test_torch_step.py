"""The port's model step (lisflood_tpu_torch/models/step.py) against the JAX
package's, on the synthetic model (no input files): the same NumPy inputs go
through both, the JAX side through its sequential `substeps` routing
pipeline and evaporation outside the routing loop, the port's through the
plain PyTorch version of its routing kernel on the CPU."""
import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lisflood_tpu.models.step import build_step as jax_build_step
from lisflood_tpu.models.synthetic import build_synthetic_model, synthetic_forcing
from lisflood_tpu_torch.device import to_device
from lisflood_tpu_torch.models import synthetic as port_synthetic
from lisflood_tpu_torch.models.convert import from_reference
from lisflood_tpu_torch.models.step import Step, build_multi_step, build_step

SIZE = dict(nrows=24, ncols=20, no_rout_steps=6, chunk_size=64)
DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}


def _run_both(structures, n_steps, dt, **options):
    """Natural-space states after `n_steps` steps: (JAX, port)."""
    jdt, tdt = DTYPES[dt]
    cfg, params, state, aux = build_synthetic_model(with_structures=structures, **SIZE, **options)
    forcing = synthetic_forcing(cfg.num_pixels)

    step, _ = jax_build_step(dataclasses.replace(cfg, routing_pipeline="substeps"),
                             params, aux, dtype=jdt)
    cv = lambda v: jnp.asarray(v, jdt if np.asarray(v).dtype.kind == "f" else None)
    s = step.prepare_state({k: cv(v) for k, v in state.items()})
    f = {k: cv(v) for k, v in forcing.items()}
    for _ in range(n_steps):
        s, _ = step(s, f)
    ref = {k: np.asarray(v) for k, v in step.natural_state(s).items()}

    cfg_t, p_t, s_t, routers = from_reference(cfg, params, state, aux, device="cpu", dtype=tdt)
    port = Step(cfg_t, p_t, routers, "cpu")
    f_t = to_device(forcing, "cpu", tdt)
    for _ in range(n_steps):
        s_t, _ = port(s_t, f_t)
    got = {k: v.numpy() for k, v in port.natural_state(s_t).items()}
    assert set(ref) == set(got)
    return ref, got


@pytest.fixture(scope="module")
def one_step_f32():
    return _run_both(False, 1, "f32")


@pytest.fixture(scope="module")
def two_steps_f32():
    return _run_both(True, 2, "f32")


@pytest.fixture(scope="module")
def two_steps_f64():
    return _run_both(True, 2, "f64")


def test_synthetic_build_matches_reference():
    """The port's synthetic model (NumPy schedule build) equals the JAX
    package's: config fields (but the port's ensemble fold, one member),
    every parameter and state array, schedules."""
    ref = build_synthetic_model(**SIZE)
    got = port_synthetic.build_synthetic_model(**SIZE)
    assert got[0].members == 1
    for f in dataclasses.fields(got[0]):
        if f.name != "members":
            assert getattr(got[0], f.name) == getattr(ref[0], f.name), f.name
    for r, g in ((ref[1], got[1]), (ref[2], got[2])):
        assert set(r) == set(g)
        for k in r:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(r[k]), err_msg=k)
    for k in ("schedule_kin", "schedule_tochan"):
        np.testing.assert_array_equal(got[3][k].chunks, ref[3][k].chunks)
        np.testing.assert_array_equal(got[3][k].downstream, ref[3][k].downstream)


def test_from_reference_carries_the_model():
    """from_reference: the port's config, packed parameters and state, and
    the kernel's tables; both kernel conditions hold on this schedule."""
    cfg, params, state, aux = build_synthetic_model(**SIZE)
    cfg_t, p, s, routers = from_reference(cfg, params, state, aux, device="cpu",
                                          dtype=torch.float32)
    assert cfg_t.num_pixels == cfg.num_pixels and cfg_t.split_routing
    kin = routers["kin"]
    assert kin.struct_feeders_earlier and kin.eva_window_ok
    assert s["pk$ChanQKin"].shape == (kin.ps.p_pad,) and s["pk$ChanQKin"].dtype == torch.float32
    assert p["kinp$UpsTable"].dtype == torch.int32 and p["kinp$UpsTable"].shape[1] == kin.ps.p_pad
    assert p["LakeIndex"].dtype == torch.int64 and p["Beta"] == 0.6
    np.testing.assert_array_equal(kin.unpack(s["pk$ChanQKin"]).numpy(),
                                  state["ChanQKin"].astype(np.float32))


def test_step_f32_one_step(one_step_f32):
    """float32, one step, no structures: the gates of
    tests/test_pallas_routing.py (3e-5 of each field's max; 1e-2 for the
    cancellation-amplified CrossSection2Area and Sideflow1Chan). Measured
    5.4e-6 (ChanQ) and 1.2e-3 (CrossSection2Area)."""
    ref, got = one_step_f32
    loose = {"CrossSection2Area": 1e-2, "Sideflow1Chan": 1e-2}
    for k in ref:
        err = np.abs(ref[k] - got[k]).max() / max(np.abs(ref[k]).max(), 1e-30)
        assert err < loose.get(k, 3e-5), f"{k}: {err:.3e}"


def test_step_f32_two_steps_structures(two_steps_f32):
    """float32, two chained steps with lakes and reservoirs: 1.5e-4 of each
    field's max, CrossSection2Area on the Chan2M3Kin/4000 scale, 1e-2 for
    Sideflow1Chan (tests/test_pallas_routing.py). Measured 3.2e-5 (ChanQ)."""
    ref, got = two_steps_f32
    scales = {"CrossSection2Area": np.abs(ref["Chan2M3Kin"]).max() / 4000.0}
    loose = {"Sideflow1Chan": 1e-2}
    for k in ("LakeStorageM3CC", "LakeOutflowCC", "ReservoirStorageM3CC", "ReservoirFillCC"):
        assert k in got
    for k in ref:
        err = np.abs(ref[k] - got[k]).max() / scales.get(k, max(np.abs(ref[k]).max(), 1e-30))
        assert err < loose.get(k, 1.5e-4), f"{k}: {err:.3e}"


def test_step_f64_two_steps_structures(two_steps_f64):
    """float64, two steps with structures: every field within 1e-10 of its
    max. Measured 3.4e-14 on ChanQ and 2.9e-11 on CrossSection2Area (a
    difference of near-equal ~1e4 operands)."""
    ref, got = two_steps_f64
    for k in ref:
        err = np.abs(ref[k] - got[k]).max() / max(np.abs(ref[k]).max(), 1e-30)
        assert err <= 1e-10, f"{k}: {err:.3e}"


@pytest.mark.parametrize("dt,tol", [("f32", 3e-5), ("f64", 1e-10)])
def test_step_single_routing_no_open_water(dt, tol):
    """Without split routing and open-water evaporation (the kernel's
    single-lane sub-step, no evaporation chain), with structures, two
    steps: 3e-5 of each field's max in float32 (the one-step gate; measured
    1.7e-6, on W1a), 1e-10 in float64 (measured 1.6e-15)."""
    ref, got = _run_both(True, 2, dt, split_routing=False, open_water=False)
    assert "Chan2QKin" not in got and "pk$EvaCumM3" not in got
    for k in ref:
        err = np.abs(ref[k] - got[k]).max() / max(np.abs(ref[k]).max(), 1e-30)
        assert err <= tol, f"{k}: {err:.3e}"


def test_multi_step_matches_step_loop():
    """build_multi_step returns the stacked outputs and the state of the
    same steps run one by one."""
    cfg, params, state, aux = port_synthetic.build_synthetic_model(**SIZE)
    forcing = synthetic_forcing(cfg.num_pixels)
    multi, _ = build_multi_step(cfg, params, aux, output_keys=("ChanQAvg",),
                                dtype=torch.float32, device="cpu")
    f = to_device(forcing, "cpu", torch.float32)
    stack = {k: torch.stack([v, v]) for k, v in f.items()}
    s_m, outs = multi(multi.prepare_state(state), stack)
    step = multi.step
    s = step.prepare_state(state)
    qs = []
    for _ in range(2):
        s, d = step(s, f)
        qs.append(d["ChanQAvg"])
    assert outs["ChanQAvg"].shape == (2, cfg.num_pixels)
    torch.testing.assert_close(outs["ChanQAvg"], torch.stack(qs), rtol=0, atol=0)
    for k in s:
        torch.testing.assert_close(s_m[k], s[k], rtol=0, atol=0)


def test_unported_options_refused():
    """The step's last four options build (tests/test_torch_prerun_options.py
    holds them to the JAX package), InitLisflood without the water-balance
    reports and the indicators, which it refuses as the JAX step fails on
    them; every router of the JAX package builds (`scan` with the sequential
    loop), and a router name that none has is refused."""
    cfg, params, state, aux = port_synthetic.with_options(
        port_synthetic.build_synthetic_model(**SIZE))
    prerun_off = dict(rep_total_water_storage=False, rep_mbts=False, indicator=False)
    for field in ("init_lisflood", "init_lisflood_without_split", "indicator",
                  "transient_landuse"):
        extra = prerun_off if field == "init_lisflood" else {}
        step, _ = build_step(dataclasses.replace(cfg, **{field: True}, **extra), params, aux,
                             device="cpu")
        assert getattr(step.cfg, field) and step.pipeline == "reference"
    with pytest.raises(ValueError, match="InitLisflood"):
        build_step(dataclasses.replace(cfg, init_lisflood=True), params, aux, device="cpu")
    step, _ = build_step(dataclasses.replace(cfg, routing_kernel="scan"), params, aux,
                         device="cpu")
    assert step.pipeline == "substeps"
    with pytest.raises(ValueError, match="routing_kernel"):
        build_step(dataclasses.replace(cfg, routing_kernel="pallas"), params, aux, device="cpu")


def test_default_device_needs_cuda(monkeypatch):
    """Without a CUDA device, an entry point called without device= raises
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, params, state, aux = port_synthetic.build_synthetic_model(**SIZE)
    with pytest.raises(RuntimeError):
        build_step(cfg, params, aux, dtype=torch.float32)


def test_port_imports_no_jax():
    """Every module of the port imports without JAX or the JAX package."""
    code = """
import pkgutil, sys, importlib
import lisflood_tpu_torch
for m in pkgutil.walk_packages(lisflood_tpu_torch.__path__, "lisflood_tpu_torch."):
    importlib.import_module(m.name)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "lisflood_tpu")]
assert not bad, bad
print(len([m for m in sys.modules if m.startswith("lisflood_tpu_torch")]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(__import__("pathlib").Path(__file__).resolve().parent.parent))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 48

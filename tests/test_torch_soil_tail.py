"""The soil Courant tail (lisflood_tpu_torch/ops/soil_tail.py, K8's plain
version) through the port's soil_columns_step, against the JAX package's
soil_columns_step and against tests/test_soil_courant.py's NumPy oracle, a
literal per-lane transcription of the reference's loop (soilloop.py).

The inputs are test_soil_courant's: the JAX synthetic model with near
saturated layers and scaled conductivities, so that many lanes need more
than one sub-step ("substeps": 24x20, 1,154 of 1,728 lanes, at most 18) or
some need more than the cap of max_soil_substeps = 100 ("cap": 8x8, wet
0.995, KSat x 40: 75 of 192 lanes above it, SoilCourantCapHit set in both
packages). Every output is held within 1e-10 (float64) and 3e-5 (float32)
of its field's largest magnitude; the kernel itself is held to the plain
version on the card by chip_smoke.py. The last test holds the step's LAI
selection, the main path's other read of a device value on the host until
K8, to the indexing it replaces."""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lisflood_tpu.models.step import build_step as jax_build_step
from lisflood_tpu.ops.physics import soil_columns_step as jax_soil_columns_step
from lisflood_tpu_torch.device import to_device
from lisflood_tpu_torch.models.convert import from_reference
from lisflood_tpu_torch.ops import soil_tail as st
from lisflood_tpu_torch.ops.physics import soil_columns_step
from test_soil_courant import _numpy_soil_oracle, _soil_setup

# (nrows, ncols, wet, KSat scale) of each case
CASES = {"substeps": (24, 20, 0.98, 1.0), "cap": (8, 8, 0.995, 40.0)}
DTYPES = {"f64": (jnp.float64, torch.float64, 1e-10), "f32": (jnp.float32, torch.float32, 3e-5)}
SEEPS = ("SeepTopToSubA", "SeepTopToSubB", "SeepSubToGW")


def setup(case):
    nrows, ncols, wet, boost = CASES[case]
    return _soil_setup(nrows, ncols, wet=wet, ksat_boost=boost)


def run_port(cfg, params, state, aux, d, dtype):
    """The port's soil_columns_step on the CPU, its parameters built by the
    port's build_step; also the lanes' sub-step counts the tail ran on."""
    cfg_t, p, s, _ = from_reference(cfg, params, state, aux, device="cpu", dtype=dtype)
    seen = {}
    reference = st.soil_tail_reference

    def spy(aw, seep, no_subs, dt_sub, q):
        seen["no_subs"] = no_subs.clone()
        return reference(aw, seep, no_subs, dt_sub, q)

    st.soil_tail_reference = spy
    try:
        out = soil_columns_step(cfg_t, p, s, to_device(d, "cpu", dtype))
    finally:
        st.soil_tail_reference = reference
    return out, seen["no_subs"]


def run_jax(cfg, params, state, aux, d, dtype):
    _, p = jax_build_step(cfg, params, aux, dtype=dtype)
    cast = lambda v: jnp.asarray(v, dtype if np.asarray(v).dtype.kind == "f" else None)
    return jax_soil_columns_step(cfg, p, {k: cast(v) for k, v in state.items()},
                                 {k: cast(v) for k, v in d.items()})


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax(case, dt):
    """Every output of the port's soil_columns_step against the JAX
    package's on the same inputs, with the sub-steps forced and with the
    cap binding; SoilCourantCapHit the same in both."""
    jdt, tdt, tol = DTYPES[dt]
    model = setup(case)
    port, no_subs = run_port(*model, tdt)
    ref = run_jax(*model, jdt)
    multi = int((no_subs > 1).sum())
    if case == "substeps":
        assert multi > no_subs.numel() // 2 and 1 < int(no_subs.max()) < 100
    else:
        assert int(no_subs.max()) == model[0].max_soil_substeps
    assert bool(port["SoilCourantCapHit"]) == bool(ref["SoilCourantCapHit"]) == (case == "cap")
    keys = set(port) & set(ref)
    assert set(SEEPS) | {"W1a", "W1b", "W2", "UZ", "Theta1a"} <= keys
    for k in sorted(keys - {"SoilCourantCapHit"}):
        err = rel_err(port[k].numpy(), ref[k])
        assert err <= tol, f"{k}: {err:.3e}"


@pytest.mark.parametrize("cap", [100, 7])
def test_matches_numpy_oracle(cap):
    """The three seepage sums against the reference's per-lane loop
    transcribed in NumPy, float64, 8x8 with every lane sub-stepping: at the
    default cap (at most 61 sub-steps: it does not bind) and at a cap of 7,
    which binds on most lanes (the oracle applies the same cap)."""
    cfg, params, state, aux, d = _soil_setup(8, 8, ksat_boost=8.0)
    cfg = dataclasses.replace(cfg, max_soil_substeps=cap)
    port, no_subs = run_port(cfg, params, state, aux, d, torch.float64)
    *seeps, ns = _numpy_soil_oracle(cfg, params, state, d)
    np.testing.assert_array_equal(no_subs.numpy(), ns)
    assert (ns > 1).all() and (int(ns.max()) == cap) == (cap == 7)
    assert bool(port["SoilCourantCapHit"]) == (cap == 7)
    for name, ref in zip(SEEPS, seeps):
        err = rel_err(port[name].numpy(), ref)
        assert err <= 1e-10, f"{name}: {err:.3e}"


def tail_operands(dtype=torch.float64, P=50, seed=0):
    """Operands of soil_tail on a (3, P) grid: storages, sub-step-0 sums,
    counts 1-6 and parameters drawn from `seed`."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    wres = {k: t(rng.uniform(0.01, 0.05, (3, P))) for k in ("WRes1a", "WRes1b", "WRes2")}
    q = dict(wres)
    for layer, k in (("1a", "WS1a"), ("1b", "WS1b"), ("2", "WS2")):
        q[k] = wres["WRes" + layer] + t(rng.uniform(0.2, 0.4, (3, P)))
        q["KSat" + layer] = t(rng.uniform(1.0, 40.0, (3, P)))
        m = rng.uniform(0.1, 0.5, (3, P))
        q["GenuM" + layer], q["GenuInvM" + layer] = t(m), t(1 / m)
        q["PoreSpaceNotZero" + layer] = torch.as_tensor(rng.uniform(0, 1, (3, P)) > 0.1)
    aw = tuple(t(rng.uniform(0.05, 0.3, (3, P))) for _ in range(3))
    seep = tuple(t(rng.uniform(0.0, 0.01, (3, P))) for _ in range(3))
    no_subs = torch.as_tensor(rng.integers(1, 7, (3, P)), dtype=torch.int32)
    return aw, seep, no_subs, 1.0 / no_subs.to(dtype), q


def test_dispatch_and_checks():
    """soil_tail runs the plain version on CPU tensors, in place and without
    counting a launch; lanes with one sub-step keep their sums; a lane's
    result does not depend on the other lanes (its counts alone); another
    device raises, and so do operands of the wrong type or shape."""
    aw, seep, no_subs, dt_sub, q = tail_operands()
    before = tuple(x.clone() for x in seep)
    launches = st.soil_tail.launches
    out = st.soil_tail(aw, seep, no_subs, dt_sub, q)
    assert st.soil_tail.launches == launches
    assert all(o is s for o, s in zip(out, seep))
    one = no_subs == 1
    for o, b in zip(out, before):
        assert torch.equal(o[one], b[one]) and not torch.equal(o[~one], b[~one])
    # the same lanes with every other lane's count set to 1: the same values
    # (to the last bit but where a lane moves between the SIMD body and the
    # scalar remainder of PyTorch's CPU pow, which may differ in float64)
    keep = torch.zeros_like(one)
    keep[:, ::3] = True
    alone = torch.where(keep, no_subs, 1).to(torch.int32)
    part = st.soil_tail(aw, tuple(x.clone() for x in before), alone, dt_sub, q)
    for o, p in zip(out, part):
        torch.testing.assert_close(p[keep], o[keep], rtol=1e-14, atol=0)
    meta = lambda xs: tuple(x.to("meta") for x in xs)
    with pytest.raises(RuntimeError, match="meta"):
        st.soil_tail(meta(aw), meta(seep), no_subs.to("meta"), dt_sub.to("meta"), q)
    with pytest.raises(TypeError, match="no_subs"):
        st.soil_tail(aw, seep, no_subs.long(), dt_sub, q)
    with pytest.raises(ValueError, match=r"seep\[1\]"):
        st.soil_tail(aw, (seep[0], seep[1][:, :10], seep[2]), no_subs, dt_sub, q)
    with pytest.raises(TypeError, match=r"aw\[0\]"):
        st.soil_tail((aw[0].float(),) + aw[1:], seep, no_subs, dt_sub, q)


def test_args_mirror_the_kernel():
    """The ctypes mirror of SoilTailArgs names its fields in the order and
    with the arrays of the struct in csrc/soil_tail.cu, and the parameters
    in the order the kernel reads them."""
    src = (Path(st.__file__).resolve().parent.parent / "csrc" / "soil_tail.cu").read_text()
    body = re.search(r"struct SoilTailArgs \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = re.findall(r"[*\s](\w+)(?:\[\w+\])?\s*[,;]", body)
    assert names == [f for f, _ in st._SoilTailArgs._fields_]
    order = re.search(r"WRes1a, WRes1b.*?GenuM2", src, re.S).group(0)
    assert re.findall(r"\w+", order) == list(st.FLOAT_KEYS)
    assert st._SoilTailArgs.par.size == 15 * 8 and st._SoilTailArgs.psnz.size == 3 * 8


def test_lai_selection_by_tensor_index():
    """The step's LAI is the LAIX slice of the forcing's LAIInterval, taken
    with index_select when the index is a tensor (as the forcing holds it on
    the device: a 0-d device index read back on the host would synchronise
    the step) and by plain indexing otherwise; both the same values."""
    from lisflood_tpu_torch.models.step import build_step
    from lisflood_tpu_torch.models.synthetic import build_synthetic_model, synthetic_forcing
    cfg, params, state, aux = build_synthetic_model(8, 8, no_rout_steps=2, chunk_size=16)
    step, p = build_step(cfg, params, aux, device="cpu")
    s = step.prepare_state(state)
    f = to_device(synthetic_forcing(cfg.num_pixels), "cpu", torch.float64)
    assert torch.is_tensor(f["LAIInterval"]) and f["LAIInterval"].dim() == 0
    by_tensor = step.land_phase(s, f)["LAI"]
    by_int = step.land_phase(s, {**f, "LAIInterval": int(f["LAIInterval"])})["LAI"]
    want = p["LAIX"][int(f["LAIInterval"])]
    assert torch.equal(by_tensor, want) and torch.equal(by_int, want)

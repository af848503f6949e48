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
version on the card by chip_smoke.py. A NumPy emulation of the kernel's work
layout (csrc/soil_tail.cu: tiles of lanes, the sub-stepping lanes compacted
by ballots and a block-wide prefix, grouped by count with a stable radix
sort, 32 to a warp, the next 32 to the warp free first) shows every such
lane run once and the others left alone, and, run chunk by chunk through
the plain version, the same bits as the plain version over the whole grid. The last test holds the step's LAI
selection, the main path's other read of a device value on the host until
K8, to the indexing it replaces."""
import dataclasses
import inspect
import os
import re
import subprocess
import sys
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
    with the arrays of the struct in csrc/soil_tail.cu, the parameters in
    the order the kernel reads them, and THREADS, ROUND and TILE are the
    kernel's kThreads, kRound and kTile."""
    src = (Path(st.__file__).resolve().parent.parent / "csrc" / "soil_tail.cu").read_text()
    body = re.search(r"struct SoilTailArgs \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = re.findall(r"[*\s](\w+)(?:\[\w+\])?\s*[,;]", body)
    assert names == [f for f, _ in st._SoilTailArgs._fields_]
    order = re.search(r"WRes1a, WRes1b.*?GenuM2", src, re.S).group(0)
    assert re.findall(r"\w+", order) == list(st.FLOAT_KEYS)
    assert st._SoilTailArgs.par.size == 15 * 8 and st._SoilTailArgs.psnz.size == 3 * 8
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    assert (consts["kThreads"], consts["kRound"], consts["kTile"], consts["kOffsetBits"]) == (
        str(st.THREADS), "4 * kThreads", "7 * kRound", "13")
    assert (st.ROUND, st.TILE) == (4 * st.THREADS, 7 * st.ROUND) and st.TILE <= 1 << 13


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


def emulate_tiles(no_subs, tile, threads, round_, most):
    """The work layout of csrc/soil_tail.cu on the counts `no_subs`, in
    NumPy, index for index: G = ceil(n / tile) blocks of tile / round_
    rounds, round r of block b the lanes from (r G + b) round_ on; each
    round a thread reads 4 counts, four ballot words a warp give the warp's
    lower threads' sub-stepping lanes and the warps' totals a block-wide
    prefix, and the lanes with a count above 1 land in the block's list in
    order as (class << 13) | (r round_ + offset in the round), the class
    floor(log2(count)) capped at 7; where the list holds more than 32, a
    stable radix pass a bit of the class, ones first, from the lowest bit to
    the largest class's highest; then warp w runs the chunk of entries 32
    w.., and each next chunk goes to the warp free first (a chunk taking as
    long as its largest count; on the card the order in which warps come
    free may differ, which changes who runs a chunk and no bit). Returns the
    chunks, each (block, warp, lanes, counts), and the blocks' lists before
    and after the sort."""
    import numpy as np
    ns = np.asarray(no_subs, np.int64).reshape(-1)
    n, warps, rounds = ns.size, threads // 32, tile // round_
    assert tile % round_ == 0 and 0 < tile <= most <= 1 << 13 and round_ == 4 * threads
    grid = -(-n // tile)
    lane_of = lambda b, off: (off // round_ * grid + b) * round_ + off % round_
    popc = lambda x: int(np.bitwise_count(np.uint32(x)))
    chunks, lists = [], []
    for block in range(grid):
        lst = np.full(tile, -1, np.int64)
        m, top = 0, 0
        for r in range(rounds):
            start = (r * grid + block) * round_
            length = max(0, min(round_, n - start))
            c = np.zeros((threads, 4), np.int64)
            for t in range(threads):
                for k in range(4):
                    c[t, k] = ns[start + 4 * t + k] if 4 * t + k < length else 0
            flag = c > 1
            words = [[sum(int(flag[32 * w + l, k]) << l for l in range(32)) for k in range(4)]
                     for w in range(warps)]
            in_warp = [sum(popc(words[w][k]) for k in range(4)) for w in range(warps)]
            for t in range(threads):
                w, lane = divmod(t, 32)
                below = sum(popc(words[w][k] & ((1 << lane) - 1)) for k in range(4))
                at = m + sum(in_warp[:w]) + below
                for k in range(4):
                    if flag[t, k]:
                        key = min(int(c[t, k]).bit_length() - 1, 7)
                        lst[at] = key << 13 | (r * round_ + 4 * t + k)
                        top = max(top, key)
                        at += 1
            m += sum(in_warp)
        compacted = lst[:m].copy()
        if m > 32:
            for b in range(13, 13 + top.bit_length()):
                one = ((lst[:m] >> b) & 1).astype(bool)
                all_ones, dst, ones_before = int(one.sum()), np.full(m, -1, np.int64), 0
                for r in range(0, m, threads):
                    e = r + np.arange(threads)
                    bit = np.where(e < m, one[np.minimum(e, m - 1)], False).reshape(warps, 32)
                    word = [sum(int(bit[w, l]) << l for l in range(32)) for w in range(warps)]
                    for t in range(threads):
                        w, lane = divmod(t, 32)
                        rank = (ones_before + sum(popc(word[v]) for v in range(w))
                                + popc(word[w] & ((1 << lane) - 1)))
                        if e[t] < m:
                            dst[rank if bit[w, lane] else all_ones + (e[t] - rank)] = lst[e[t]]
                    ones_before += sum(popc(x) for x in word)
                lst[:m] = dst
        lists.append((compacted, lst[:m].copy()))
        free = [0] * warps
        for chunk in range(-(-m // 32)):
            w = chunk if chunk < warps else min(range(warps), key=lambda v: (free[v], v))
            lanes = lane_of(block, lst[32 * chunk:min(32 * chunk + 32, m)] & 0x1fff)
            free[w] += int(ns[lanes].max())
            chunks.append((block, w, lanes, ns[lanes]))
    return chunks, lists


def layout_counts(name):
    """(counts, tile) of each layout case: `tiles` TILE lanes of which none
    sub-steps, TILE of which every one does, TILE sparse ones and a ragged
    end of 999 lanes, at the largest tile (each block takes rounds of
    each); `cap` a fifth of the lanes at the
    cap of 100 and more at 2-99, at the tile tile_lanes gives 4,500 lanes;
    `members` the M x 3 x P lanes of a folded ensemble of 4 members, 2% of
    them sub-stepping up to 41 times as on the continental main path;
    `huge` counts from 2 to 70,000, every class, at a tile of 2 rounds."""
    rng = np.random.default_rng(11)
    if name == "tiles":
        T = st.TILE
        sparse = np.where(rng.random(T) < 0.05, rng.integers(2, 30, T), 1)
        ragged = np.where(rng.random(999) < 0.3, rng.integers(2, 9, 999), 1)
        return np.r_[np.ones(T, int), rng.integers(2, 7, T), sparse, ragged], T
    if name == "cap":
        u = rng.random(4500)
        c = np.where(u < 0.2, 100, np.where(u < 0.45, rng.integers(2, 100, 4500), 1))
        return c, st.tile_lanes(c.size, 132)
    if name == "members":
        c = np.where(rng.random(4 * 3 * 700) < 0.02, rng.integers(2, 42, 4 * 3 * 700), 1)
        return c, st.tile_lanes(c.size, 132)
    c = np.where(rng.random(3000) < 0.1, rng.integers(2, 50, 3000), 1)
    c[1234], c[17:25] = 70000, 2 ** np.arange(1, 9)
    return c, st.ROUND * 2


LAYOUTS = ("tiles", "cap", "members", "huge")


@pytest.mark.parametrize("name", LAYOUTS)
def test_tile_layout_runs_each_lane_once(name):
    """The emulated layout runs every lane with more than one sub-step
    exactly once, at its own count, in the block of its rounds, and no other
    lane; a block's list before the sort is its lanes in order, after it
    (where it holds more than 32) grouped by the count's class, the largest
    first, in lane order within a class."""
    counts, tile = layout_counts(name)
    chunks, lists = emulate_tiles(counts, tile, st.THREADS, st.ROUND, st.TILE)
    grid, rounds = -(-counts.size // tile), tile // st.ROUND
    lanes = np.concatenate([c[2] for c in chunks]) if chunks else np.zeros(0, int)
    ran = np.concatenate([c[3] for c in chunks]) if chunks else np.zeros(0, int)
    want = np.flatnonzero(counts > 1)
    assert lanes.size == np.unique(lanes).size == want.size
    np.testing.assert_array_equal(np.sort(lanes), want)
    np.testing.assert_array_equal(ran, counts[lanes])
    for block, warp, ls, _ in chunks:
        assert ((ls // st.ROUND) % grid == block).all() and ls.size <= 32
        assert 0 <= warp < st.THREADS // 32
    for block, (compacted, grouped) in enumerate(lists):
        mine = np.concatenate([np.arange(s, min(s + st.ROUND, counts.size)) for s in
                               (np.arange(rounds) * grid + block) * st.ROUND])
        offs = np.flatnonzero(counts[mine] > 1)
        local = (mine[offs] // st.ROUND - block) // grid * st.ROUND + mine[offs] % st.ROUND
        np.testing.assert_array_equal(compacted & 0x1fff, local)
        np.testing.assert_array_equal(compacted >> 13, np.minimum(
            np.floor(np.log2(counts[mine[offs]])), 7))
        if grouped.size > 32:
            np.testing.assert_array_equal(grouped, compacted[np.lexsort((local, -(compacted >> 13)))])
        else:
            np.testing.assert_array_equal(grouped, compacted)
    if name == "tiles":
        # block b's rounds 0 and 2 are the grid's rounds b and 8 + b, in the
        # first TILE lanes (none sub-steps) and the next (every one does)
        full = [int((counts[(r * grid + b) * st.ROUND:(r * grid + b + 1) * st.ROUND] > 1).sum())
                for b in range(grid) for r in range(rounds)]
        assert [c.size for c, _ in lists] == [sum(full[b * rounds:(b + 1) * rounds])
                                             for b in range(grid)]
        assert all(full[b * rounds] == 0 and full[b * rounds + 2] == st.ROUND for b in range(grid))


_CHUNKED = """
import sys
import numpy as np
import torch
from lisflood_tpu_torch.ops import soil_tail as st
torch.set_num_threads(1)
{source}
failed = []
for name in {names!r}:
    counts, tile = layout_counts(name)
    chunks, _ = emulate_tiles(counts, tile, st.THREADS, st.ROUND, st.TILE)
    for dtype in (torch.float32, torch.float64):
        aw, seep, _, _, q = tail_operands(dtype, P=counts.size // 3, seed=5)
        no_subs = torch.as_tensor(counts.reshape(3, -1), dtype=torch.int32)
        dt_sub = 1.0 / no_subs.to(dtype)
        whole = st.soil_tail_reference(aw, tuple(x.clone() for x in seep), no_subs, dt_sub, q)
        flat = lambda x: x.reshape(-1)
        chunked = tuple(flat(x).clone() for x in seep)
        for _, _, lanes, _ in chunks:
            i = torch.as_tensor(lanes)
            g = lambda x: flat(x)[i].contiguous()
            part = st.soil_tail_reference(tuple(g(x) for x in aw), tuple(g(x) for x in chunked),
                                          g(no_subs), g(dt_sub), {{k: g(v) for k, v in q.items()}})
            for full, got in zip(chunked, part):
                full[i] = got
        for a, b in zip(whole, chunked):
            if not np.array_equal(flat(a).numpy().view(np.uint8), b.numpy().view(np.uint8)):
                failed.append((name, str(dtype)))
print(failed)
"""


def test_tile_layout_bitwise_to_plain():
    """The lanes run as the emulated layout hands them out, chunk by chunk
    through the plain version, give the plain version's bits over the whole
    grid, float32 and float64, on the `tiles`, `cap` and `members` layouts
    (operands of tail_operands, dt_sub 1 / no_subs). In a subprocess with
    ATEN_CPU_CAPABILITY=default: PyTorch's SIMD pow and the scalar one of a
    vector loop's remainder differ in the last bit, so with the SIMD kernels
    a lane's bits would depend on its position in the tensor; the card has
    no such effect. One intra-op thread, as the multi-process tests run
    theirs (tests/test_torch_multihost.py), so that no part of the work
    goes to another thread."""
    source = "\n\n".join(inspect.getsource(f) for f in (tail_operands, emulate_tiles,
                                                         layout_counts))
    code = _CHUNKED.format(source=source, names=["tiles", "cap", "members"])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=900,
                         env={**os.environ, "ATEN_CPU_CAPABILITY": "default",
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_tile_lanes():
    """Tiles are the fewest whole rounds of 4 lanes a thread that keep the
    grid within BLOCKS_PER_SM blocks an SM, at most TILE lanes: the
    continental grid's 3.6 M lanes take the largest, 7,168 (503 blocks on
    132 SMs), and so do the folded ensembles', 240x200's 144,000 lanes
    1,024."""
    assert st.ROUND == 4 * st.THREADS and st.TILE % st.ROUND == 0
    assert st.tile_lanes(3_600_000, 132) == 7 * st.ROUND == st.TILE
    assert -(-3_600_000 // (7 * st.ROUND)) <= 132 * st.BLOCKS_PER_SM
    assert st.tile_lanes(8 * 3_600_000, 132) == st.TILE
    assert st.tile_lanes(144_000, 132) == st.ROUND
    for n in (1, 1000, 5000, 300_000, 2_000_000, 2 ** 31 + 5):
        t = st.tile_lanes(n, 132)
        assert t % st.ROUND == 0 and st.ROUND <= t <= st.TILE
        assert t == st.ROUND or -(-n // (t - st.ROUND)) > 132 * st.BLOCKS_PER_SM

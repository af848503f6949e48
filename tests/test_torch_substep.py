"""The port's sub-step loop (lisflood_tpu_torch/ops/kinwave_substep.py)
against the JAX package's Pallas kernel, run in interpret mode on the CPU,
and against a float64 NumPy transcription.

The scenario is random and self-contained: 16 chunks of 128 lanes, a
2-chunk window, 3 sub-steps, split routing, the open-water evaporation chain,
and two lakes and two reservoirs whose feeders lie in earlier chunks
(some beyond the window). The optional sideflow terms (evaporation computed
outside, water use, inflow ramp, transmission loss) come in cases of their
own; the transmission-loss data holds lanes where chanq**tp2 < tsub, whose
`trans` is NaN in both packages."""
import dataclasses

import numpy as np
import pytest
import torch

from lisflood_tpu.models.config import ModelConfig
from lisflood_tpu.ops.kinwave_pallas import build_substep_pallas
from lisflood_tpu_torch.models.step import upstream_table
from lisflood_tpu_torch.ops import kinwave_substep as ks

NC, C, W, T, E = 16, 128, 2, 3, 5
NL = NR = 2
BETA = 0.6
DT_R = 86400.0 / T
ROWS = ks.ROW_NAMES + ks.SPLIT_ROW_NAMES + ["ev_up0"]
# the optional sideflow terms by group, and the cases that exercise them:
# (groups, split routing, in-kernel evaporation chain, structures)
GROUPS = {"eva": ("eva",), "wuse": ("wuse",), "ramp": ("qin_old", "qdelta"),
          "trans": ("uptrans", "tp1", "tp2", "tsub")}
SIDEFLOW_CASES = {
    "eva": (("eva",), True, False, False),
    "wuse": (("wuse",), True, True, False),
    "ramp": (("ramp",), True, True, False),
    "trans": (("trans",), True, True, False),
    "all-split": (("wuse", "ramp", "trans"), True, True, True),
    "all-split-eva-outside": (("eva", "wuse", "ramp", "trans"), True, False, True),
    "all-single": (("eva", "wuse", "ramp", "trans"), False, False, True),
}


def _window_offsets(rng, frac):
    """(NC, C) local downstream offsets into the next W chunks (W*C = none),
    at most 8 sources per target."""
    while True:
        dl = np.full((NC, C), W * C, np.int32)
        for c in range(NC - 1):
            has = rng.random(C) < frac
            dw = rng.integers(0, min(W, NC - 1 - c), C)
            dl[c, has] = (dw * C + rng.integers(0, C, C))[has]
        tgt = _down_pos(dl)
        if np.bincount(tgt[tgt >= 0]).max() <= 8:
            return dl


def _down_pos(dl):
    """Global downstream position of each position, -1 = none."""
    base = (np.arange(NC)[:, None] + 1) * C
    return np.where(dl < W * C, base + dl, -1).reshape(-1)


@pytest.fixture(scope="module")
def scenario():
    rng = np.random.default_rng(1)
    u = lambda lo, hi, shape=(NC, C): rng.uniform(lo, hi, shape)
    x = {}
    x["dx"] = u(4000, 5000)
    x["alpha1"] = u(1, 5)
    x["alpha2"] = x["alpha1"] * u(1.2, 2.0)
    x["adx1"] = x["alpha1"] * x["dx"] / DT_R
    x["adx2"] = x["alpha2"] * x["dx"] / DT_R
    x["ischan"] = (rng.random((NC, C)) < 0.9).astype(np.float64)
    x["ToChan"] = u(0, 2e3)
    x["q1_0"] = u(0, 10)
    x["m31_0"] = x["dx"] * x["alpha1"] * x["q1_0"] ** BETA
    x["chanq_0"] = u(0, 10)
    x["qlimit"] = u(1, 10)
    x["m3limit"] = x["alpha1"] * x["dx"] * x["qlimit"] ** BETA
    x["chan2m3start"] = x["alpha2"] * x["dx"] * x["qlimit"] ** BETA
    x["chan2qstart"] = u(-1, 1)
    x["m32_0"] = x["chan2m3start"] + u(0, 2e4)
    x["q2_0"] = (x["m32_0"] / x["dx"] / x["alpha2"]) ** (1 / BETA)
    x["ev_up0"] = u(0, 3e3)
    # optional sideflow terms; tsub up to 0.3 against chanq_0**tp2 of ~2
    # leaves some lanes with chanq**tp2 < tsub (NaN loss: tp1 is no integer)
    x["eva"] = u(0, 50)
    x["wuse"] = u(-20, 100)
    x["qin_old"] = np.where(rng.random((NC, C)) < 0.1, u(0, 5e4), 0.0)
    x["qdelta"] = x["qin_old"] * u(-0.1, 0.1)
    x["uptrans"] = (rng.random((NC, C)) < 0.6).astype(np.float64)
    x["tp1"] = u(1.5, 2.5)
    x["tp2"] = 1.0 / x["tp1"]
    x["tsub"] = u(0, 0.3)
    dl = _window_offsets(rng, 0.7)
    ev_dl = _window_offsets(rng, 0.5)

    # structures: cells in chunks 6.., feeders in earlier chunks, one of
    # them beyond the window (the buffer, not the window, carries it)
    pos = rng.choice(np.arange(6 * C, NC * C), NL + NR, replace=False)
    fee = np.full((NL + NR, 8), -1, np.int64)
    for i, ps in enumerate(pos):
        k = rng.integers(1, 4)
        fee[i, :k] = rng.choice(np.arange(0, (ps // C) * C), k, replace=False)
    s = {}
    area = rng.uniform(1e7, 1e9, NL)
    s["lk_factor"] = area / (DT_R * np.sqrt(rng.uniform(30, 150, NL)))
    s["lk_factorsqr"] = s["lk_factor"] ** 2
    s["lk_area"] = area
    s["lk_st0"] = rng.uniform(1e6, 1e8, NL)
    s["lk_inold0"] = rng.uniform(1, 50, NL)
    s["lk_out0"] = rng.uniform(1, 50, NL)
    s["lk_bal0"] = s["lk_st0"].copy()
    s["lk_buf0"] = rng.uniform(0, 20, NL)
    s["rs_tot"] = rng.uniform(1e7, 1e9, NR)
    s["rs_cons"] = np.full(NR, 0.1)
    s["rs_norm"] = np.full(NR, 0.45)
    s["rs_flood"] = np.full(NR, 0.9)
    s["rs_nfl"] = np.full(NR, 0.8)
    s["rs_nondam"] = rng.uniform(100, 300, NR)
    s["rs_normout"] = rng.uniform(20, 80, NR)
    s["rs_minout"] = rng.uniform(1, 5, NR)
    s["rs_do"] = s["rs_normout"] - s["rs_minout"]
    s["rs_dln"] = s["rs_norm"] - 2 * s["rs_cons"]
    s["rs_dnfl"] = s["rs_flood"] - s["rs_nfl"]
    s["rs_fill0"] = np.array([0.3, 0.85])
    s["rs_st0"] = s["rs_fill0"] * s["rs_tot"]
    s["rs_buf0"] = rng.uniform(0, 50, NR)
    return dict(x=x, dl=dl, ev_dl=ev_dl, pos=pos, fee=fee, s=s)


def _rows(groups, split, chain):
    return (ks.ROW_NAMES + (ks.SPLIT_ROW_NAMES if split else []) + (["ev_up0"] if chain else [])
            + [k for g in groups for k in GROUPS[g]])


def port_operands(sc, dtype, groups=(), split=True, chain=True, structures=True):
    t = lambda v, dt=dtype: torch.as_tensor(np.ascontiguousarray(v), dtype=dt)
    xs = {k: t(sc["x"][k]) for k in _rows(groups, split, chain)}
    p_pad = NC * C
    for name, dl in (("ups", sc["dl"]),) + ((("ev_ups", sc["ev_dl"]),) if chain else ()):
        dp = _down_pos(dl)
        xs[name] = t(upstream_table(np.flatnonzero(dp >= 0), dp[dp >= 0], p_pad), torch.int32)
    if structures:
        for prefix, sl in (("lk", slice(0, NL)), ("rs", slice(NL, NL + NR))):
            xs[prefix + "_pos"] = t(sc["pos"][sl], torch.int32)
            xs[prefix + "_fee"] = t(sc["fee"][sl], torch.int32)
            xs[prefix + "_fee_w"] = t((sc["fee"][sl] >= 0).astype(np.float64))
        for k, v in sc["s"].items():
            xs[k] = t(v)
    spec = ks.SubstepSpec(n_chunks=NC, chunk=C, window=W, T=T, dt_routing=DT_R,
                          beta=BETA, split=split, E=E if chain else 0)
    return spec, xs


def jax_operands(sc, groups=(), split=True, chain=True, structures=True):
    """The Pallas kernel's operands: padded structure rows, per-chunk masks
    (routing_ops.pallas_operands layout)."""
    f32 = np.float32
    xs = {k: sc["x"][k].astype(f32) for k in _rows(groups, split, chain)}
    xs["dl"], xs["ev_dl"] = sc["dl"], sc["ev_dl"]
    cids = np.arange(NC)
    families = (("lk", slice(0, NL), NL), ("rs", slice(NL, NL + NR), NR)) if structures else ()
    for prefix, sl, n in families:
        Np = 128
        pos, fee = sc["pos"][sl], sc["fee"][sl]
        w = (fee >= 0).astype(f32)
        idx = np.where(fee >= 0, fee, 0)
        on = (pos // C)[None, :] == cids[:, None]
        lane = np.where(on, (pos % C)[None, :], C)
        in_chunk = (idx // C)[None] == cids[:, None, None]
        fee_lane = np.where(in_chunk, (idx % C)[None], C).transpose(0, 2, 1)
        fee_w = np.where(in_chunk, w[None], 0.0).transpose(0, 2, 1)
        padn = Np - n
        xs[prefix + "_on"] = np.pad(on.astype(f32), ((0, 0), (0, padn)))
        xs[prefix + "_lane"] = np.pad(lane, ((0, 0), (0, padn)), constant_values=C).reshape(NC * Np, 1)
        xs[prefix + "_fee_lane"] = np.pad(fee_lane, ((0, 0), (0, 0), (0, padn)),
                                          constant_values=C).reshape(NC * 8, Np)
        xs[prefix + "_fee_w"] = np.pad(fee_w, ((0, 0), (0, 0), (0, padn))).reshape(NC * 8, Np)
        xs[prefix + "_own_flag"] = on.any(1).astype(np.int32)
        xs[prefix + "_fee_flag"] = in_chunk.any((1, 2)).astype(np.int32)
        ones = ("lk_factor", "lk_factorsqr", "lk_area", "rs_tot", "rs_dln", "rs_dnfl")
        for k, v in sc["s"].items():
            if k.startswith(prefix):
                xs[k] = np.pad(v.astype(f32), (0, Np - n),
                               constant_values=1.0 if k in ones else 0.0).reshape(1, Np)
    return xs


def run_pallas(sc, groups=(), split=True, chain=True, structures=True):
    """The Pallas kernel in interpret mode on the scenario's operands."""
    import jax.numpy as jnp
    cfg = ModelConfig(no_rout_steps=T, dt_sec=86400.0, num_pixels=NC * C,
                      num_lakes=NL, num_reservoirs=NR, max_no_eva=E)

    @dataclasses.dataclass
    class PS:
        chunk: int = C
        n_chunks: int = NC
        window: int = W

    has = {"split": split, "eva_chain": chain, "lakes": structures, "reservoirs": structures}
    # the kernel takes an operand only when `has` names it
    has.update({k: True for g in groups for k in GROUPS[g]})
    run = build_substep_pallas(cfg, PS(), BETA, has, interpret=True)
    ys = run({k: jnp.asarray(v)
              for k, v in jax_operands(sc, groups, split, chain, structures).items()})
    return {k: np.asarray(v)[0, :NL if k.startswith("lk") else NR]
            if k.startswith(("lk_", "rs_")) else np.asarray(v) for k, v in ys.items()}


def max_err(got, ref):
    """max |got - ref| over the largest |ref|, NaN only where both are NaN."""
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(got), nan)
    if nan.all():
        return 0.0
    return np.nanmax(np.abs(got - ref)) / max(np.nanmax(np.abs(ref)), 1e-30)


@pytest.fixture(scope="module")
def jax_out(scenario):
    return run_pallas(scenario)


def test_substep_reference_vs_pallas_interpret(scenario, jax_out):
    """float32 plain version vs the Pallas kernel: every output within 1e-5
    of its largest magnitude (measured 5.4e-7). The two differ in the order
    of the upstream sums (a matrix product on the TPU side) and in pow's
    last bits."""
    spec, xs = port_operands(scenario, torch.float32)
    ys = ks.kinwave_substep(spec, xs)
    assert set(ys) == set(jax_out)
    for k, ref in jax_out.items():
        got = ys[k].numpy()
        err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err <= 1e-5, f"{k}: {err:.3e}"


def _newton_np(cc, adx, beta, iters=6):
    """float64 NumPy transcription of the reference q-space Newton."""
    small = cc <= 1e-12
    c = np.where(small, 1.0, cc)
    b_a_dx = beta * adx
    a_pow = b_a_dx * c ** (beta - 1)
    with np.errstate(invalid="ignore"):
        sec = np.where(a_pow <= 1, c / (1 + a_pow), c / (1 + a_pow ** (1 / beta)))
        q = 0.5 * (sec + ((c - sec) / adx) ** (1 / beta))
    prev = np.full_like(q, -1.0)
    for _ in range(iters):
        pq = q ** beta
        err = q + adx * pq - c
        act = (np.abs(err) > 1e-12) & (q != prev)
        qn = np.maximum(q - err / (1 + b_a_dx * pq / q), 1e-12)
        q, prev = np.where(act, qn, q), np.where(act, q, prev)
    q = np.where(q == 1e-12, 0.0, q)
    return np.where(small, 0.0, q)


def numpy_transcription(sc, groups=()):
    """The chunk-major sub-step algorithm of the Pallas kernel, in float64
    NumPy: rotating inflow windows filled by scatter-adds through the local
    downstream offsets; `groups` names the optional sideflow terms."""
    x, s = sc["x"], sc["s"]
    pos, fee = sc["pos"], sc["fee"]
    out = {k: np.zeros((NC, C)) for k in ("q1", "m31", "chanq", "sumdis", "q2", "m32",
                                           "cross2", "side1", "ev_add")
           + (("trans",) if "trans" in groups else ())}
    lk = {"lk_st": s["lk_st0"].copy(), "lk_inold": s["lk_inold0"].copy(),
          "lk_out": s["lk_out0"].copy(), "lk_bal": s["lk_bal0"].copy(),
          "lk_in": np.zeros(NL), "lk_level": np.zeros(NL),
          "lk_sumin": np.zeros(NL), "lk_sumout": np.zeros(NL)}
    rs = {"rs_st": s["rs_st0"].copy(), "rs_fill": s["rs_fill0"].copy(),
          "rs_sumin": np.zeros(NR), "rs_sumout": np.zeros(NR)}
    buf = np.zeros((T + 1, NL + NR))
    buf[0] = np.r_[s["lk_buf0"], s["rs_buf0"]]
    win = np.zeros((T, 2, (W + 1) * C))      # chunk c reads [:, :, :C]
    ev_win = np.zeros((E, (W + 1) * C))
    for c in range(NC):
        r = {k: v[c] for k, v in x.items()}
        inv_dx = 1 / r["dx"]
        # evaporation chain
        chan_m = r["m31_0"].copy()
        left = chan_m * 0.1
        eva_add = np.zeros(C)
        ev_q = np.zeros((E, C))
        for t in range(E):
            up = r["ev_up0"] if t == 0 else ev_win[t, :C]
            help_ = np.maximum(chan_m - up, left)
            it = np.maximum(up - (chan_m - help_), 0)
            chan_m = help_
            eva_add = eva_add + up - it
            ev_q[t] = it
        out["ev_add"][c] = eva_add
        # structures owned by this chunk
        side = np.zeros((T, C))
        for i in np.flatnonzero(pos // C == c):
            lane = pos[i] % C
            for t in range(T):
                inflow = buf[t, i]
                if i < NL:
                    st, inold, outf = lk["lk_st"][i], lk["lk_inold"][i], lk["lk_out"][i]
                    lake_in = (inflow + inold) * 0.5
                    si = st / DT_R - 0.5 * outf + lake_in
                    o = (-s["lk_factor"][i] + np.sqrt(s["lk_factorsqr"][i] + 2 * si)) ** 2
                    qo = o * DT_R
                    stn = max((si - o * 0.5) * DT_R, 0.0)
                    lk["lk_bal"][i] += lake_in * DT_R - qo
                    lk["lk_inold"][i] = lk["lk_in"][i] = inflow
                    lk["lk_out"][i], lk["lk_st"][i] = o, stn
                    lk["lk_level"][i] = stn / s["lk_area"][i]
                    lk["lk_sumin"][i] += inflow * DT_R
                    lk["lk_sumout"][i] += qo
                else:
                    j = i - NL
                    g = lambda k: s["rs_" + k][j]
                    tot = g("tot")
                    qin = inflow * DT_R
                    stn = rs["rs_st"][j] + qin
                    f = stn / tot
                    o = min(g("minout"), stn / 86400)
                    if f > 2 * g("cons"):
                        o = g("minout") + g("do") * (f - 2 * g("cons")) / g("dln")
                    if f > g("norm"):
                        o = g("normout")
                    if f > g("nfl"):
                        o = g("normout") + (f - g("nfl")) / g("dnfl") * (g("nondam") - g("normout"))
                    if f > g("flood"):
                        o = max((f - g("flood") - 0.01) * tot / 86400,
                                min(g("nondam"), max(inflow * 1.2, g("normout"))))
                    if o > 1.2 * inflow and o > g("normout") and f < g("flood"):
                        o = min(o, max(inflow, g("normout")))
                    qo = max(min(o * DT_R, stn), stn - tot)
                    stn -= qo
                    rs["rs_st"][j], rs["rs_fill"][j] = stn, max(stn / tot, 0.0)
                    rs["rs_sumin"][j] += qin
                    rs["rs_sumout"][j] += qo
                side[t, lane] = qo
        # routing sub-steps (generic q-space solve, as the float64 kernel)
        q1, m31, q2, m32 = r["q1_0"], r["m31_0"], r["q2_0"], r["m32_0"]
        chanq_prev = r["chanq_0"]
        sumdis = np.zeros(C)
        qrows = np.zeros((T, 2, C))
        chanq_rows = np.zeros((T, C))
        for t in range(T):
            sf = r["ToChan"] - eva_add * (1.0 / T)
            if "wuse" in groups:
                sf = sf - r["wuse"]
            if "ramp" in groups:
                sf = sf + (r["qin_old"] + (t + 1) * r["qdelta"]) / T
            if "trans" in groups:
                with np.errstate(invalid="ignore"):
                    passed = np.where(r["uptrans"] != 0,
                                      (chanq_prev ** r["tp2"] - r["tsub"]) ** r["tp1"], chanq_prev)
                loss = (chanq_prev - passed) * DT_R
                sf = sf - loss
                out["trans"][c] += loss
            sf = sf + side[t]
            sf = np.where(r["ischan"] != 0, sf * inv_dx / DT_R, 0.0)
            sf = np.where(np.isnan(sf), 0.0, sf)
            ratio = np.where(m31 + m32 > 0, m31 / np.where(m31 + m32 > 0, m31 + m32, 1), 0)
            over = (m31 + m32 - r["chan2m3start"]) > r["m3limit"]
            s1 = np.where(over, ratio * sf, sf)
            s1 = np.where(np.abs(sf) < 1e-7, sf, s1)
            s2 = sf - s1 + r["chan2qstart"] * inv_dx
            for j, (qq, adx, lat) in enumerate(((q1, r["adx1"], s1), (q2, r["adx2"], s2))):
                qrows[t, j] = _newton_np(win[t, j, :C] + adx * qq ** BETA + lat * r["dx"], adx, BETA)
            m31 = np.maximum(r["dx"] * r["alpha1"] * qrows[t, 0] ** BETA, 0)
            q1 = (m31 * inv_dx / r["alpha1"]) ** (1 / BETA)
            m32 = r["dx"] * r["alpha2"] * qrows[t, 1] ** BETA
            m32 = np.where(m32 - r["chan2m3start"] < 0, r["chan2m3start"], m32)
            q2 = (m32 * inv_dx / r["alpha2"]) ** (1 / BETA)
            chanq_rows[t] = chanq_prev = np.maximum(q1 + q2 - r["qlimit"], 0)
            sumdis += chanq_rows[t]
        out["q1"][c], out["m31"][c], out["q2"][c], out["m32"][c] = q1, m31, q2, m32
        out["chanq"][c], out["sumdis"][c], out["side1"][c] = chanq_rows[-1], sumdis, s1
        out["cross2"][c] = (m32 - r["chan2m3start"]) * inv_dx
        # scatter into the next W chunks, then shift the windows by a chunk
        dl = sc["dl"][c]
        has = dl < W * C
        for t in range(T):
            for j in range(2):
                np.add.at(win[t, j], C + dl[has], qrows[t, j, has])
        ev_dl = sc["ev_dl"][c]
        has = ev_dl < W * C
        for t in range(E - 1):
            np.add.at(ev_win[t + 1], C + ev_dl[has], ev_q[t, has])
        win = np.concatenate([win[..., C:], np.zeros((T, 2, C))], -1)
        ev_win = np.concatenate([ev_win[:, C:], np.zeros((E, C))], -1)
        # feeder staging
        for i in range(NL + NR):
            for f in fee[i]:
                if f >= 0 and f // C == c:
                    buf[1:, i] += chanq_rows[:, f % C]
    out.update(lk)
    out.update(rs)
    return out


@pytest.mark.parametrize("case", list(SIDEFLOW_CASES))
def test_substep_sideflow_terms_vs_pallas_interpret(scenario, case):
    """float32 plain version with the optional sideflow terms vs the Pallas
    kernel: each group alone and all together, with split and with single
    routing, with the evaporation chain inside the kernel and with its
    result handed in. Every output, `trans` included, within 1e-5 of its
    largest magnitude (measured at most 1.3e-6, on `trans` with single
    routing); the NaN lanes of `trans` (about 300 of 2048) are NaN in both."""
    groups, split, chain, structures = SIDEFLOW_CASES[case]
    ref = run_pallas(scenario, groups, split, chain, structures)
    spec, xs = port_operands(scenario, torch.float32, groups, split, chain, structures)
    ys = ks.kinwave_substep(spec, xs)
    assert set(ys) == set(ref)
    assert ("trans" in ys) == ("trans" in groups)
    if "trans" in groups:
        assert 0 < np.isnan(ref["trans"]).sum() < ref["trans"].size // 2
    for k, r in ref.items():
        err = max_err(ys[k].numpy(), r)
        assert err <= 1e-5, f"{k}: {err:.3e}"


def test_substep_reference_f64_vs_numpy(scenario):
    """float64 plain version (generic q-space solve) vs an independent
    float64 NumPy transcription: every output within 1e-12 of its largest
    magnitude (measured 3.5e-16)."""
    spec, xs = port_operands(scenario, torch.float64)
    ys = ks.kinwave_substep(spec, xs)
    ref = numpy_transcription(scenario)
    assert set(ys) == set(ref)
    for k, r in ref.items():
        err = np.abs(ys[k].numpy() - r).max() / max(np.abs(r).max(), 1e-30)
        assert err <= 1e-12, f"{k}: {err:.3e}"


def test_substep_sideflow_terms_f64_vs_numpy(scenario):
    """float64 plain version with water use, the inflow ramp and the
    transmission loss (the in-kernel evaporation chain running too) vs the
    NumPy transcription: every output within 1e-12 of its largest magnitude
    (measured 1.2e-15, on `trans`), the NaN lanes of `trans` NaN in both."""
    groups = ("wuse", "ramp", "trans")
    spec, xs = port_operands(scenario, torch.float64, groups)
    ys = ks.kinwave_substep(spec, xs)
    ref = numpy_transcription(scenario, groups)
    assert set(ys) == set(ref)
    assert np.isnan(ref["trans"]).any()
    for k, r in ref.items():
        err = max_err(ys[k].numpy(), r)
        assert err <= 1e-12, f"{k}: {err:.3e}"


def test_wrapper_checks_operands(scenario):
    """The wrapper refuses half a group of sideflow operands, precomputed
    evaporation together with the in-kernel chain, a wrong dtype and a wrong
    shape."""
    spec, xs = port_operands(scenario, torch.float32)
    with pytest.raises(ValueError):
        ks.kinwave_substep(spec, {**xs, "qin_old": xs["ToChan"]})
    with pytest.raises(ValueError):
        ks.kinwave_substep(spec, {**xs, "uptrans": xs["ischan"], "tp1": xs["dx"]})
    with pytest.raises(ValueError):
        ks.kinwave_substep(spec, {**xs, "eva": xs["ToChan"]})
    with pytest.raises(ValueError):
        ks.kinwave_substep(spec, {**xs, "wuse": xs["ToChan"].double()})
    with pytest.raises(ValueError):
        ks.kinwave_substep(spec, {**xs, "dx": xs["dx"].double()})
    with pytest.raises(ValueError):
        ks.kinwave_substep(spec, {**xs, "ups": xs["ups"][:, :-1].contiguous()})


def test_ctypes_args_mirror_kernel_struct():
    """The ctypes structure handed to the CUDA launcher declares the fields
    of struct SubstepArgs in csrc/kinwave_substep.cu, in order and by type
    (the kernel itself builds and runs only on the card: chip_smoke.py)."""
    import ctypes
    import re
    from pathlib import Path
    src = (Path(ks.__file__).resolve().parent.parent / "csrc" / "kinwave_substep.cu").read_text()
    start = src.index("struct SubstepArgs {")
    body = re.sub(r"//[^\n]*", "", src[start:src.index("};", start)]).split("{", 1)[1]
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        ctype = re.match(r"(?:const\s+)?(void|int|double)", decl).group(1)
        for name in decl[len(re.match(r"(?:const\s+)?\w+\s*", decl).group(0)):].split(","):
            pointer = "*" in name
            fields.append((name.replace("*", "").strip(),
                           ctypes.c_void_p if pointer else
                           {"int": ctypes.c_int, "double": ctypes.c_double}[ctype]))
    assert fields == list(ks._Args._fields_)
    # the wavefront's fields: block count, ring depth and table width as
    # ints, every host-built table and the scratch of the protocol as pointers
    kinds = dict(fields)
    assert all(kinds[k] is ctypes.c_int for k in ("blocks", "ring", "D"))
    tables = [ks._OPERAND_OF.get(k, k) for k, kind in fields if kind is ctypes.c_void_p]
    assert set(ks.WAVEFRONT_TABLES) <= set(tables)
    assert all(kinds[k] is ctypes.c_void_p for k in ("qring", "ev_ring", "stage", "ctrl",
                                                     "lk_buf0", "rs_buf0"))
    assert not {"side", "chanq_rows", "lk_buf", "rs_buf"} & set(kinds)

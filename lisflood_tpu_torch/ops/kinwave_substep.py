"""The channel-routing sub-step loop: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of lisflood_tpu/ops/kinwave_pallas.py:build_substep_pallas. The whole
NoRoutSteps x chunks loop of one model step runs in one kernel launch
(csrc/kinwave_substep.cu): split routing with the polynomial Newton solve,
the hand-over of each lane's discharge to its downstream neighbour, the
open-water evaporation chain, and the lake and reservoir chains.

Operands (`xs`), all on one device, in schedule-packed position space
(position = chunk * C + lane, p_pad = n_chunks * C):
  (n_chunks, C) float rows: ToChan dx adx1 alpha1 ischan q1_0 m31_0 chanq_0;
      with split routing also adx2 alpha2 qlimit m3limit chan2m3start
      chan2qstart q2_0 m32_0; with the evaporation chain ev_up0;
  ups (K, p_pad) int32: the upstream source positions of every position in
      ascending order, -1 = none (K <= 8); with the evaporation chain ev_ups
      (KE, p_pad) likewise over the evaporation graph;
  lakes (optional): lk_pos (NL,) int32, lk_fee (NL, 8) int32 feeder positions
      (-1 = none) and lk_fee_w (NL, 8) weights, lk_factor lk_factorsqr
      lk_area lk_st0 lk_inold0 lk_out0 lk_bal0 lk_buf0 (NL,);
  reservoirs (optional): rs_pos rs_fee rs_fee_w as for lakes, rs_tot
      rs_cons rs_norm rs_flood rs_nfl rs_nondam rs_normout rs_minout rs_do
      rs_dln rs_dnfl rs_st0 rs_fill0 rs_buf0 (NR,).
Outputs: (n_chunks, C) q1 m31 chanq sumdis [q2 m32 cross2 side1] [ev_add],
and per structure lk_st lk_inold lk_in lk_out lk_bal lk_level lk_sumin
lk_sumout, rs_st rs_fill rs_sumin rs_sumout.

Contract the caller guarantees (models/step.py checks it when it builds a
step): every downstream and evaporation target lies 1..W chunks later;
every structure lies in a later chunk than all of its feeders; no two
structures share a position.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .kinwave_packed import NEWTON_TOL, _newton_unrolled, _newton_v

ROW_NAMES = ["ToChan", "dx", "adx1", "alpha1", "ischan", "q1_0", "m31_0", "chanq_0"]
SPLIT_ROW_NAMES = ["adx2", "alpha2", "qlimit", "m3limit", "chan2m3start",
                   "chan2qstart", "q2_0", "m32_0"]
LAKE_PARAMS = ["lk_fee_w", "lk_factor", "lk_factorsqr", "lk_area",
               "lk_st0", "lk_inold0", "lk_out0", "lk_bal0", "lk_buf0"]
RES_PARAMS = ["rs_fee_w", "rs_tot", "rs_cons", "rs_norm", "rs_flood", "rs_nfl",
              "rs_nondam", "rs_normout", "rs_minout", "rs_do", "rs_dln",
              "rs_dnfl", "rs_st0", "rs_fill0", "rs_buf0"]
# the JAX kernel's optional sideflow terms (precomputed evaporation, water
# use, inflow ramp, transmission loss) are not ported yet
UNPORTED_TERMS = ("eva", "wuse", "qin_old", "qdelta", "uptrans", "tp1", "tp2", "tsub")
FEEDERS = 8
MAX_UPS = 8
MAX_CHUNK = 512


@dataclass(frozen=True)
class SubstepSpec:
    n_chunks: int
    chunk: int          # C, lanes per chunk
    window: int         # W, max chunk distance to a downstream target
    T: int              # NoRoutSteps
    dt_routing: float
    beta: float
    split: bool
    E: int              # evaporation hops in the kernel (0: no chain)


def _poly(spec, dtype):
    """float32 with beta = 3/5 takes the polynomial v-space solve."""
    return dtype == torch.float32 and abs(spec.beta - 0.6) < 1e-9


def _structures(xs):
    return "lk_pos" in xs, "rs_pos" in xs


def _init_outputs(spec, xs):
    """Output tensors, structure state seeded from its inputs, and the (T, N)
    structure inflow buffers with row 0 = the previous step's inflow."""
    dx = xs["dx"]
    shape = (spec.n_chunks, spec.chunk)
    names = ["q1", "m31", "chanq", "sumdis"]
    if spec.split:
        names += ["q2", "m32", "cross2", "side1"]
    if spec.E:
        names.append("ev_add")
    ys = {k: dx.new_empty(shape) for k in names}
    bufs = {}
    lakes, reservoirs = _structures(xs)
    if lakes:
        for k in ("lk_st", "lk_inold", "lk_out", "lk_bal"):
            ys[k] = xs[k + "0"].clone()
        for k in ("lk_in", "lk_level", "lk_sumin", "lk_sumout"):
            ys[k] = torch.zeros_like(xs["lk_st0"])
        bufs["lk"] = dx.new_zeros(spec.T, xs["lk_pos"].numel())
        bufs["lk"][0] = xs["lk_buf0"]
    if reservoirs:
        ys["rs_st"] = xs["rs_st0"].clone()
        ys["rs_fill"] = xs["rs_fill0"].clone()
        ys["rs_sumin"] = torch.zeros_like(xs["rs_st0"])
        ys["rs_sumout"] = torch.zeros_like(xs["rs_st0"])
        bufs["rs"] = dx.new_zeros(spec.T, xs["rs_pos"].numel())
        bufs["rs"][0] = xs["rs_buf0"]
    return ys, bufs


def _check(spec, xs):
    """Device, dtype, shape and contiguity of every operand."""
    bad = [k for k in UNPORTED_TERMS if k in xs]
    if bad:
        raise NotImplementedError(f"sub-step sideflow terms not ported yet: {bad}")
    dx = xs["dx"]
    dev, dtype = dx.device, dx.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sub-step kernel takes float32 or float64, not {dtype}")
    p_pad = spec.n_chunks * spec.chunk
    rows = ROW_NAMES + (SPLIT_ROW_NAMES if spec.split else []) + (["ev_up0"] if spec.E else [])
    want = {k: ((spec.n_chunks, spec.chunk), dtype) for k in rows}
    want["ups"] = (None, torch.int32)
    if spec.E:
        want["ev_ups"] = (None, torch.int32)
    lakes, reservoirs = _structures(xs)
    for on, prefix, params in ((lakes, "lk", LAKE_PARAMS), (reservoirs, "rs", RES_PARAMS)):
        if not on:
            continue
        n = xs[prefix + "_pos"].numel()
        want[prefix + "_pos"] = ((n,), torch.int32)
        want[prefix + "_fee"] = ((n, FEEDERS), torch.int32)
        for k in params:
            want[k] = ((n, FEEDERS) if k.endswith("_fee_w") else (n,), dtype)
    for k, (shape, dt) in want.items():
        v = xs.get(k)
        if v is None:
            raise KeyError(f"sub-step operand {k!r} missing")
        if v.device != dev or v.dtype != dt or not v.is_contiguous():
            raise ValueError(f"{k}: want a contiguous {dt} tensor on {dev}, "
                             f"got {v.dtype} on {v.device}")
        if shape is not None and tuple(v.shape) != shape:
            raise ValueError(f"{k}: shape {tuple(v.shape)}, want {shape}")
    for k in ("ups", "ev_ups"):
        if k in want and (xs[k].dim() != 2 or xs[k].shape[1] != p_pad
                          or not 1 <= xs[k].shape[0] <= MAX_UPS):
            raise ValueError(f"{k}: shape {tuple(xs[k].shape)}, want (1..{MAX_UPS}, {p_pad})")


# ---------------------------------------------------------------------------
# the plain PyTorch version


def _lake_chain(xs, ys, buf, idx, side, dt_r, T):
    """Modified Puls chain (lakes.py:199-263) of the lakes `idx`."""
    g = lambda k: ys[k][idx]
    st, inold, outflow, bal = g("lk_st"), g("lk_inold"), g("lk_out"), g("lk_bal")
    inflow_last, level, sumin, sumout = g("lk_in"), g("lk_level"), g("lk_sumin"), g("lk_sumout")
    factor, factorsqr, area = (xs[k][idx] for k in ("lk_factor", "lk_factorsqr", "lk_area"))
    lanes = xs["lk_pos"][idx].long() % side.shape[1]
    for t in range(T):
        inflow = buf[t, idx]
        lake_in = (inflow + inold) * 0.5
        si = st / dt_r - 0.5 * outflow + lake_in
        r = -factor + torch.sqrt(factorsqr + 2.0 * si)
        out_new = r * r
        q_out = out_new * dt_r
        st_new = (si - out_new * 0.5) * dt_r
        st_new = torch.where(torch.isnan(st_new) | (st_new < 0), 0.0, st_new)
        bal_new = bal + lake_in * dt_r - q_out
        side[t, lanes] = q_out
        inold = inflow
        inflow_last = inflow
        outflow = out_new
        st = st_new
        bal = bal_new
        level = st_new / area
        sumin = sumin + inflow * dt_r
        sumout = sumout + q_out
    for k, v in (("lk_st", st), ("lk_inold", inold), ("lk_in", inflow_last),
                 ("lk_out", outflow), ("lk_bal", bal), ("lk_level", level),
                 ("lk_sumin", sumin), ("lk_sumout", sumout)):
        ys[k][idx] = v


def _reservoir_chain(xs, ys, buf, idx, side, dt_r, T):
    """Rule-curve chain (reservoir.py:173-303) of the reservoirs `idx`."""
    g = lambda k: xs[k][idx]
    total, cons, norm, flood, nfl = g("rs_tot"), g("rs_cons"), g("rs_norm"), g("rs_flood"), g("rs_nfl")
    nondam, normout, minout = g("rs_nondam"), g("rs_normout"), g("rs_minout")
    delta_o, dln, dnfl = g("rs_do"), g("rs_dln"), g("rs_dnfl")
    st, fill = ys["rs_st"][idx], ys["rs_fill"][idx]
    sumin, sumout = ys["rs_sumin"][idx], ys["rs_sumout"][idx]
    lanes = xs["rs_pos"][idx].long() % side.shape[1]
    inv_day = 1.0 / 86400.0
    for t in range(T):
        inflow = buf[t, idx]
        q_in = inflow * dt_r
        st_new = st + q_in
        f = st_new / total
        o1 = torch.minimum(minout, st_new * inv_day)
        o2 = minout + delta_o * (f - 2 * cons) / dln
        o3a = normout
        o3b = o3a + ((f - nfl) / dnfl) * (nondam - o3a)
        temp4 = torch.minimum(nondam, torch.maximum(inflow * 1.2, o3a))
        o4 = torch.maximum((f - flood - 0.01) * total * inv_day, temp4)
        outflow = o1
        outflow = torch.where(f > 2 * cons, o2, outflow)
        outflow = torch.where(f > norm, o3a, outflow)
        outflow = torch.where(f > nfl, o3b, outflow)
        outflow = torch.where(f > flood, o4, outflow)
        temp = torch.minimum(outflow, torch.maximum(inflow, o3a))
        outflow = torch.where((outflow > 1.2 * inflow) & (outflow > o3a) & (f < flood), temp, outflow)
        q_out = outflow * dt_r
        q_out = torch.minimum(q_out, st_new)
        q_out = torch.maximum(q_out, st_new - total)
        st_new = st_new - q_out
        f = st_new / total
        f = torch.where(torch.isnan(f) | (f < 0), 0.0, f)
        side[t, lanes] = q_out
        st = st_new
        fill = f
        sumin = sumin + q_in
        sumout = sumout + q_out
    for k, v in (("rs_st", st), ("rs_fill", fill), ("rs_sumin", sumin), ("rs_sumout", sumout)):
        ys[k][idx] = v


def _chunk_plan(xs, C):
    """Host-side lists: for each chunk, the structures it owns and, per
    structure it feeds, the (lane, slot) of its feeders there."""
    own, feed = {}, {}
    lakes, reservoirs = _structures(xs)
    for on, prefix in ((lakes, "lk"), (reservoirs, "rs")):
        if not on:
            continue
        for s, pos in enumerate(xs[prefix + "_pos"].tolist()):
            own.setdefault(pos // C, {}).setdefault(prefix, []).append(s)
        for s, row in enumerate(xs[prefix + "_fee"].tolist()):
            for f, fp in enumerate(row):
                if fp >= 0:
                    feed.setdefault(fp // C, {}).setdefault((prefix, s), []).append((fp % C, f))
    return own, feed


def _upstream_sum(ring, src, C, S):
    """Sum over each lane's upstream sources (rows of `src`, -1 = none) of the
    ring entries of their lanes, in the table's order: (C, *ring.shape[1:-1])."""
    valid = src >= 0
    s = src.clamp_min(0)
    vals = ring[(s // C) % S, ..., s % C]                 # (K, C, ...)
    acc = vals.new_zeros(vals.shape[1:])
    for k in range(src.shape[0]):
        v = valid[k].reshape((-1,) + (1,) * (vals.dim() - 2))
        acc = acc + torch.where(v, vals[k], 0.0)
    return acc


def substep_reference(spec, xs):
    """The plain PyTorch version of the sub-step kernel: a loop over chunks
    and sub-steps on (C,) rows, in float32 or float64, with the kernel's
    operation order. Returns the kernel's outputs."""
    n, C, W, T = spec.n_chunks, spec.chunk, spec.window, spec.T
    S, L, E = W + 1, (2 if spec.split else 1), spec.E
    dtype = xs["dx"].dtype
    poly = _poly(spec, dtype)
    beta = float(spec.beta)
    inv_beta = 1.0 / beta
    dt_r = float(spec.dt_routing)
    ys, bufs = _init_outputs(spec, xs)
    ring = xs["dx"].new_zeros(S, T, L, C)
    ev_ring = xs["dx"].new_zeros(S, max(E - 1, 1), C)
    side = xs["dx"].new_zeros(T, C)
    ups = xs["ups"].long()
    ev_ups = xs["ev_ups"].long() if E else None
    own, feed = _chunk_plan(xs, C)

    for c in range(n):
        sl = slice(c * C, (c + 1) * C)
        slot = c % S
        x = {k: xs[k][c] for k in ROW_NAMES + (SPLIT_ROW_NAMES if spec.split else [])
             + (["ev_up0"] if E else [])}
        dx = x["dx"]
        inv_dx = 1.0 / dx

        # open-water evaporation chain (evapowater.py:123-159)
        if E:
            ev_in = _upstream_sum(ev_ring, ev_ups[:, sl], C, S) if E > 1 else None
            chan_m = x["m31_0"]
            chan_left = chan_m * 0.1
            eva_add = torch.zeros_like(chan_m)
            for t in range(E):
                up = x["ev_up0"] if t == 0 else ev_in[:, t - 1]
                chan_help = torch.maximum(chan_m - up, chan_left)
                ev_it = torch.clamp_min(up - (chan_m - chan_help), 0.0)
                chan_m = chan_help
                eva_add = eva_add + up - ev_it
                if t < E - 1:
                    ev_ring[slot, t] = ev_it
            ys["ev_add"][c] = eva_add
            eva_dt = eva_add * (1.0 / T)

        # structure chains of the structures this chunk owns
        owned = own.get(c, {})
        for prefix, chain in (("lk", _lake_chain), ("rs", _reservoir_chain)):
            if prefix in owned:
                idx = torch.tensor(owned[prefix], device=dx.device)
                chain(xs, ys, bufs[prefix], idx, side, dt_r, T)

        ups_in = _upstream_sum(ring, ups[:, sl], C, S)     # (C, T, L)
        sf_base = x["ToChan"]
        if E:
            sf_base = sf_base - eva_dt
        q1, m31, chanq = x["q1_0"], x["m31_0"], x["chanq_0"]
        qb1 = q1 ** beta
        if spec.split:
            adx = torch.stack([x["adx1"], x["adx2"]])
            c2q_dx = x["chan2qstart"] * inv_dx
            q2, m32 = x["q2_0"], x["m32_0"]
            qb2 = q2 ** beta
            qb2_floor = x["chan2m3start"] * inv_dx / x["alpha2"]
            q2_floor = qb2_floor ** inv_beta
            side1 = torch.zeros_like(dx)
        sumdis = torch.zeros_like(dx)
        chanq_rows = []
        for t in range(T):
            sideflow_m3 = sf_base
            if owned:
                sideflow_m3 = sideflow_m3 + side[t]
            sideflow = torch.where(x["ischan"] != 0, sideflow_m3 * inv_dx / dt_r, 0.0)
            sideflow = torch.where(torch.isnan(sideflow), 0.0, sideflow)
            if not spec.split:
                if poly:
                    cc = ups_in[:, t, 0] + x["adx1"] * qb1 + sideflow * dx
                    small = cc <= NEWTON_TOL
                    v = _newton_v(torch.where(small, 1.0, cc), x["adx1"])
                    v3 = v * v * v
                    qb1 = torch.where(small, 0.0, v3)
                    q = torch.where(small, 0.0, v3 * v * v)
                    m31 = dx * x["alpha1"] * qb1
                    q1 = q
                else:
                    cc = ups_in[:, t, 0] + x["adx1"] * q1 ** beta + sideflow * dx
                    q = _newton_unrolled(cc, x["adx1"], beta)
                    m31 = torch.clamp_min(dx * x["alpha1"] * q ** beta, 0.0)
                    q1 = (m31 * inv_dx / x["alpha1"]) ** inv_beta
                ring[slot, t, 0] = q
                chanq = q1
            else:
                # split the sideflow between main channel and floodplain
                ratio_den = m31 + m32
                ratio = torch.where(ratio_den > 0, m31 / torch.where(ratio_den > 0, ratio_den, 1.0), 0.0)
                over = (m31 + m32 - x["chan2m3start"]) > x["m3limit"]
                s1 = torch.where(over, ratio * sideflow, sideflow)
                s1 = torch.where(sideflow.abs() < 1e-7, sideflow, s1)
                s2 = sideflow - s1 + c2q_dx
                lat = torch.stack([s1, s2]) * dx
                ups_t = ups_in[:, t, :].T
                if poly:
                    cc = ups_t + adx * torch.stack([qb1, qb2]) + lat
                    small = cc <= NEWTON_TOL
                    v = _newton_v(torch.where(small, 1.0, cc), adx)
                    v3 = v * v * v
                    qb_n = torch.where(small, 0.0, v3)
                    q = torch.where(small, 0.0, v3 * v * v)
                    qb1, q1 = qb_n[0], q[0]
                    m31 = dx * x["alpha1"] * qb1
                    m32r = dx * x["alpha2"] * qb_n[1]
                    clamp2 = m32r - x["chan2m3start"] < 0.0
                    m32 = torch.where(clamp2, x["chan2m3start"], m32r)
                    q2 = torch.where(clamp2, q2_floor, q[1])
                    qb2 = torch.where(clamp2, qb2_floor, qb_n[1])
                else:
                    cc = ups_t + adx * torch.stack([q1, q2]) ** beta + lat
                    q = _newton_unrolled(cc, adx, beta)
                    m31 = torch.clamp_min(dx * x["alpha1"] * q[0] ** beta, 0.0)
                    q1 = (m31 * inv_dx / x["alpha1"]) ** inv_beta
                    m32 = dx * x["alpha2"] * q[1] ** beta
                    m32 = torch.where(m32 - x["chan2m3start"] < 0.0, x["chan2m3start"], m32)
                    q2 = (m32 * inv_dx / x["alpha2"]) ** inv_beta
                ring[slot, t] = q
                chanq = torch.clamp_min(q1 + q2 - x["qlimit"], 0.0)
                side1 = s1
            chanq_rows.append(chanq)
            sumdis = sumdis + chanq

        ys["q1"][c], ys["m31"][c], ys["chanq"][c], ys["sumdis"][c] = q1, m31, chanq, sumdis
        if spec.split:
            ys["q2"][c], ys["m32"][c], ys["side1"][c] = q2, m32, side1
            ys["cross2"][c] = (m32 - x["chan2m3start"]) * inv_dx
        if owned:
            side.zero_()
        # feeder staging: sub-step t's discharge is the structure's inflow
        # at sub-step t+1 (buffer row t+1)
        for (prefix, s), lanes in feed.get(c, {}).items():
            w = xs[prefix + "_fee_w"][s]
            acc = torch.zeros_like(bufs[prefix][:, 0])
            for lane, f in lanes:
                acc = acc + torch.stack([r[lane] for r in chanq_rows]) * w[f]
            bufs[prefix][1:, s] = bufs[prefix][1:, s] + acc[:T - 1]
    return ys


# ---------------------------------------------------------------------------
# the CUDA kernel


_PTR_FIELDS = (
    ["tochan", "dx", "adx1", "alpha1", "ischan", "q1_0", "m31_0", "chanq_0",
     "adx2", "alpha2", "qlimit", "m3limit", "c2m3s", "c2qs", "q2_0", "m32_0",
     "ev_up0", "ups", "ev_ups",
     "lk_pos", "lk_fee", "lk_fee_w", "lk_factor", "lk_factorsqr", "lk_area",
     "lk_st", "lk_inold", "lk_in", "lk_out", "lk_bal", "lk_level", "lk_sumin",
     "lk_sumout", "lk_buf",
     "rs_pos", "rs_fee", "rs_fee_w", "rs_tot", "rs_cons", "rs_norm", "rs_flood",
     "rs_nfl", "rs_nondam", "rs_normout", "rs_minout", "rs_do", "rs_dln",
     "rs_dnfl", "rs_st", "rs_fill", "rs_sumin", "rs_sumout", "rs_buf",
     "q1", "m31", "chanq", "sumdis", "q2", "m32", "cross2", "side1", "ev_add",
     "qring", "ev_ring", "chanq_rows", "side"])
# kernel argument name -> operand name, where they differ
_OPERAND_OF = {"tochan": "ToChan", "c2m3s": "chan2m3start", "c2qs": "chan2qstart"}


class _Args(ctypes.Structure):
    """Mirror of struct SubstepArgs in csrc/kinwave_substep.cu."""
    _fields_ = ([(k, ctypes.c_int) for k in ("n_chunks", "chunk", "window", "T", "split",
                                               "E", "K", "KE", "NL", "NR")]
                + [("dt_routing", ctypes.c_double), ("beta", ctypes.c_double)]
                + [(k, ctypes.c_void_p) for k in _PTR_FIELDS])


def _library():
    from . import _build
    lib = _build.load("kinwave_substep")
    lib.kinwave_substep_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    lib.kinwave_substep_launch.restype = ctypes.c_int
    lib.kinwave_substep_error_string.argtypes = [ctypes.c_int]
    lib.kinwave_substep_error_string.restype = ctypes.c_char_p
    return lib


def _launch(spec, xs):
    """One launch of the CUDA kernel on the current stream. The wrapper
    allocates outputs and scratch; the kernel allocates nothing."""
    if not 1 <= spec.chunk <= MAX_CHUNK:
        raise ValueError(f"the kernel runs one thread per lane: chunk size "
                         f"{spec.chunk} outside 1..{MAX_CHUNK}")
    lib = _library()
    dx = xs["dx"]
    dev = dx.device
    L = 2 if spec.split else 1
    S = spec.window + 1
    ys, bufs = _init_outputs(spec, xs)
    scratch = {
        "qring": dx.new_zeros(S * spec.T * L * spec.chunk),
        "ev_ring": dx.new_zeros(S * max(spec.E - 1, 1) * spec.chunk),
        "chanq_rows": dx.new_zeros(spec.T * spec.chunk),
        "side": dx.new_zeros(spec.T * spec.chunk),      # must start zeroed
        "lk_buf": bufs.get("lk"), "rs_buf": bufs.get("rs"),
    }
    tensors = {**xs, **ys, **scratch}
    lakes, reservoirs = _structures(xs)
    args = _Args(n_chunks=spec.n_chunks, chunk=spec.chunk, window=spec.window,
                 T=spec.T, split=int(spec.split), E=spec.E,
                 K=xs["ups"].shape[0], KE=xs["ev_ups"].shape[0] if spec.E else 0,
                 NL=xs["lk_pos"].numel() if lakes else 0,
                 NR=xs["rs_pos"].numel() if reservoirs else 0,
                 dt_routing=float(spec.dt_routing), beta=float(spec.beta))
    for f in _PTR_FIELDS:
        v = tensors.get(_OPERAND_OF.get(f, f))
        if v is not None:
            setattr(args, f, v.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.kinwave_substep_launch(ctypes.byref(args), int(dx.dtype == torch.float64),
                                        int(_poly(spec, dx.dtype)), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("kinwave_substep launch failed: "
                           + lib.kinwave_substep_error_string(rc).decode())
    kinwave_substep.launches += 1
    # the scratch may be freed now: the caching allocator hands its memory
    # only to later work on the same stream, which runs after the kernel
    return ys


def kinwave_substep(spec, xs):
    """The sub-step loop of one model step. A CUDA tensor launches the kernel
    (and counts the launch in `kinwave_substep.launches`); a CPU tensor runs
    the plain PyTorch version. Any other device raises."""
    _check(spec, xs)
    kind = xs["dx"].device.type
    if kind == "cuda":
        return _launch(spec, xs)
    if kind == "cpu":
        return substep_reference(spec, xs)
    raise RuntimeError(f"no sub-step kernel for device {kind!r}")


kinwave_substep.launches = 0

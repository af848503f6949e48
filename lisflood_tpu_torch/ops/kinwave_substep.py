"""The channel-routing sub-step loop: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of lisflood_tpu/ops/kinwave_pallas.py:build_substep_pallas. The whole
NoRoutSteps x chunks loop of one model step runs in one kernel launch
(csrc/kinwave_substep.cu): split routing with the polynomial Newton solve,
the hand-over of each lane's discharge to its downstream neighbour, the
open-water evaporation chain, the lake and reservoir chains, and the optional
sideflow terms (evaporation computed outside, water use, inflow ramp,
transmission loss).

Operands (`xs`), all on one device, in schedule-packed position space
(position = chunk * C + lane, p_pad = n_chunks * C):
  (n_chunks, C) float rows: ToChan dx adx1 alpha1 ischan q1_0 m31_0 chanq_0;
      with split routing also adx2 alpha2 qlimit m3limit chan2m3start
      chan2qstart q2_0 m32_0; with the evaporation chain ev_up0;
  optional (n_chunks, C) float rows, each group present or absent as a whole:
      eva (the evaporation chain's result when it ran outside; not together
      with E > 0); wuse (withdrawal minus return flow per sub-step);
      qin_old and qdelta (inflow hydrograph: last step's inflow and its
      change per sub-step); uptrans (0/1 mask), tp1, tp2, tsub (transmission
      loss);
  ups (K, p_pad) int32: the upstream source positions of every position in
      ascending order, -1 = none (K <= 8); with the evaporation chain ev_ups
      (KE, p_pad) likewise over the evaporation graph;
  lakes (optional): lk_pos (NL,) int32, lk_fee (NL, 8) int32 feeder positions
      (-1 = none) and lk_fee_w (NL, 8) weights, lk_factor lk_factorsqr
      lk_area lk_st0 lk_inold0 lk_out0 lk_bal0 lk_buf0 (NL,);
  reservoirs (optional): rs_pos rs_fee rs_fee_w as for lakes, rs_tot
      rs_cons rs_norm rs_flood rs_nfl rs_nondam rs_normout rs_minout rs_do
      rs_dln rs_dnfl rs_st0 rs_fill0 rs_buf0 (NR,).
Outputs: (n_chunks, C) q1 m31 chanq sumdis [q2 m32 cross2 side1] [ev_add]
[trans], and per structure lk_st lk_inold lk_in lk_out lk_bal lk_level
lk_sumin lk_sumout, rs_st rs_fill rs_sumin rs_sumout.

Sideflow of a lane at sub-step t, in this order of operations:
  ToChan - eva - eva_dt - wuse  (eva_dt = ev_add / T of the in-kernel chain)
  + (qin_old + float(t + 1) * qdelta) / T
  - loss,  loss = (chanq - trans_out) * dt_routing with
           trans_out = (chanq**tp2 - tsub)**tp1 where uptrans, else chanq
  + the outflow of a lake or reservoir on this lane,
then zero outside channels (ischan) and zero where NaN. `chanq` in the loss
is the PREVIOUS sub-step's (chanq_0 at t = 0); `trans` is the sum of the
losses over the sub-steps. Where chanq**tp2 < tsub and tp1 is no integer the
loss is NaN: the sideflow becomes 0 and `trans` keeps the NaN.

Padded lanes stay inert with dx = alpha = tp1 = tp2 = 1, m3limit = inf,
uptrans = ischan = 0 and 0 everywhere else.

Contract the caller guarantees (models/step.py checks it when it builds a
step): every downstream and evaporation target lies 1..W chunks later;
every structure lies in a later chunk than all of its feeders; no two
structures share a position.

How the kernel runs (csrc/kinwave_substep.cu has the full note). The unit of
work is the task (c, t), sub-step t of chunk c: it needs sub-step t of the
chunks c gathers from (all in c-W..c-1), sub-step t-1 of c itself, and for a
lake or reservoir on a lane of c sub-step t-1 of its feeder chunks. The
evaporation chain is cut the same way, hop by hop. G persistent blocks of C
threads claim chunks in increasing order from a ticket counter and meet
through one progress flag per chunk: a block publishes after every hop and
every sub-step (barrier, then one release store) and polls the flags of its
chunk's dependencies before each (acquire loads, then a barrier). The
dependencies are host-built tables, `wavefront_tables`, which the CUDA path
takes as int32 operands (wf_deps, wf_own_ptr, wf_own_list, wf_feed_ptr,
wf_feed_ent, wf_sdep_ptr, wf_sdep_list, wf_fee_ord; routing_ops.
kernel_operands passes them from models/step.packed_routing_params; the plain
version does not read them). Discharges are handed over through a ring of R
chunk slots in global memory, R = 2 G + W (`ring_slots`), whose reuse the
kernel guards: chunk c starts when chunks c-R..c-R+W are finished. A structure's
lane runs step t of its chain inside task (c, t), from a per-structure table
of its feeders' discharges that it sums in this module's plain order. G is
the launcher's rule, min(co-resident blocks, n_chunks); a launch that cannot
be resident is refused. Sums keep their order, so the outputs have the
same bits for every G and in every run.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from .kinwave_packed import NEWTON_TOL, _newton_unrolled, _newton_v
from .wavefront import FEEDERS, MAX_CHUNK, WAVEFRONT_TABLES, wavefront_tables

ROW_NAMES = ["ToChan", "dx", "adx1", "alpha1", "ischan", "q1_0", "m31_0", "chanq_0"]
SPLIT_ROW_NAMES = ["adx2", "alpha2", "qlimit", "m3limit", "chan2m3start",
                   "chan2qstart", "q2_0", "m32_0"]
LAKE_PARAMS = ["lk_fee_w", "lk_factor", "lk_factorsqr", "lk_area",
               "lk_st0", "lk_inold0", "lk_out0", "lk_bal0", "lk_buf0"]
RES_PARAMS = ["rs_fee_w", "rs_tot", "rs_cons", "rs_norm", "rs_flood", "rs_nfl",
              "rs_nondam", "rs_normout", "rs_minout", "rs_do", "rs_dln",
              "rs_dnfl", "rs_st0", "rs_fill0", "rs_buf0"]
# optional sideflow terms; the operands of a group come together
SIDEFLOW_GROUPS = (("eva",), ("wuse",), ("qin_old", "qdelta"),
                   ("uptrans", "tp1", "tp2", "tsub"))
MAX_UPS = 8


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


def _row_names(spec, xs):
    """The (n_chunks, C) float operands this call has."""
    return (ROW_NAMES + (SPLIT_ROW_NAMES if spec.split else []) + (["ev_up0"] if spec.E else [])
            + [k for group in SIDEFLOW_GROUPS for k in group if k in xs])


def _init_outputs(spec, xs):
    """Output tensors, the structures' state seeded from its inputs."""
    dx = xs["dx"]
    shape = (spec.n_chunks, spec.chunk)
    names = ["q1", "m31", "chanq", "sumdis"]
    if spec.split:
        names += ["q2", "m32", "cross2", "side1"]
    if spec.E:
        names.append("ev_add")
    if "uptrans" in xs:
        names.append("trans")
    ys = {k: dx.new_empty(shape) for k in names}
    lakes, reservoirs = _structures(xs)
    if lakes:
        for k in ("lk_st", "lk_inold", "lk_out", "lk_bal"):
            ys[k] = xs[k + "0"].clone()
        for k in ("lk_in", "lk_level", "lk_sumin", "lk_sumout"):
            ys[k] = torch.zeros_like(xs["lk_st0"])
    if reservoirs:
        ys["rs_st"] = xs["rs_st0"].clone()
        ys["rs_fill"] = xs["rs_fill0"].clone()
        ys["rs_sumin"] = torch.zeros_like(xs["rs_st0"])
        ys["rs_sumout"] = torch.zeros_like(xs["rs_st0"])
    return ys


def _check(spec, xs):
    """Device, dtype, shape and contiguity of every operand."""
    for group in SIDEFLOW_GROUPS:
        present = [k for k in group if k in xs]
        if present and len(present) != len(group):
            raise ValueError(f"sideflow operands {group} come together, got only {present}")
    if "eva" in xs and spec.E:
        raise ValueError("evaporation is either precomputed (eva) or chained in "
                         f"the kernel (E = {spec.E}), not both")
    dx = xs["dx"]
    dev, dtype = dx.device, dx.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sub-step kernel takes float32 or float64, not {dtype}")
    p_pad = spec.n_chunks * spec.chunk
    want = {k: ((spec.n_chunks, spec.chunk), dtype) for k in _row_names(spec, xs)}
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
    # the wavefront's tables: the kernel needs them, the plain version does not
    if dev.type == "cuda" or any(k in xs for k in WAVEFRONT_TABLES):
        n_struct = sum(xs[k].numel() for k in ("lk_pos", "rs_pos") if k in xs)
        want.update({k: (None, torch.int32) for k in WAVEFRONT_TABLES})
        want["wf_fee_ord"] = ((max(n_struct, 1), FEEDERS), torch.int32)
        for k in ("wf_own_ptr", "wf_feed_ptr", "wf_sdep_ptr"):
            want[k] = ((spec.n_chunks + 1,), torch.int32)
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
    if "wf_deps" in want and (xs["wf_deps"].dim() != 2 or xs["wf_deps"].shape[0] != spec.n_chunks
                              or xs["wf_deps"].shape[1] < 1):
        raise ValueError(f"wf_deps: shape {tuple(xs['wf_deps'].shape)}, want ({spec.n_chunks}, D)")


def wavefront_operands(spec, xs):
    """wavefront_tables of the operands `xs`, as tensors on their device."""
    host = lambda k: xs[k].cpu().numpy() if k in xs else None
    tables = wavefront_tables(spec.n_chunks, spec.chunk, spec.window, host("ups"),
                              host("ev_ups") if spec.E else None, host("lk_pos"),
                              host("lk_fee"), host("rs_pos"), host("rs_fee"))
    return {k: torch.as_tensor(v, device=xs["dx"].device) for k, v in tables.items()}


# ---------------------------------------------------------------------------
# the plain PyTorch version


def _lake_step(xs, ys, idx, inflow, dt_r):
    """One Modified Puls step (lakes.py:199-263) of the lakes `idx`: advances
    their state in `ys` and returns their outflow volumes."""
    g = lambda k: ys[k][idx]
    factor, factorsqr, area = (xs[k][idx] for k in ("lk_factor", "lk_factorsqr", "lk_area"))
    lake_in = (inflow + g("lk_inold")) * 0.5
    si = g("lk_st") / dt_r - 0.5 * g("lk_out") + lake_in
    r = -factor + torch.sqrt(factorsqr + 2.0 * si)
    out_new = r * r
    q_out = out_new * dt_r
    st_new = (si - out_new * 0.5) * dt_r
    st_new = torch.where(torch.isnan(st_new) | (st_new < 0), 0.0, st_new)
    for k, v in (("lk_bal", g("lk_bal") + lake_in * dt_r - q_out), ("lk_inold", inflow),
                 ("lk_in", inflow), ("lk_out", out_new), ("lk_st", st_new),
                 ("lk_level", st_new / area), ("lk_sumin", g("lk_sumin") + inflow * dt_r),
                 ("lk_sumout", g("lk_sumout") + q_out)):
        ys[k][idx] = v
    return q_out


def _reservoir_step(xs, ys, idx, inflow, dt_r):
    """One rule-curve step (reservoir.py:173-303) of the reservoirs `idx`."""
    g = lambda k: xs[k][idx]
    total, cons, norm, flood, nfl = g("rs_tot"), g("rs_cons"), g("rs_norm"), g("rs_flood"), g("rs_nfl")
    nondam, normout, minout = g("rs_nondam"), g("rs_normout"), g("rs_minout")
    delta_o, dln, dnfl = g("rs_do"), g("rs_dln"), g("rs_dnfl")
    inv_day = 1.0 / 86400.0
    q_in = inflow * dt_r
    st_new = ys["rs_st"][idx] + q_in
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
    for k, v in (("rs_st", st_new), ("rs_fill", f), ("rs_sumin", ys["rs_sumin"][idx] + q_in),
                 ("rs_sumout", ys["rs_sumout"][idx] + q_out)):
        ys[k][idx] = v
    return q_out


_STRUCTURE_STEP = {"lk": _lake_step, "rs": _reservoir_step}


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


def _eva_hop(ev, up):
    """One hop of the open-water evaporation chain (evapowater.py:123-159) of
    one chunk's lanes: `up` is what arrives from upstream, `ev` the chain's
    state {chan_m, chan_left, eva_add}. Returns the hop handed downstream."""
    chan_help = torch.maximum(ev["chan_m"] - up, ev["chan_left"])
    ev_it = torch.clamp_min(up - (ev["chan_m"] - chan_help), 0.0)
    ev["chan_m"] = chan_help
    ev["eva_add"] = ev["eva_add"] + up - ev_it
    return ev_it


def _eva_state(x):
    return {"chan_m": x["m31_0"], "chan_left": x["m31_0"] * 0.1,
            "eva_add": torch.zeros_like(x["m31_0"])}


def _lane_state(spec, x, eva_dt):
    """The lanes' state at the start of a chunk's sub-steps: the sideflow's
    per-lane part and the routing state with its derived values."""
    beta = float(spec.beta)
    sf_base = x["ToChan"]
    if "eva" in x:
        sf_base = sf_base - x["eva"]
    if eva_dt is not None:
        sf_base = sf_base - eva_dt
    if "wuse" in x:
        sf_base = sf_base - x["wuse"]
    dx = x["dx"]
    inv_dx = 1.0 / dx
    st = {"sf_base": sf_base, "inv_dx": inv_dx, "q1": x["q1_0"], "m31": x["m31_0"],
          "chanq": x["chanq_0"], "qb1": x["q1_0"] ** beta, "sumdis": torch.zeros_like(dx),
          "trans": torch.zeros_like(dx)}
    if spec.split:
        st["adx"] = torch.stack([x["adx1"], x["adx2"]])
        st["c2q_dx"] = x["chan2qstart"] * inv_dx
        st["q2"], st["m32"] = x["q2_0"], x["m32_0"]
        st["qb2"] = x["q2_0"] ** beta
        st["qb2_floor"] = x["chan2m3start"] * inv_dx / x["alpha2"]
        st["q2_floor"] = st["qb2_floor"] ** (1.0 / beta)
        st["side1"] = torch.zeros_like(dx)
    return st


def _substep(spec, x, st, t, ups_t, struct_out):
    """Sub-step t of one chunk's lanes: advances `st` and returns the (L, C)
    discharges handed downstream. `ups_t` (C, L) is the upstream inflow,
    `struct_out` (C,) the outflow of the chunk's lakes and reservoirs on
    their lanes (None for a chunk without one)."""
    T = spec.T
    beta = float(spec.beta)
    inv_beta = 1.0 / beta
    dt_r = float(spec.dt_routing)
    poly = _poly(spec, x["dx"].dtype)
    dx, inv_dx = x["dx"], st["inv_dx"]
    sideflow_m3 = st["sf_base"]
    if "qin_old" in x:
        sideflow_m3 = sideflow_m3 + (x["qin_old"] + float(t + 1) * x["qdelta"]) / T
    if "uptrans" in x:
        # chanq is still the previous sub-step's discharge here
        chanq = st["chanq"]
        trans_out = torch.where(x["uptrans"] != 0, (chanq ** x["tp2"] - x["tsub"]) ** x["tp1"], chanq)
        loss = (chanq - trans_out) * dt_r
        sideflow_m3 = sideflow_m3 - loss
        st["trans"] = st["trans"] + loss
    if struct_out is not None:
        sideflow_m3 = sideflow_m3 + struct_out
    sideflow = torch.where(x["ischan"] != 0, sideflow_m3 * inv_dx / dt_r, 0.0)
    sideflow = torch.where(torch.isnan(sideflow), 0.0, sideflow)
    if not spec.split:
        if poly:
            cc = ups_t[:, 0] + x["adx1"] * st["qb1"] + sideflow * dx
            small = cc <= NEWTON_TOL
            v = _newton_v(torch.where(small, 1.0, cc), x["adx1"])
            v3 = v * v * v
            st["qb1"] = torch.where(small, 0.0, v3)
            q = torch.where(small, 0.0, v3 * v * v)
            st["m31"] = dx * x["alpha1"] * st["qb1"]
            st["q1"] = q
        else:
            cc = ups_t[:, 0] + x["adx1"] * st["q1"] ** beta + sideflow * dx
            q = _newton_unrolled(cc, x["adx1"], beta)
            st["m31"] = torch.clamp_min(dx * x["alpha1"] * q ** beta, 0.0)
            st["q1"] = (st["m31"] * inv_dx / x["alpha1"]) ** inv_beta
        st["chanq"] = st["q1"]
        q = q[None]
    else:
        # split the sideflow between main channel and floodplain
        m31, m32, adx = st["m31"], st["m32"], st["adx"]
        ratio_den = m31 + m32
        ratio = torch.where(ratio_den > 0, m31 / torch.where(ratio_den > 0, ratio_den, 1.0), 0.0)
        over = (m31 + m32 - x["chan2m3start"]) > x["m3limit"]
        s1 = torch.where(over, ratio * sideflow, sideflow)
        s1 = torch.where(sideflow.abs() < 1e-7, sideflow, s1)
        s2 = sideflow - s1 + st["c2q_dx"]
        lat = torch.stack([s1, s2]) * dx
        if poly:
            cc = ups_t.T + adx * torch.stack([st["qb1"], st["qb2"]]) + lat
            small = cc <= NEWTON_TOL
            v = _newton_v(torch.where(small, 1.0, cc), adx)
            v3 = v * v * v
            qb_n = torch.where(small, 0.0, v3)
            q = torch.where(small, 0.0, v3 * v * v)
            st["qb1"], st["q1"] = qb_n[0], q[0]
            st["m31"] = dx * x["alpha1"] * st["qb1"]
            m32r = dx * x["alpha2"] * qb_n[1]
            clamp2 = m32r - x["chan2m3start"] < 0.0
            st["m32"] = torch.where(clamp2, x["chan2m3start"], m32r)
            st["q2"] = torch.where(clamp2, st["q2_floor"], q[1])
            st["qb2"] = torch.where(clamp2, st["qb2_floor"], qb_n[1])
        else:
            cc = ups_t.T + adx * torch.stack([st["q1"], st["q2"]]) ** beta + lat
            q = _newton_unrolled(cc, adx, beta)
            st["m31"] = torch.clamp_min(dx * x["alpha1"] * q[0] ** beta, 0.0)
            st["q1"] = (st["m31"] * inv_dx / x["alpha1"]) ** inv_beta
            m32 = dx * x["alpha2"] * q[1] ** beta
            st["m32"] = torch.where(m32 - x["chan2m3start"] < 0.0, x["chan2m3start"], m32)
            st["q2"] = (st["m32"] * inv_dx / x["alpha2"]) ** inv_beta
        st["chanq"] = torch.clamp_min(st["q1"] + st["q2"] - x["qlimit"], 0.0)
        st["side1"] = s1
    st["sumdis"] = st["sumdis"] + st["chanq"]
    return q


def _store_lanes(spec, x, st, ys, c):
    """End-of-step outputs of chunk c's lanes."""
    ys["q1"][c], ys["m31"][c], ys["chanq"][c], ys["sumdis"][c] = (
        st["q1"], st["m31"], st["chanq"], st["sumdis"])
    if spec.split:
        ys["q2"][c], ys["m32"][c], ys["side1"][c] = st["q2"], st["m32"], st["side1"]
        ys["cross2"][c] = (st["m32"] - x["chan2m3start"]) * st["inv_dx"]
    if "uptrans" in x:
        ys["trans"][c] = st["trans"]


def substep_reference(spec, xs):
    """The plain PyTorch version of the sub-step kernel: a loop over chunks
    and sub-steps on (C,) rows, in float32 or float64, with the kernel's
    operation order. Returns the kernel's outputs."""
    n, C, W, T = spec.n_chunks, spec.chunk, spec.window, spec.T
    S, L, E = W + 1, (2 if spec.split else 1), spec.E
    dt_r = float(spec.dt_routing)
    ys = _init_outputs(spec, xs)
    # (T, N) structure inflow buffers, row 0 = the previous step's inflow
    bufs = {}
    for prefix in ("lk", "rs"):
        if prefix + "_pos" in xs:
            bufs[prefix] = xs["dx"].new_zeros(T, xs[prefix + "_pos"].numel())
            bufs[prefix][0] = xs[prefix + "_buf0"]
    ring = xs["dx"].new_zeros(S, T, L, C)
    ev_ring = xs["dx"].new_zeros(S, max(E - 1, 1), C)
    side = xs["dx"].new_zeros(T, C)
    ups = xs["ups"].long()
    ev_ups = xs["ev_ups"].long() if E else None
    own, feed = _chunk_plan(xs, C)
    row_names = _row_names(spec, xs)

    for c in range(n):
        sl = slice(c * C, (c + 1) * C)
        slot = c % S
        x = {k: xs[k][c] for k in row_names}

        eva_dt = None
        if E:
            ev_in = _upstream_sum(ev_ring, ev_ups[:, sl], C, S) if E > 1 else None
            ev = _eva_state(x)
            for h in range(E):
                hop = _eva_hop(ev, x["ev_up0"] if h == 0 else ev_in[:, h - 1])
                if h < E - 1:
                    ev_ring[slot, h] = hop
            ys["ev_add"][c] = ev["eva_add"]
            eva_dt = ev["eva_add"] * (1.0 / T)

        # the whole chain of each structure this chunk owns, before its
        # sub-steps: the inflow buffers are complete
        owned = own.get(c, {})
        for prefix, idx in owned.items():
            idx = torch.tensor(idx, device=side.device)
            lanes = xs[prefix + "_pos"][idx].long() % C
            for t in range(T):
                side[t, lanes] = _STRUCTURE_STEP[prefix](xs, ys, idx, bufs[prefix][t, idx], dt_r)

        ups_in = _upstream_sum(ring, ups[:, sl], C, S)     # (C, T, L)
        st = _lane_state(spec, x, eva_dt)
        chanq_rows = []
        for t in range(T):
            ring[slot, t] = _substep(spec, x, st, t, ups_in[:, t], side[t] if owned else None)
            chanq_rows.append(st["chanq"])
        _store_lanes(spec, x, st, ys, c)
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
     "ev_up0", "eva", "wuse", "qin_old", "qdelta", "uptrans", "tp1", "tp2", "tsub",
     "ups", "ev_ups",
     "lk_pos", "lk_fee", "lk_fee_w", "lk_factor", "lk_factorsqr", "lk_area", "lk_buf0",
     "lk_st", "lk_inold", "lk_in", "lk_out", "lk_bal", "lk_level", "lk_sumin",
     "lk_sumout",
     "rs_pos", "rs_fee", "rs_fee_w", "rs_tot", "rs_cons", "rs_norm", "rs_flood",
     "rs_nfl", "rs_nondam", "rs_normout", "rs_minout", "rs_do", "rs_dln",
     "rs_dnfl", "rs_buf0", "rs_st", "rs_fill", "rs_sumin", "rs_sumout",
     "q1", "m31", "chanq", "sumdis", "q2", "m32", "cross2", "side1", "ev_add", "trans",
     "deps", "own_ptr", "own_list", "feed_ptr", "feed_ent", "sdep_ptr", "sdep_list", "fee_ord",
     "qring", "ev_ring", "stage", "ctrl"])
# kernel argument name -> operand name, where they differ
_OPERAND_OF = {"tochan": "ToChan", "c2m3s": "chan2m3start", "c2qs": "chan2qstart",
               **{k[3:]: k for k in WAVEFRONT_TABLES}}


class _Args(ctypes.Structure):
    """Mirror of struct SubstepArgs in csrc/kinwave_substep.cu."""
    _fields_ = ([(k, ctypes.c_int) for k in ("n_chunks", "chunk", "window", "T", "split",
                                               "E", "K", "KE", "NL", "NR",
                                               "blocks", "ring", "D")]
                + [("dt_routing", ctypes.c_double), ("beta", ctypes.c_double)]
                + [(k, ctypes.c_void_p) for k in _PTR_FIELDS])


@functools.cache
def _library():
    from . import _build
    lib = _build.load("kinwave_substep")
    int_p = ctypes.POINTER(ctypes.c_int)
    lib.kinwave_substep_plan.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_int,
                                         int_p, int_p]
    lib.kinwave_substep_plan.restype = ctypes.c_int
    lib.kinwave_substep_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    lib.kinwave_substep_launch.restype = ctypes.c_int
    lib.kinwave_substep_error_string.argtypes = [ctypes.c_int]
    lib.kinwave_substep_error_string.restype = ctypes.c_char_p
    return lib


def ring_slots(blocks, spec):
    """Slots of the discharge ring for `blocks` chunks in flight: 2 * blocks +
    W, so that a block that runs ahead finds its slot free (the kernel's reuse
    guard makes any depth >= W + 1 safe), and never more than the chunks."""
    return max(min(2 * blocks + spec.window, spec.n_chunks), spec.window + 1)


def _launch(spec, xs, blocks=None):
    """One launch of the CUDA kernel on the current stream, with the number
    of blocks the launcher's rule gives (`blocks` overrides it: a diagnostic
    of chip_smoke.py, refused above the co-resident limit). The wrapper
    allocates outputs and scratch; the kernel allocates nothing. The plan of
    the launch is left in `kinwave_substep.last_plan`."""
    if not 1 <= spec.chunk <= MAX_CHUNK:
        raise ValueError(f"the kernel runs one thread per lane: chunk size "
                         f"{spec.chunk} outside 1..{MAX_CHUNK}")
    lib = _library()
    dx = xs["dx"]
    dev = dx.device
    L = 2 if spec.split else 1
    lakes, reservoirs = _structures(xs)
    NL = xs["lk_pos"].numel() if lakes else 0
    NR = xs["rs_pos"].numel() if reservoirs else 0
    ys = _init_outputs(spec, xs)
    args = _Args(n_chunks=spec.n_chunks, chunk=spec.chunk, window=spec.window,
                 T=spec.T, split=int(spec.split), E=spec.E,
                 K=xs["ups"].shape[0], KE=xs["ev_ups"].shape[0] if spec.E else 0,
                 NL=NL, NR=NR, D=xs["wf_deps"].shape[1],
                 dt_routing=float(spec.dt_routing), beta=float(spec.beta))
    tensors = {**xs, **ys}
    for f in _PTR_FIELDS:
        v = tensors.get(_OPERAND_OF.get(f, f))
        if v is not None:
            setattr(args, f, v.data_ptr())
    is_double, poly = int(dx.dtype == torch.float64), int(_poly(spec, dx.dtype))

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"kinwave_substep {what} failed: "
                               + lib.kinwave_substep_error_string(rc).decode())

    with torch.cuda.device(dev):
        planned, limit = ctypes.c_int(0), ctypes.c_int(0)
        check(lib.kinwave_substep_plan(ctypes.byref(args), is_double, poly,
                                       ctypes.byref(planned), ctypes.byref(limit)), "plan")
        args.blocks = planned.value if blocks is None else int(blocks)
        args.ring = ring_slots(args.blocks, spec)
        scratch = {
            "qring": dx.new_empty(args.ring * spec.T * L * spec.chunk),
            "ev_ring": dx.new_empty(args.ring * max(spec.E - 1, 1) * spec.chunk),
            "stage": dx.new_empty(max(NL + NR, 1) * FEEDERS * spec.T),
            # progress flags and the ticket counter: must start at zero
            "ctrl": torch.zeros(spec.n_chunks + 1, dtype=torch.int32, device=dev),
        }
        for f, v in scratch.items():
            setattr(args, f, v.data_ptr())
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(lib.kinwave_substep_launch(ctypes.byref(args), is_double, poly,
                                         ctypes.c_void_p(stream)), "launch")
    kinwave_substep.launches += 1
    kinwave_substep.last_plan = {"blocks": args.blocks, "limit": limit.value, "ring": args.ring}
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
kinwave_substep.last_plan = None

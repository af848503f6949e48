"""Packed kinematic-wave routing — the port of lisflood_tpu/ops/kinwave_packed.py.

The schedule's pixels are renumbered host-side into *schedule order*, so
chunk ``c`` occupies positions ``[c*C, (c+1)*C)``, and a pixel's downstream
neighbour falls inside a bounded window of the next W chunks. The Newton
solvers reproduce the reference (kinematic_wave_parallel_tools.py:48-87)
with a fixed iteration count; the float32 beta=3/5 path solves the
transcendental-free polynomial v^5 + a*v^3 = c.

The JAX package's `_sweep` is an XLA scan; here it is a plain loop over the
chunks. It serves overland routing on schedules with edges (real
catchments), which the synthetic model does not have: its overland schedule
is edge-free, so overland routing there is the elementwise `newton_solve`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

NEWTON_TOL = 1e-12
# 6 masked q-space iterations reach <=1e-12 over the adversarial sweep in
# tests/test_kinwave.py; float32 iterates freeze at the ulp after 4
NEWTON_FIXED_ITERS = 6
NEWTON_FIXED_ITERS_F32 = 4
# v-space iteration count: 5 reach the float32 noise floor
NEWTON_V_ITERS = 5


def _root_est(x, p):
    """Exponent bit-hack estimate of x**p for float32 x > 0, p in (0, 1):
    scale the float's bit pattern linearly. Error <~7%, always polished by
    Newton. `.to(torch.int32)` truncates toward zero like numpy's astype."""
    i = x.view(torch.int32)
    f = i.to(torch.float32) * p + (1.0 - p) * 1065353216.0
    return f.to(torch.int32).view(torch.float32)


def _newton_v(cc, a, iters=NEWTON_V_ITERS):
    """Kinematic-wave solve for beta = 3/5 with no transcendentals:
    q + a*q^0.6 = cc with v = q^(1/5) is v^5 + a*v^3 = cc. Newton from the
    bit-hack guess min(cc^(1/5), (cc/a)^(1/3)) * 1.12 converges monotonically
    from above. Returns v (callers use v^3 = q^0.6 and v^5 = q).

    Caller contract: cc > 0 (mask cc <= NEWTON_TOL outside)."""
    va = _root_est(cc, 0.2)
    vb = _root_est(cc / a, 1.0 / 3.0)
    v = torch.minimum(va, vb) * 1.12
    for _ in range(iters):
        v2 = v * v
        v3 = v2 * v
        v4 = v2 * v2
        g = v * v4 + a * v3 - cc
        gp = 5.0 * v4 + 3.0 * a * v2
        v = v - g / gp
    return v


def newton_solve(const_plus_ups, a_dx_div_dt, beta, iters=None):
    """Solver dispatch for Q + a*dx/dt*Q^beta = const: float32 with
    beta = 3/5 takes the polynomial v-space path; float64 and any other beta
    the reference q-space iteration (_newton_unrolled)."""
    if const_plus_ups.dtype == torch.float32 and abs(float(beta) - 0.6) < 1e-9:
        small = const_plus_ups <= NEWTON_TOL
        cc = torch.where(small, 1.0, const_plus_ups)
        v = _newton_v(cc, a_dx_div_dt, iters=iters or NEWTON_V_ITERS)
        v3 = v * v * v
        return torch.where(small, 0.0, v3 * v * v)
    return _newton_unrolled(const_plus_ups, a_dx_div_dt, beta, iters)


def _newton_unrolled(const_plus_ups, a_dx_div_dt, beta, iters=None):
    """Newton-Raphson for Q + a*dx/dt*Q^beta = const_plus_ups with the
    reference's secant-bound initial guess and convergence mask, run for a
    fixed iteration count (converged lanes freeze)."""
    if iters is None:
        iters = (NEWTON_FIXED_ITERS_F32
                 if const_plus_ups.dtype == torch.float32 else NEWTON_FIXED_ITERS)
    inv_beta = 1.0 / beta
    b_minus_1 = beta - 1.0
    b_a_dx = beta * a_dx_div_dt

    small = const_plus_ups <= NEWTON_TOL
    c = torch.where(small, 1.0, const_plus_ups)

    a_cpui_pow = b_a_dx * c ** b_minus_1
    secant_bound = torch.where(
        a_cpui_pow <= 1.0,
        c / (1.0 + a_cpui_pow),
        c / (1.0 + a_cpui_pow ** inv_beta),
    )
    other_bound = ((c - secant_bound) / a_dx_div_dt) ** inv_beta
    q = 0.5 * (secant_bound + other_bound)
    prev = torch.full_like(q, -1.0)
    for _ in range(iters):
        powq = q ** beta
        err = q + a_dx_div_dt * powq - c
        active = (err.abs() > NEWTON_TOL) & (q != prev)
        q_next = torch.clamp_min(q - err / (1.0 + b_a_dx * powq / q), NEWTON_TOL)
        q, prev = torch.where(active, q_next, q), torch.where(active, q, prev)
    q = torch.where(q == NEWTON_TOL, 0.0, q)
    return torch.where(small, 0.0, q)


@dataclass
class PackedSchedule:
    """Host-side renumbering of a RoutingSchedule into schedule order."""

    perm: np.ndarray         # (p_pad,) position -> natural pixel index (P = padding)
    inv_perm: np.ndarray     # (P,) natural pixel -> position
    down_local: np.ndarray   # (n_chunks, C) int32 local window offset in [0, W*C]; W*C = none
    down_pos: np.ndarray     # (p_pad,) int32 downstream position, p_pad = pit/padding
    n_chunks: int
    chunk: int
    window: int              # W: max chunk distance to the downstream chunk
    num_pixels: int

    @property
    def p_pad(self):
        return self.n_chunks * self.chunk

    def pack_np(self, x, fill=0.0):
        """Host-side natural -> packed reorder of a trailing pixel axis."""
        x = np.asarray(x)
        shape = x.shape[:-1] + (1,)
        xp = np.concatenate([x, np.full(shape, fill, x.dtype)], axis=-1)
        src = np.where(self.perm < self.num_pixels, self.perm, self.num_pixels)
        return xp[..., src]


def pack_schedule(schedule) -> PackedSchedule:
    """Renumber a schedule (anything with `chunks`, `downstream`,
    `num_pixels`) into positions and express every pixel's downstream as a
    local offset into the window of the next W chunks."""
    P = int(schedule.num_pixels)
    chunks = np.asarray(schedule.chunks)          # (n_chunks, C), pad value = P
    n_chunks, C = chunks.shape
    perm = chunks.reshape(-1).astype(np.int64)    # position -> pixel (P = pad)
    p_pad = n_chunks * C
    valid = perm < P
    inv_perm = np.empty(P, dtype=np.int64)
    inv_perm[perm[valid]] = np.flatnonzero(valid)

    down_nat = np.asarray(schedule.downstream)    # (P+1,), P = pit
    pos = np.flatnonzero(valid)
    tgt_nat = down_nat[perm[valid]]
    has_down = tgt_nat < P
    tgt_pos = np.full(pos.size, -1, dtype=np.int64)
    tgt_pos[has_down] = inv_perm[tgt_nat[has_down]]

    src_chunk = pos // C
    delta = tgt_pos // C - src_chunk
    if has_down.any():
        if delta[has_down].min() < 1:
            raise ValueError("schedule: a downstream pixel is not in a later chunk")
        window = int(delta[has_down].max())
    else:
        window = 1
    down_local = np.full(p_pad, window * C, dtype=np.int32)
    local = tgt_pos - (src_chunk + 1) * C
    down_local[pos[has_down]] = local[has_down].astype(np.int32)
    down_pos = np.full(p_pad, p_pad, dtype=np.int32)
    down_pos[pos[has_down]] = tgt_pos[has_down].astype(np.int32)
    return PackedSchedule(perm=perm, inv_perm=inv_perm,
                          down_local=down_local.reshape(n_chunks, C),
                          down_pos=down_pos,
                          n_chunks=n_chunks, chunk=C, window=window,
                          num_pixels=P)


def _sweep(const_p, adx_p, down_local, window, beta):
    """The wavefront sweep over packed operands, one chunk at a time.

    const_p/adx_p: (n_chunks, L, C); down_local: (n_chunks, C) int64.
    Returns q (n_chunks, L, C). The rolling window holds, at chunk c, the
    accumulated upstream inflow for chunks [c, c+W); slot W*C is a dump for
    lanes without a downstream neighbour."""
    n_chunks, L, C = const_p.shape
    W = window
    win = const_p.new_zeros(L, W * C)
    qs = torch.empty_like(const_p)
    for c in range(n_chunks):
        q = newton_solve(win[:, :C] + const_p[c], adx_p[c], beta)
        qs[c] = q
        add = q.new_zeros(L, W * C + 1).index_add_(1, down_local[c], q)[:, :W * C]
        win = torch.cat([win[:, C:], win.new_zeros(L, C)], dim=1) + add
    return qs


class PackedRouter:
    """Wavefront router over a packed schedule; natural-order interface
    (reference semantics: kinematic_wave_parallel.py:160-184 +
    kinematic_wave_parallel_tools.py:34-92)."""

    def __init__(self, schedule, device):
        ps = pack_schedule(schedule)
        self.ps = ps
        self.device = torch.device(device)
        # an edge-free graph (every pixel its own pit) solves elementwise
        self.no_edges = bool((ps.down_local == ps.window * ps.chunk).all())
        # gather indices: padding positions read slot P of a (P+1)-padded source
        self.perm = torch.as_tensor(
            np.where(ps.perm < ps.num_pixels, ps.perm, ps.num_pixels), device=self.device)
        self.inv_perm = torch.as_tensor(ps.inv_perm, device=self.device)
        self.down_local = torch.as_tensor(ps.down_local.astype(np.int64), device=self.device)

    def pack(self, x, fill=0.0):
        """Natural (..., P) -> packed (..., p_pad) reorder on the device."""
        xp = torch.cat([x, x.new_full(x.shape[:-1] + (1,), fill)], dim=-1)
        return xp[..., self.perm]

    def unpack(self, xp):
        """Packed (..., p_pad) -> natural (..., P)."""
        return xp[..., self.inv_perm]

    def _route_const(self, constant, a_dx_div_dt, beta):
        """Sweep over packed (L, p_pad) constant/adx operands."""
        ps = self.ps
        L = constant.shape[0]
        shape = (L, ps.n_chunks, ps.chunk)
        qs = _sweep(constant.reshape(shape).transpose(0, 1).contiguous(),
                    a_dx_div_dt.reshape(shape).transpose(0, 1).contiguous(),
                    self.down_local, ps.window, float(beta))
        return qs.transpose(0, 1).reshape(L, ps.p_pad)

    def route_packed(self, discharge, lateral_inflow, a_dx_div_dt, beta):
        """(L, p_pad) packed-order operands -> (L, p_pad) routed discharge."""
        constant = a_dx_div_dt * discharge ** beta + lateral_inflow
        if self.no_edges:
            return newton_solve(constant, a_dx_div_dt, float(beta))
        return self._route_const(constant, a_dx_div_dt, beta)

    def route_batched(self, discharge, lateral_inflow, a_dx_div_dt, beta):
        """(L, P) natural-order operands -> (L, P) routed discharge."""
        constant = a_dx_div_dt * discharge ** beta + lateral_inflow
        if self.no_edges:
            return newton_solve(constant, a_dx_div_dt, float(beta))
        q_p = self._route_const(self.pack(constant), self.pack(a_dx_div_dt, 1.0), beta)
        return self.unpack(q_p)

    def route(self, discharge, lateral_inflow, a_dx_div_dt, beta):
        """Single-lane convenience wrapper."""
        return self.route_batched(discharge[None], lateral_inflow[None],
                                  a_dx_div_dt[None], beta)[0]

"""Kinematic-wave routing over the natural-order schedule — the port of
lisflood_tpu/ops/kinwave.py (RoutingKernel scan).

The JAX package's `_route_batched` is an XLA scan over the chunks of a
natural-order schedule (graph/ldd.build_schedule): per chunk it gathers the
accumulated upstream inflow, solves Q + adx·Q^β = inflow + adx·Qold^β + q·dx
by Newton and scatter-adds Q into the downstream accumulator. Here the
sweep is K6 (csrc/kinwave_sharded.cu through
ops/kinwave_sharded.kinwave_sharded_sweep) on tables of the natural graph:
position space is pixel space (p_pad = P, no padding, `pack` and `unpack`
the identity), so K6's trees are the schedule's own. Each pixel GATHERS its
sources in ascending pixel order (ops/wavefront.upstream_table) instead of
having them scattered into it, in the kernel and in the plain version
`_route_batched` alike, so the two agree bit for bit; the JAX package's
scatter-add leaves that order to XLA.

The Newton solve is `_newton_solve`, the one K6 and the packed routers
solve with (ops/kinwave_packed.newton_solve): in float64, and for any beta
but 3/5, the JAX package's 6 masked q-space iterations from the secant
bounds (float32 4); in float32 at beta = 3/5 the polynomial v-space solve.

One rank of the multi-process step (parallel/shard_model.ScanRankLayout)
routes its own natural pixels with RankScanRouter: K6 on the natural graph
cut to its own pixels and the other ranks' pixels upstream of them (its
halo, closed upstream), whose operands arrive before each launch. Every
local pixel keeps its sources in the whole table's order, so a rank's
discharge is the one-process discharge bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from .kinwave_packed import PackedSchedule, newton_solve
from .kinwave_sharded import RankRouter, RingTiles, kinwave_sharded_sweep, ring_tables
from .wavefront import SWEEP_CAP, upstream_table


def _newton_solve(const_plus_ups, a_dx_div_dt, beta):
    """Q + a·dx/dt·Q^beta = const_plus_ups, elementwise (module
    docstring)."""
    return newton_solve(const_plus_ups, a_dx_div_dt, float(beta))


def _sweep_scan(const, adx, chunks, ups, beta):
    """The plain version of the sweep over a natural-order schedule, one
    chunk at a time: const/adx (L, P); chunks (n_chunks, C) int64 pixels, P
    = padding; ups (K, P) int64 sources of every pixel, ascending, -1 =
    none. Each chunk's pixels sum their sources' discharges in the table's
    order (every source lies in an earlier chunk), add const and solve.
    Returns q (L, P)."""
    L, P = const.shape
    pad = lambda x, v: torch.cat([x, x.new_full((L, 1), v)], dim=1)
    const_p, adx_p = pad(const, 0.0), pad(adx, 1.0)
    ups_p = torch.cat([ups, ups.new_full((ups.shape[0], 1), -1)], dim=1)
    q = torch.zeros_like(const_p)
    for c in range(chunks.shape[0]):
        idx = chunks[c]
        src = ups_p[:, idx]                                   # (K, C)
        valid = src >= 0
        vals = q[:, src.clamp_min(0)]                         # (L, K, C)
        inflow = const.new_zeros(L, idx.numel())
        for k in range(src.shape[0]):
            inflow = inflow + torch.where(valid[k], vals[:, k], 0.0)
        q[:, idx] = _newton_solve(inflow + const_p[:, idx], adx_p[:, idx], beta)
    return q[:, :P]


def _route_batched(discharge, lateral_inflow, a_dx_div_dt, chunks, ups, beta):
    """The plain version of ScanRouter.route_batched: all (L, P) lanes routed
    over one natural-order schedule (`chunks`, and the sources `ups` of
    upstream_table) in one sweep."""
    constant = a_dx_div_dt * discharge ** beta + lateral_inflow
    return _sweep_scan(constant, a_dx_div_dt.expand_as(constant), chunks, ups, beta)


@dataclass(frozen=True)
class ScanTiles(RingTiles):
    """K6's tables of a natural-order graph (every pixel tiled, none left
    out), with the schedule's chunks, which the plain version reads."""

    chunks: torch.Tensor
    num_pixels: int

    @property
    def p_pad(self):
        return self.num_pixels

    def reference(self, const_p, adx_p, beta):
        return _sweep_scan(const_p, adx_p, self.chunks, self.ups.long(), beta)


@dataclass
class NaturalSchedule:
    """The identity position space of a natural-order schedule, with the
    fields models/step.packed_routing_params reads (its parameters are then
    the natural ones)."""

    perm: np.ndarray         # (P,) position -> pixel: the identity
    inv_perm: np.ndarray     # (P,) pixel -> position: the identity
    down_pos: np.ndarray     # (P,) int32 downstream pixel, P = pit
    n_chunks: int
    chunk: int
    num_pixels: int

    @property
    def p_pad(self):
        return self.num_pixels

    pack_np = PackedSchedule.pack_np


def natural_schedule(schedule):
    """The NaturalSchedule of a natural-order schedule (anything with
    `chunks`, `downstream` and `num_pixels`; a downstream of P or more is
    none)."""
    P = int(schedule.num_pixels)
    chunks = np.asarray(schedule.chunks)
    down = np.asarray(schedule.downstream, np.int64)[:P]
    ident = np.arange(P)
    return NaturalSchedule(perm=ident, inv_perm=ident,
                           down_pos=np.minimum(down, P).astype(np.int32),
                           n_chunks=chunks.shape[0], chunk=chunks.shape[1], num_pixels=P)


def natural_upstream(ps):
    """(K, P) int32: every pixel's sources of the NaturalSchedule `ps`,
    ascending (upstream_table), the order the sweep sums them in."""
    P = ps.num_pixels
    has_down = ps.down_pos < P
    return upstream_table(np.flatnonzero(has_down), ps.down_pos[has_down], P)


class ScanRouter:
    """Router over a natural-order schedule (anything with `chunks`,
    `downstream` and `num_pixels`), with the interface of the packed and
    sharded routers: pack / unpack (the identity), route_packed (=
    route_batched), route and the position space `ps`. An edge-free graph
    solves elementwise."""

    def __init__(self, schedule, device=None):
        self.ps = natural_schedule(schedule)
        self.device = resolve_device(device)
        self.no_edges = not bool((self.ps.down_pos < self.ps.num_pixels).any())
        self.chunks = torch.as_tensor(np.asarray(schedule.chunks, np.int64), device=self.device)
        self.ups = torch.as_tensor(natural_upstream(self.ps), device=self.device)
        self._tiles = {}

    def sweep_tiles(self, cap=SWEEP_CAP):
        """K6's ScanTiles at `cap`, built at first use, once per cap
        (models/step.build_routers builds them with the step)."""
        if cap not in self._tiles:
            self._tiles[cap] = ring_tables(ScanTiles, self.ps.down_pos, self.ups,
                                           self.ps.num_pixels, cap, chunks=self.chunks,
                                           num_pixels=self.ps.num_pixels)
        return self._tiles[cap]

    def pack(self, x, fill=0.0):
        return x

    def unpack(self, x):
        return x

    def sweep_operands(self, discharge, lateral_inflow, a_dx_div_dt, beta):
        """(L, P) lanes -> K6's (const, adx) operands."""
        constant = a_dx_div_dt * discharge ** beta + lateral_inflow
        return constant.contiguous(), a_dx_div_dt.expand_as(constant).contiguous()

    def route_batched(self, discharge, lateral_inflow, a_dx_div_dt, beta):
        """(L, P) operands -> (L, P) routed discharge: K6 on a CUDA tensor,
        its plain version on a CPU tensor."""
        const, adx = self.sweep_operands(discharge, lateral_inflow, a_dx_div_dt, beta)
        if self.no_edges:
            return _newton_solve(const, adx, beta)
        return kinwave_sharded_sweep(const, adx, self.sweep_tiles(), float(beta))

    route_packed = route_batched

    def route(self, discharge, lateral_inflow, a_dx_div_dt, beta):
        """Single-lane convenience wrapper."""
        return self.route_batched(discharge[None], lateral_inflow[None],
                                  a_dx_div_dt[None], beta)[0]


# ---------------------------------------------------------------------------
# one rank's part of the sweep (parallel/shard_model.ScanRankLayout): its own
# natural pixels and its upstream halo


@dataclass(frozen=True)
class RankScanTiles(ScanTiles):
    """K6's tables of one rank's local natural graph (rank_scan_tables): its
    own pixels, then its halo, `glob` (n_loc,) their natural pixels. The
    plain version (ScanTiles.reference) runs `_sweep_scan` on the schedule's
    chunks that hold a local pixel, cut to the local pixels: the halo is
    closed upstream, so every source of a local pixel is local and lies in
    an earlier chunk. Each local pixel keeps its lane, so every chunk solves
    (L, C) lanes as in the whole sweep and the CPU's vector loops take each
    pixel down the same path (their scalar remainder computes pow in another
    last bit)."""

    glob: torch.Tensor


def rank_scan_tables(ps, ups_np, chunks_np, glob, device, cap=SWEEP_CAP):
    """RankScanTiles of the pixels `glob` (a rank's own, then its halo,
    closed upstream) of the NaturalSchedule `ps` with source table `ups_np`
    (K, P) (natural_upstream) and chunks `chunks_np` (n_chunks, C; P =
    padding), on `device`: local downstream pixels (none where the
    downstream pixel is not local), each local pixel's sources in the whole
    table's order (raises where one is not local), and the chunks that hold
    a local pixel with every local pixel in its lane, the other lanes
    padding (n_loc)."""
    P, n = ps.num_pixels, glob.size
    loc_of = np.full(P + 1, -1, np.int64)
    loc_of[glob] = np.arange(n)
    down = loc_of[ps.down_pos[glob]]
    down_loc = np.where(down >= 0, down, n).astype(np.int32)
    src = np.asarray(ups_np, np.int64)[:, glob]
    ups_loc = np.where(src >= 0, loc_of[np.where(src >= 0, src, P)], -1)
    if ((src >= 0) & (ups_loc < 0)).any():
        raise ValueError("rank_scan_tables: a source of a local pixel is not local: the halo "
                         "is not closed upstream")
    loc = loc_of[np.minimum(np.asarray(chunks_np, np.int64), P)]
    loc = loc[(loc >= 0).any(1)]
    chunks = np.where(loc >= 0, loc, n)
    ups_t = torch.as_tensor(np.ascontiguousarray(ups_loc, np.int32), device=device)
    return ring_tables(RankScanTiles, down_loc, ups_t, n, cap,
                       chunks=torch.as_tensor(chunks, device=device), num_pixels=n,
                       glob=torch.as_tensor(glob, device=device))


class RankScanRouter(ScanRouter):
    """One rank's ScanRouter (parallel/shard_model.ScanRankLayout): its
    operands are (L, n_own) over its own natural pixels (`part["own"]`,
    ascending), pack / unpack the identity. Before each sweep the operands
    (const, adx) of its halo come from their owners, one all_gather of every
    rank's `send` pixels (padded to `send_max`), when any rank has a halo;
    K6 then runs on the rank's local tables (RankScanTiles) and the rank
    keeps its own pixels. No value crosses ranks inside a launch. An
    edge-free graph (the whole graph's) solves elementwise."""

    def __init__(self, schedule, part, group, device):
        self.ps = natural_schedule(schedule)
        self.device = torch.device(device)
        self.group = group
        self.no_edges = not bool((self.ps.down_pos < self.ps.num_pixels).any())
        self.own, self.halo = part["own"], part["halo"]
        self.exchange, self.send_max = part["exchange"], part["send_max"]
        self.send = torch.as_tensor(np.searchsorted(self.own, part["send"]), device=self.device)
        self.halo_src = torch.as_tensor(part["halo_src"], device=self.device)
        self._chunks = np.asarray(schedule.chunks)
        self._ups = None
        self._tiles = {}

    def sweep_tiles(self, cap=SWEEP_CAP):
        """K6's RankScanTiles at `cap`, built at first use, once per cap."""
        if cap not in self._tiles:
            if self._ups is None:
                self._ups = natural_upstream(self.ps)
            self._tiles[cap] = rank_scan_tables(self.ps, self._ups, self._chunks,
                                                np.r_[self.own, self.halo], self.device, cap)
        return self._tiles[cap]

    with_halo = RankRouter.with_halo

    def route_batched(self, discharge, lateral_inflow, a_dx_div_dt, beta):
        """The rank's (L, n_own) operands -> (L, n_own) routed discharge."""
        const, adx = self.sweep_operands(discharge, lateral_inflow, a_dx_div_dt, beta)
        if self.no_edges:
            return _newton_solve(const, adx, beta)
        const_l, adx_l = self.with_halo(const, adx)
        q = kinwave_sharded_sweep(const_l, adx_l, self.sweep_tiles(), float(beta))
        return q[:, :self.own.size]

    route_packed = route_batched


@dataclass
class KinematicWaveRouter:
    """Router bound to a drainage schedule and channel geometry, with the
    optional floodplain (split-routing) section (kinematic_wave_parallel.py:
    114-184)."""

    router: ScanRouter
    space_delta: torch.Tensor    # (P,) dx [m]
    beta: float
    a_dx_div_dt_channel: torch.Tensor
    a_dx_div_dt_floodplains: torch.Tensor | None = None

    @classmethod
    def build(cls, schedule, alpha_channel, beta, space_delta, time_delta,
              alpha_floodplains=None, dtype=torch.float64, device=None):
        router = ScanRouter(schedule, device)
        as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=router.device)
        space_delta = as_t(space_delta) * torch.ones(router.ps.num_pixels, dtype=dtype,
                                                     device=router.device)
        a_main = as_t(alpha_channel) * space_delta / time_delta
        a_flood = None
        if alpha_floodplains is not None:
            a_flood = as_t(alpha_floodplains) * space_delta / time_delta
        return cls(router=router, space_delta=space_delta, beta=float(beta),
                   a_dx_div_dt_channel=a_main, a_dx_div_dt_floodplains=a_flood)

    def routing(self, discharge, specific_lateral_inflow, section="main_channel"):
        """One routing sub-step; returns the updated discharge vector."""
        if section == "main_channel":
            adx = self.a_dx_div_dt_channel
        elif section == "floodplains":
            adx = self.a_dx_div_dt_floodplains
        else:
            raise ValueError("section must be 'main_channel' or 'floodplains'")
        lateral = specific_lateral_inflow * self.space_delta
        return self.router.route(discharge, lateral, adx, self.beta)

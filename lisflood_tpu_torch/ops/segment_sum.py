"""Segment sums in a fixed order (K7): the port of lisflood_tpu/ops/physics.py
segment_spread / scatter_to_downstream, whose `jax.ops.segment_sum` is
bitwise repeatable.

A `SegmentOrder`, built once on the host from a constant segment array,
fixes the order of every addition:
  - each segment's members, in ascending index order, are cut into pieces of
    PIECE members;
  - within a piece, lane l of LANES sums the members l, l + LANES, l + 2
    LANES, ... in that order from +0, then a fixed tree adds the lanes:
    lane l += lane l + h for h = LANES / 2, ..., 2, 1;
  - a segment's total is +0 plus its pieces' sums in ascending piece order.
Lanes that hold no member hold +0, which adds nothing (a lane sum that starts
from +0 is never -0), so the tree over the first g lanes of a piece of at
most g <= LANES members gives the same bits as the tree over all of them.

`segment_total`, `segment_spread` and `scatter_to_downstream` run the CUDA
kernel csrc/segment_sum.cu on a CUDA tensor (counted in
`segment_total.launches`, one a call of one or two kernel launches; no sum is
atomic, so the same bits in every run and for any launch configuration) and
the plain version `segment_sum` on a CPU tensor; any other device raises.
The plain version makes every addition explicit (torch.sum leaves its order
open) and groups the pieces by shape so that a class of pieces is added as
one tensor.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import time
from dataclasses import dataclass, field

import numpy as np
import torch

# members of a piece, lanes of a piece's pattern
PIECE = 1024
LANES = 32
# segments of at most SMALL members are summed one to a thread in the kernel
# (its tree over SMALL lanes), the pieces of the others one to a warp
SMALL = 8


def _pow2_at_least(n):
    """The least power of two >= n, elementwise, for n >= 1."""
    return 1 << np.ceil(np.log2(np.maximum(n, 1))).astype(np.int64)


@dataclass(frozen=True)
class SegmentOrder:
    """The order of a segment sum over a constant segment array, on one
    device. Segments >= `count` are left out (scatter_to_downstream's pit
    segment P).

      perm (M,) int32: the members of segments < count, by segment, each
          segment's in ascending index order;
      n_pieces: the number of pieces (a segment's are consecutive);
      seg_ptr (count + 1,) int32: each segment's first entry of perm;
      items (n_items, 4) int32: the kernel's warp items, {first entry of
          perm, members, target, multi}: the pieces of the segments of more
          than one piece first (multi their index among those segments,
          target the piece's slot in `partial`), then the pieces of more
          than SMALL members of the others (multi -1, target the segment);
      multi (n_multi, 3) int32: the segments of more than one piece, {first
          slot, pieces, segment};
      tickets (n_multi,) int32, partial, multi_totals (float64, read as the
          values' type): the kernel's scratch, kept with the order so that a
          call allocates only its output; the tickets are 0 between calls,
          and the calls of one order run one at a time: on the stream of
          its first call on the card, `stream`, another raising, and once
          a CUDA graph has captured a call, only in that graph's replays
          (own_scratch gives a graph an order of its own);
      segments (size,) int32: each member's segment (the spread's gather);
      classes: the plain version's pieces grouped by (rows, lanes): piece
          ids and (n, rows, lanes) member indices, -1 where none;
      by_pieces, n_active: the segments by descending piece count and, for
          each j, how many have more than j pieces (the plain second pass)."""

    size: int
    num_segments: int
    count: int
    perm: torch.Tensor
    n_pieces: int
    seg_ptr: torch.Tensor
    items: torch.Tensor
    multi: torch.Tensor
    n_multi_items: int
    tickets: torch.Tensor
    partial: torch.Tensor
    multi_totals: torch.Tensor
    segments: torch.Tensor
    classes: tuple
    by_pieces: torch.Tensor
    first_piece: torch.Tensor
    n_active: np.ndarray
    stats: dict
    stream: dict = field(default_factory=dict, compare=False, repr=False)

    @classmethod
    def build(cls, segments, num_segments, count=None, device="cpu"):
        """The order of a sum over `segments` (size,) in [0, num_segments),
        totals of the segments below `count` (all by default)."""
        t0 = time.perf_counter()
        seg = np.asarray(segments, np.int64).reshape(-1)
        count = num_segments if count is None else int(count)
        if seg.size and (seg.min() < 0 or seg.max() >= num_segments):
            raise ValueError(f"segment ids outside [0, {num_segments})")
        if seg.size >= 2 ** 31:
            raise ValueError("the kernel indexes members with int32")
        keep = seg < count
        perm = np.flatnonzero(keep)
        perm = perm[np.argsort(seg[perm], kind="stable")]
        members = np.bincount(seg[perm], minlength=count)
        seg_ptr = np.r_[0, np.cumsum(members)]
        pieces = -(-members // PIECE)
        seg_piece = np.r_[0, np.cumsum(pieces)]
        n_pieces = int(seg_piece[-1])
        owner = np.repeat(np.arange(count), pieces)
        j = np.arange(n_pieces) - seg_piece[owner]
        start = seg_ptr[owner] + j * PIECE
        length = np.minimum(PIECE, seg_ptr[owner + 1] - start)

        # the plain version's classes: pieces of one row by their lanes (the
        # least power of two >= their length), longer ones by their rows
        rows = -(-length // LANES)
        lanes = np.where(rows > 1, LANES, _pow2_at_least(length))
        dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
        classes = []
        for r, g in sorted(set(zip(rows.tolist(), lanes.tolist()))):
            ids = np.flatnonzero((rows == r) & (lanes == g))
            off = np.arange(r)[:, None] * LANES + np.arange(g)[None, :]
            at = start[ids, None, None] + off[None]
            idx = np.where(off[None] < length[ids, None, None], perm[np.minimum(at, perm.size - 1)],
                           -1)
            classes.append((r, g, dev(ids), dev(idx)))
        order = np.argsort(-pieces, kind="stable")
        n_active = np.searchsorted(-pieces[order], -np.arange(int(pieces.max(initial=0))),
                                   side="left").astype(np.int64)
        # the kernel's tables: the pieces of multi-piece segments, then the
        # pieces of more than SMALL members of the others
        i32 = lambda a: dev(np.asarray(a, np.int32))
        multi_seg = np.flatnonzero(pieces > 1)
        in_multi = pieces[owner] > 1
        mp = np.flatnonzero(in_multi)
        ms = np.searchsorted(multi_seg, owner[mp])
        lp = np.flatnonzero(~in_multi & (length > SMALL))
        items = np.r_[np.c_[start[mp], length[mp], np.arange(mp.size), ms],
                      np.c_[start[lp], length[lp], owner[lp], np.full(lp.size, -1)]]
        multi = np.c_[np.cumsum(pieces[multi_seg]) - pieces[multi_seg], pieces[multi_seg],
                      multi_seg]
        stats = {"segments": count, "members": int(perm.size), "pieces": n_pieces,
                 "largest": int(members.max(initial=0)), "warp_items": len(items),
                 "multi_segments": len(multi_seg), "seconds": time.perf_counter() - t0}
        zeros = lambda n, dtype: torch.zeros(max(n, 1), dtype=dtype, device=device)
        return cls(size=int(seg.size), num_segments=int(num_segments), count=count,
                   perm=i32(perm), n_pieces=n_pieces, seg_ptr=i32(seg_ptr),
                   items=i32(items.reshape(-1, 4)), multi=i32(multi.reshape(-1, 3)),
                   n_multi_items=int(mp.size), tickets=zeros(len(multi_seg), torch.int32),
                   partial=zeros(int(mp.size), torch.float64),
                   multi_totals=zeros(len(multi_seg), torch.float64),
                   segments=i32(seg), classes=tuple(classes),
                   by_pieces=dev(order), first_piece=dev(seg_piece[:-1][order]),
                   n_active=n_active, stats=stats)

    def own_scratch(self):
        """The same order with scratch of its own (zeroed tickets), on no
        stream yet: for calls that may run beside this order's, such as a
        captured graph's replays."""
        return dataclasses.replace(self, tickets=torch.zeros_like(self.tickets),
                                   partial=torch.zeros_like(self.partial),
                                   multi_totals=torch.zeros_like(self.multi_totals), stream={})


# ---------------------------------------------------------------------------
# the plain version


def _piece_sums(values, order):
    """Each piece's sum (n_pieces,), class by class: the lanes' strided
    serial sums from +0, then the tree over the class's lanes."""
    partial = values.new_zeros(order.n_pieces)
    zero = values.new_zeros(())
    for rows, lanes, ids, idx in order.classes:
        v = torch.where(idx >= 0, values[idx.clamp_min(0)], zero)      # (n, rows, lanes)
        acc = values.new_zeros(ids.numel(), lanes)
        for r in range(rows):
            acc = acc + v[:, r]
        # the tree: lanes [0, h) += lanes [h, 2h); the lanes from h on are
        # read no more
        h = lanes // 2
        while h >= 1:
            acc = acc[:, :h] + acc[:, h:2 * h]
            h //= 2
        partial[ids] = acc[:, 0]
    return partial


def segment_sum(values, order):
    """The plain version: the totals (count,) of `values` (size,) in the
    order `order` fixes."""
    partial = _piece_sums(values, order)
    totals = values.new_zeros(order.count)
    for j, n in enumerate(order.n_active.tolist()):
        seg = order.by_pieces[:n]
        totals[seg] = totals[seg] + partial[order.first_piece[:n] + j]
    return totals


# ---------------------------------------------------------------------------
# the kernel


class _SegmentArgs(ctypes.Structure):
    """Mirror of struct SegmentArgs in csrc/segment_sum.cu."""
    _fields_ = ([(k, ctypes.c_int) for k in ("n_items", "n_multi_items", "n_multi", "count",
                                             "spread")]
                + [(k, ctypes.c_void_p) for k in ("values", "perm", "seg_ptr", "items", "multi",
                                                  "tickets", "partial", "multi_totals", "totals",
                                                  "out")])


@functools.cache
def _library():
    from . import _build
    lib = _build.load("segment_sum")
    lib.segment_sum_launch.argtypes = [ctypes.POINTER(_SegmentArgs), ctypes.c_int,
                                       ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.segment_sum_launch.restype = ctypes.c_int
    lib.segment_sum_error_string.argtypes = [ctypes.c_int]
    lib.segment_sum_error_string.restype = ctypes.c_char_p
    return lib


def _claim_stream(order, stream, capturing=False):
    """Holds `order` to the stream (a handle) of its first call on the card:
    its scratch (tickets, partial, multi_totals) serves one call at a time,
    and two streams could run two calls at once. A call on another stream
    raises. A call made while `stream` is `capturing` a CUDA graph claims the
    order for that graph: a replay runs on the stream it is launched on,
    where an eager call could run beside it, so every later eager call
    raises, and a capture on another stream does (own_scratch gives each
    graph an order of its own)."""
    first = order.stream.setdefault("handle", stream)
    if first != stream:
        raise RuntimeError(f"this SegmentOrder's calls run on stream {first:#x}, not {stream:#x}: "
                           "its scratch serves one stream; build an order for each stream")
    if capturing:
        order.stream["graph"] = True
    elif order.stream.get("graph"):
        raise RuntimeError("this SegmentOrder was captured into a CUDA graph: its scratch serves "
                           "the graph's replays; call a SegmentOrder.own_scratch() copy eagerly")


def _launch(values, order, spread):
    """Pass 1 (the pieces' sums and the totals) and, for a spread over
    segments of several pieces, pass 2 on the current stream: one call of
    K7, its kernel launches in `segment_total.last_kernels`. Returns the
    totals, or the spread."""
    lib = _library()
    dev = values.device
    out = values.new_empty(order.size if spread else max(order.count, 1))
    ptr = lambda v: v.data_ptr()
    args = _SegmentArgs(n_items=order.items.shape[0], n_multi_items=order.n_multi_items,
                        n_multi=order.multi.shape[0], count=order.count, spread=int(spread),
                        values=ptr(values), totals=None if spread else ptr(out),
                        out=ptr(out) if spread else None,
                        **{k: ptr(getattr(order, k)) for k in ("perm", "seg_ptr", "items", "multi",
                                                               "tickets", "partial",
                                                               "multi_totals")})
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _claim_stream(order, stream, torch.cuda.is_current_stream_capturing())
        rc = lib.segment_sum_launch(ctypes.byref(args), int(values.dtype == torch.float64),
                                    ctypes.c_void_p(stream), ctypes.byref(launched))
    if rc != 0:
        raise RuntimeError("segment_sum launch failed: " + lib.segment_sum_error_string(rc).decode())
    segment_total.launches += 1
    segment_total.last_kernels = launched.value
    return out if spread else out[:order.count]


def _check(values, order):
    if values.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"values: dtype {values.dtype}")
    if values.dim() != 1 or values.shape[0] != order.size:
        raise ValueError(f"values: shape {tuple(values.shape)}, want ({order.size},)")
    if not values.is_contiguous():
        raise ValueError("values: not contiguous")
    if order.perm.device != values.device:
        raise ValueError(f"the order lies on {order.perm.device}, the values on {values.device}")


def _run(values, order, spread):
    _check(values, order)
    kind = values.device.type
    if kind == "cuda":
        return _launch(values, order, spread)
    if kind == "cpu":
        totals = segment_sum(values, order)
        return totals[order.segments.long()] if spread else totals
    raise RuntimeError(f"no segment sum kernel for device {kind!r}")


def segment_total(values, order):
    """The totals (count,) of `values` per segment, in the order `order`
    fixes: csrc/segment_sum.cu on a CUDA tensor, the plain version on a CPU
    tensor. On the card every call on one order runs on one stream, the
    first call's (the order's scratch serves one call at a time; another
    stream raises): an order for each stream, or for a captured graph's
    (own_scratch)."""
    return _run(values, order, False)


def segment_spread(values, order):
    """np.bincount(seg, w)[seg]: each member's segment total, in the fixed
    order; on the card on one stream per order, as segment_total. A rank's
    order of the multi-process step (parallel/shard_model.RankOrder) sums
    the gathered values in the one-process order and keeps its own part."""
    if not isinstance(order, SegmentOrder):
        return order.segment_spread(values)
    if order.count != order.num_segments:
        raise ValueError("segment_spread needs the totals of every segment")
    return _run(values, order, True)


def scatter_to_downstream(values, order):
    """np.bincount(down, w)[:P]: values moved to the downstream pixel, the
    order built over the P + 1 segments of a downstream array with P (the
    pits) left out (`SegmentOrder.build(down, P + 1, count=P)`); a rank's
    order as in segment_spread."""
    if not isinstance(order, SegmentOrder):
        return order.scatter_to_downstream(values)
    return _run(values, order, False)


segment_total.launches = 0
segment_total.last_kernels = 0

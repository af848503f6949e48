"""Host-built tables of the port's wavefront kernels (csrc/kinwave_substep.cu
and csrc/kinwave_sweep.cu): the upstream sources of every schedule position
in the order the kernels sum them, and the per-chunk lists of the flag
protocol through which their persistent blocks meet."""
from __future__ import annotations

import numpy as np

# feeder slots per lake or reservoir; chunk-size bound of a feeder entry's
# lane field
FEEDERS = 8
MAX_CHUNK = 512


def upstream_table(src_pos, tgt_pos, p_pad):
    """(K, p_pad) int32: the source positions of every target position, in
    ascending order, -1 where there are fewer than K. The kernels and their
    plain versions sum upstream inflow in this order."""
    src_pos = np.asarray(src_pos, np.int64)
    tgt_pos = np.asarray(tgt_pos, np.int64)
    if src_pos.size == 0:
        return np.full((1, p_pad), -1, np.int32)
    order = np.lexsort((src_pos, tgt_pos))
    s, t = src_pos[order], tgt_pos[order]
    first = np.r_[0, np.flatnonzero(np.diff(t)) + 1]
    counts = np.diff(np.r_[first, t.size])
    rank = np.arange(t.size) - np.repeat(first, counts)
    table = np.full((int(counts.max()), p_pad), -1, np.int32)
    table[rank, t] = s
    return table


WAVEFRONT_TABLES = ("wf_deps", "wf_own_ptr", "wf_own_list", "wf_feed_ptr", "wf_feed_ent",
                    "wf_sdep_ptr", "wf_sdep_list", "wf_fee_ord")


def _csr(n, keys, values):
    """(n + 1 offsets, values sorted by key) as int32, the list never empty."""
    keys = np.asarray(keys, np.int64)
    order = np.argsort(keys, kind="stable")
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=n), out=ptr[1:])
    vals = np.asarray(values, np.int64)[order]
    return ptr.astype(np.int32), (vals if vals.size else np.zeros(1, np.int64)).astype(np.int32)


def wavefront_tables(n_chunks, C, W, ups, ev_ups=None, lk_pos=None, lk_fee=None,
                     rs_pos=None, rs_fee=None):
    """The per-chunk tables of the kernel's dependency protocol, as int32
    NumPy arrays, from the upstream tables `ups` / `ev_ups` (K, p_pad) and the
    structures' positions (N,) and feeder positions (N, 8), -1 = none.
    Structures are numbered lakes first.

      wf_deps (n_chunks, D): the chunks that chunk c gathers from over the
          routing and the evaporation graph, ascending, -1 padded; all lie
          in c-W..c-1;
      wf_own_ptr, wf_own_list: per chunk (offsets into the list) the
          structures on its lanes;
      wf_feed_ptr, wf_feed_ent: per chunk its feeder entries, slot * 512 +
          lane with slot = structure * 8 + feeder;
      wf_sdep_ptr, wf_sdep_list: per chunk the feeder chunks of the structures
          it owns; all are earlier chunks;
      wf_fee_ord (N, 8): each structure's feeders ordered by (chunk, feeder),
          -1 padded: the order in which the owner sums them.

    Raises ValueError where a source lies outside the window or a feeder does
    not lie in an earlier chunk than its structure."""
    pairs = []
    for table in (ups, ev_ups):
        if table is None:
            continue
        table = np.asarray(table, np.int64)
        tgt = np.broadcast_to(np.arange(table.shape[1]) // C, table.shape)
        on = table >= 0
        pairs.append(np.unique(tgt[on] * n_chunks + table[on] // C))
    pairs = np.unique(np.concatenate(pairs)) if pairs else np.zeros(0, np.int64)
    tgt, src = pairs // n_chunks, pairs % n_chunks
    if ((src >= tgt) | (src < tgt - W)).any():
        raise ValueError("an upstream source lies outside the schedule window")
    first = np.searchsorted(tgt, tgt)
    deps = np.full((n_chunks, max(int((np.arange(tgt.size) - first).max(initial=0)) + 1, 1)),
                   -1, np.int32)
    deps[tgt, np.arange(tgt.size) - first] = src

    pos = np.concatenate([np.asarray(v, np.int64).reshape(-1)
                          for v in (lk_pos, rs_pos) if v is not None] or [np.zeros(0, np.int64)])
    fee = np.concatenate([np.asarray(v, np.int64).reshape(-1, FEEDERS)
                          for v in (lk_fee, rs_fee) if v is not None]
                         or [np.zeros((0, FEEDERS), np.int64)])
    sg, f = np.nonzero(fee >= 0)
    fp = fee[sg, f]
    if (fp // C >= pos[sg] // C).any():
        raise ValueError("a structure's feeder does not lie in an earlier chunk")
    out = {"wf_deps": deps}
    out["wf_own_ptr"], out["wf_own_list"] = _csr(n_chunks, pos // C, np.arange(pos.size))
    out["wf_feed_ptr"], out["wf_feed_ent"] = _csr(n_chunks, fp // C,
                                                  (sg * FEEDERS + f) * MAX_CHUNK + fp % C)
    sdep = np.unique((pos[sg] // C) * n_chunks + fp // C)
    out["wf_sdep_ptr"], out["wf_sdep_list"] = _csr(n_chunks, sdep // n_chunks, sdep % n_chunks)
    key = np.where(fee >= 0, (fee // C) * FEEDERS + np.arange(FEEDERS), np.iinfo(np.int64).max)
    order = np.argsort(key, axis=1, kind="stable")
    out["wf_fee_ord"] = np.where(np.take_along_axis(fee, order, 1) >= 0, order, -1).astype(np.int32)
    if not pos.size:
        out["wf_fee_ord"] = np.full((1, FEEDERS), -1, np.int32)
    return out

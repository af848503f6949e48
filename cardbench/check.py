"""How `correct` is decided: the program's states against the plain
reference's.

Each number against its limit (checks/<cell>.json); a number without a
limit there is read and printed, not held:
  - `start_gap`: the program's initial state against the reference's own,
    worked out from the inputs, the largest gap of any entry relative to
    the largest magnitude of its field (of its member);
  - `rerun_mismatch`: the state entries in which the window's last call,
    replayed day by day from the state it started from, ends other than
    the window's by a bit (limit 0): the replay is the window's own work;
  - for one day of that call drawn from the seed, the program's state after
    it against the reference's step from the program's state before it,
    each entry's gap relative to its field's largest magnitude, the largest
    over the fields and members of:
      `day_gap`, per field the QUANTILE-th quantile over its entries: what
      moves a thousandth of a field's pixels;
      `site_gap`, per field the largest over the sites (`sites`): the
      outlets, the lakes and reservoirs and the reaches below them, where a
      fault confined to a few pixels would sit; a field that is not one a
      pixel (a structure's, a scalar) counts whole;
      `day_max_gap`, per field the largest over every entry;
  - `nonfinite`: entries of the program's state after that day that are
    not finite (limit 0).
"""
from __future__ import annotations

import math

import numpy as np
import torch

QUANTILE = 0.999
# the gaps of a day, each member's worst over its fields
DAY_GAPS = ("day_gap", "site_gap", "day_max_gap")


def sites(model):
    """The sites of the reference's model (pixel indices): every outlet (a
    pit of the uncut channel graph), every lake and reservoir, and each
    reach from a structure down to its outlet."""
    down = np.asarray(model["down_order"], np.int64)
    out = set(np.flatnonzero(down < 0).tolist())
    walked = set()
    for key in ("LakeIndex", "ReservoirIndex"):
        for i in np.asarray(model["params"].get(key, ()), np.int64).reshape(-1).tolist():
            while i >= 0 and i not in walked:
                walked.add(i)
                i = int(down[i])
    return np.array(sorted(out | walked), np.int64)


def _pairs(prog_states, ref_states, device):
    """(member, field, program's values, reference's) as float64 tensors of
    the field's shape."""
    for m, (ps, rs) in enumerate(zip(prog_states, ref_states)):
        for k, v in ps.items():
            v = np.asarray(v)
            if v.dtype.kind != "f" or k not in rs:
                continue
            yield (m, k, torch.as_tensor(v, device=device).to(torch.float64),
                   torch.as_tensor(np.asarray(rs[k]), device=device).to(torch.float64)
                   .reshape(v.shape))


def _relative(v, r):
    """Each entry's gap relative to the field's largest magnitude, flat."""
    scale = max(float(r.abs().max()), 1e-30)
    gap = ((v - r).abs() / scale).reshape(-1)
    return torch.where(torch.isfinite(gap), gap, math.inf)


def start_gap(prog_states, ref_states, device="cpu"):
    """(largest relative gap, its field) of the initial states."""
    worst = (0.0, "")
    for m, k, v, r in _pairs(prog_states, ref_states, device):
        if r.numel():
            worst = max(worst, (float(_relative(v, r).max()), f"{k}[{m}]"))
    return worst


def member_day_gaps(prog_states, ref_states, pixels=None, site_index=None, quantile=QUANTILE,
                    device="cpu"):
    """Each member's {number: (largest over its fields, that field)} of
    DAY_GAPS. `pixels` is the model's pixel count and `site_index` its
    sites; without them `site_gap` reads every entry."""
    worst = [{n: (0.0, "") for n in DAY_GAPS} for _ in prog_states]
    at = None if site_index is None else torch.as_tensor(site_index, device=device)
    for m, k, v, r in _pairs(prog_states, ref_states, device):
        if not r.numel():
            continue
        gap = _relative(v, r)
        rank = int(math.ceil(quantile * (gap.numel() - 1)))
        site = gap
        if at is not None and v.ndim and v.shape[-1] == pixels:
            site = gap.reshape(-1, pixels)[:, at]
        reading = {"day_gap": float(torch.kthvalue(gap, rank + 1).values),
                   "site_gap": float(site.max()), "day_max_gap": float(gap.max())}
        for n, g in reading.items():
            worst[m][n] = max(worst[m][n], (g, f"{k}[{m}]"))
    return worst


def day_gaps(prog_states, ref_states, pixels=None, site_index=None, device="cpu"):
    """{number: (largest over fields and members, its field)} of DAY_GAPS."""
    gaps = member_day_gaps(prog_states, ref_states, pixels, site_index, device=device)
    return {n: max(g[n] for g in gaps) for n in DAY_GAPS}


def nonfinite(prog_states):
    """Entries of the program's states that are not finite."""
    return int(sum(np.count_nonzero(~np.isfinite(np.asarray(v)))
                   for s in prog_states for v in s.values() if np.asarray(v).dtype.kind == "f"))


def verdict(numbers, limits):
    """`correct` and the lines of each number beside its limit."""
    ok = all(numbers[k] <= limits[k] for k in limits)
    return ok, {k: {"value": numbers[k], "limit": limits[k]} for k in limits}

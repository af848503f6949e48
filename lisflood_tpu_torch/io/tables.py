"""Lookup tables (PCRaster `lookupscalar` on text tables).

The reference uses PCRaster lookupscalar for lake / reservoir parameter
tables (reservoir.py:95-128, lakes.py:99-115): a text file with lines
"<class id> <value>" mapped over a nominal sites map. Interval-keyed tables
("[a,b> value") also exist in the test data but are not used by the model
code, so only exact-id lookup is implemented.

The port's copy of lisflood_tpu/io/tables.py.
"""
from __future__ import annotations

import numpy as np

from ..utils.errors import LisfloodError


def read_lookup_table(path):
    """Parse "<id> <value>" lines -> dict."""
    table = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2 or parts[0].startswith("#") or not parts[0][0].isdigit():
                continue
            table[int(float(parts[0]))] = float(parts[1])
    return table


def lookup_scalar(path, ids, default=np.nan):
    """Map each element of `ids` (int array; 0 = no site) through the table;
    non-site cells get `default` (PCRaster returns MV there)."""
    table = read_lookup_table(path)
    ids = np.asarray(ids)
    out = np.full(ids.shape, default, dtype=np.float64)
    for key, val in table.items():
        out[ids == key] = val
    missing = set(np.unique(ids[ids > 0]).tolist()) - set(table.keys())
    if missing:
        raise LisfloodError(f"Ids {sorted(missing)} not found in table {path}")
    return out

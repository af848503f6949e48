"""Water-use post-processing on tensors — the port of the part of
lisflood_tpu/ops/indicators.py that the water-abstraction step calls."""
from __future__ import annotations

import torch


def _window_total(a, k):
    """Sum over the k x k window around every cell of the 2-D grid `a`, zeros
    beyond the edge: a summed-area table (two cumulative sums)."""
    half = k // 2
    pad = torch.nn.functional.pad(a, (half, k - half, half, k - half))
    sat = torch.nn.functional.pad(pad.cumsum(0).cumsum(1), (1, 0, 1, 0))
    total = sat[k:, k:] - sat[:-k, k:] - sat[k:, :-k] + sat[:-k, :-k]
    return total[:a.shape[0], :a.shape[1]]


def groundwater_smooth(cfg, p, lz, land_rows, land_cols, nrows, ncols):
    """LZ smoothing by a window average over groundwater bodies
    (waterabstraction.py:602-628).

    land_rows / land_cols are the pixels' 2-D coordinates. A whole-cell
    window matches PCRaster's area-weighted windowtotal exactly for an odd
    LZSmoothRange (the shipped settings use 5) and approximates even ones."""
    k = int(p["LZSmoothRangeCells"])
    is_gw = p["GroundwaterBodies"] > 0
    grid_lz = lz.new_zeros(nrows, ncols)
    grid_lz[land_rows, land_cols] = torch.where(is_gw, lz, 0.0)
    grid_cnt = lz.new_zeros(nrows, ncols)
    grid_cnt[land_rows, land_cols] = is_gw.to(lz.dtype)
    tot = _window_total(grid_lz, k)[land_rows, land_cols]
    cnt = _window_total(grid_cnt, k)[land_rows, land_cols]
    smooth = torch.where(cnt == 0, 0.0, tot / torch.where(cnt == 0, 1.0, cnt))
    lz_new = torch.where(is_gw, 0.9 * lz + 0.1 * smooth, lz)
    # average-error correction: one mean of (smooth - LZ) over all cells of
    # GroundwaterCatch, subtracted there (waterabstraction.py:145-146)
    in_area = p["GroundwaterCatch"] != 0
    diff_sum = torch.where(in_area, smooth - lz, 0.0).sum()
    n_area = in_area.to(lz.dtype).sum()
    corr = 0.1 * torch.where(n_area > 0, diff_sum / torch.where(n_area > 0, n_area, 1.0), 0.0)
    return torch.where(in_area, lz_new - corr, lz_new)

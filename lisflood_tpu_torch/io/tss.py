"""PCRaster time-series (.tss) files: reader and writer.

Format (reference zusatz.py:196-400): a header line, the column count
(gauges + 1), the literal "timestep", one line per gauge id, then one row
per step with " %8g" step number and " %14g" values (1e31 = missing).

The port's copy of lisflood_tpu/io/tss.py.
"""
from __future__ import annotations

import time as _time

import numpy as np


def read_tss(path):
    """Read a .tss file -> (ids list, data array (steps, ncols), step numbers)."""
    with open(path) as f:
        lines = f.readlines()
    # header: line0 = description, line1 = ncols, line2 = 'timestep', then ids
    ncols = int(lines[1])
    ids = [int(float(lines[3 + i])) for i in range(ncols - 1)]
    rows = []
    steps = []
    for line in lines[2 + ncols :]:
        parts = line.split()
        if not parts:
            continue
        steps.append(int(float(parts[0])))
        rows.append([float(p) for p in parts[1:]])
    return ids, np.array(rows), np.array(steps)


def read_tss_header(path):
    """Gauge/outlet ids declared in the header (reference inflow.py:73)."""
    return read_tss(path)[0]


class TssWriter:
    """Progressive .tss writer: the file on disk is kept current as rows
    arrive (the reference rewrites the file from its in-memory buffer
    every reporting step, zusatz.py:196-400), so a crash at step N loses
    at most the rows of one flush interval instead of the whole run.

    Rows normally arrive with increasing step numbers and are APPENDED
    incrementally (re-flushing every `flush_every` samples and at
    close-time `flush()`); an out-of-order or overwritten step falls back
    to a full rewrite, preserving exact reference file layout.

    Memory is bounded: rows already on disk are dropped from the buffer
    after each flush (a 32-year sub-daily run would otherwise retain
    every row forever); the rewrite fallback reconstructs the dropped
    rows from the file itself before rewriting."""

    def __init__(self, path, ids, settings_path="", first_step=1, write_header=True,
                 flush_every=16):
        self.path = str(path)
        if not self.path.endswith(".tss"):
            self.path += ".tss"
        self.ids = list(ids)
        self.settings_path = settings_path
        self.first_step = first_step
        self.write_header = write_header
        self.flush_every = int(flush_every)
        self.rows = {}
        self._written_through = None   # highest step already on disk
        self._header_done = False
        self._pending = 0

    def sample(self, step, values):
        step = int(step)
        if self._written_through is not None and step <= self._written_through:
            # rewrite path: a step already on disk changed — recover the
            # rows this buffer already dropped from the file itself
            self._reload_from_disk()
            self._written_through = None
            self._header_done = False
        self.rows[step] = np.atleast_1d(np.asarray(values, dtype=np.float64))
        self._pending += 1
        if self._pending >= self.flush_every:
            self.flush()

    def _reload_from_disk(self):
        try:
            _, data, steps = read_tss(self.path)
        except (OSError, ValueError, IndexError):
            return
        for st, row in zip(steps, np.atleast_2d(data)):
            if int(st) not in self.rows:
                row = np.asarray(row, np.float64)
                self.rows[int(st)] = np.where(row >= 1e30, np.nan, row)

    def _format_row(self, step):
        row = " %8g" % step
        for v in self.rows[step]:
            row += "           1e31" if np.isnan(v) else " %14g" % v
        return row + "\n"

    def _write_header(self, f):
        if self.write_header:
            f.write(
                "timeseries scalar settingsfile: {} date: {}\n".format(
                    self.settings_path, _time.ctime()))
            f.write(f"{len(self.ids) + 1}\n")
            f.write("timestep\n")
            for gid in self.ids:
                f.write(f"{gid}\n")

    def flush(self):
        self._pending = 0
        steps = sorted(self.rows)
        if self._written_through is None or not self._header_done:
            with open(self.path, "w") as f:
                self._write_header(f)
                for step in steps:
                    f.write(self._format_row(step))
        else:
            new = [s for s in steps if s > self._written_through]
            if not new:
                return
            with open(self.path, "a") as f:
                for step in new:
                    f.write(self._format_row(step))
        self._header_done = True
        self._written_through = steps[-1] if steps else self._written_through
        # bound the buffer: everything flushed is recoverable from disk
        if self._written_through is not None:
            for s in steps:
                if s <= self._written_through:
                    del self.rows[s]

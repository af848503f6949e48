"""What the per-layer readers read: a profiled stretch of the window.

`Trace` holds the device's activities (kernels, copies and sets) of the
stretch from torch.profiler, the days and the seconds of its own timeline it spans, the least
device time a day of each kernel's function (roofline.day_bounds) and the
operations of a day's step (roofline.step_flops). The program's own CUDA
kernels are known by the names of their entry points (lisflood_tpu_torch/
csrc/*.cu).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

from .roofline import PEAK_FLOPS

# the program's kernels: the wrapper's name -> the kernel functions it launches
KERNELS = {"kinwave_substep": ("substep_kernel",), "kinwave_sweep": ("sweep_kernel",),
           "kinwave_sharded": ("sharded_kernel",), "segment_sum": ("piece_kernel", "spread_kernel"),
           "soil_tail": ("soil_tail_kernel",)}
_PATTERN = {k: re.compile(r"\b(" + "|".join(v) + r")\b") for k, v in KERNELS.items()}


def kernel_of(name):
    """The program's kernel an activity belongs to, or None."""
    for k, pat in _PATTERN.items():
        if pat.search(name):
            return k
    return None


@dataclass
class Trace:
    activities: list            # (name, start_us, end_us) on the device
    days: int                   # daily steps in the stretch
    window_s: float             # seconds of the stretch on its own timeline: the first
                                # device activity's start to the last one's end
    bounds: dict = field(default_factory=dict)     # kernel -> (ms a day, bound by)
    step_flops: float = None    # operations of a day's step
    peak_flops: float = PEAK_FLOPS

    def busy_s(self):
        """Seconds in which some activity ran: the union of the intervals."""
        total, end = 0.0, None
        for a, b in sorted((s, e) for _, s, e in self.activities):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total * 1e-6

    def ms_a_day(self, kernel):
        """Device ms a day of the program's kernel, None where it never ran."""
        us = [e - s for n, s, e in self.activities if kernel_of(n) == kernel]
        return sum(us) * 1e-3 / self.days if us else None

    def other_ms_a_day(self):
        """Device ms a day of every activity that is none of the program's
        kernels."""
        us = [e - s for n, s, e in self.activities if kernel_of(n) is None]
        return sum(us) * 1e-3 / self.days if us else None

    def roofline_pct(self, kernel):
        ms = self.ms_a_day(kernel)
        if ms is None or kernel not in self.bounds:
            return None
        return 100.0 * self.bounds[kernel][0] / ms

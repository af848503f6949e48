"""device_idle_pct: The share of the traced stretch, from its first device
activity's start to its last one's end on the profiler's timeline, in which
no kernel, copy or set ran on the device."""
UNIT = "%"
LAYER = "device"
MOVES = "cell_steps_per_s"


def read(t):
    return 100.0 * (1.0 - t.busy_s() / t.window_s) if t.activities else None

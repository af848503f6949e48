"""kinwave_sharded_roofline: The day's sweeps' least time
(roofline.sweep, summed) over the kernel's device time."""
UNIT = "%"
LAYER = "sharded and scan sweep, K6"
MOVES = "cell_steps_per_s"


def read(t):
    return t.roofline_pct("kinwave_sharded")

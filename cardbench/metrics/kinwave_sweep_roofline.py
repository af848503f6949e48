"""kinwave_sweep_roofline: The overland sweep's least time
(roofline.sweep) over the kernel's device time."""
UNIT = "%"
LAYER = "overland sweep, K5"
MOVES = "cell_steps_per_s"


def read(t):
    return t.roofline_pct("kinwave_sweep")

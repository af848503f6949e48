"""kinwave_substep_roofline: The sub-step loop's least time
(roofline.substep_loop) over the kernel's device time."""
UNIT = "%"
LAYER = "channel routing, sub-step kernel"
MOVES = "cell_steps_per_s"


def read(t):
    return t.roofline_pct("kinwave_substep")

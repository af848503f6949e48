"""step_mfu: The whole step's operations (roofline.step_flops, counted on the
reference's day, its solves at their least) a second of the traced stretch
on its own timeline, over the card's float32 peak."""
UNIT = "%"
LAYER = "device"
MOVES = "cell_steps_per_s"


def read(t):
    return None if not t.step_flops else 100.0 * t.step_flops * t.days / t.window_s / t.peak_flops

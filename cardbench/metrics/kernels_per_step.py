"""kernels_per_step: Device kernels, copies and sets a daily step in the
traced stretch."""
UNIT = "count"
LAYER = "entry and graph"
MOVES = "cell_steps_per_s"


def read(t):
    return len(t.activities) / t.days if t.activities else None

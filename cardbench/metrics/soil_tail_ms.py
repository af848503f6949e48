"""soil_tail_ms: Device ms a daily step of the soil tail kernel."""
UNIT = "ms"
LAYER = "soil Courant tail, K8"
MOVES = "cell_steps_per_s"


def read(t):
    return t.ms_a_day("soil_tail")

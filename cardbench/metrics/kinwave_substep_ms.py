"""kinwave_substep_ms: Device ms a daily step of the channel sub-step kernel."""
UNIT = "ms"
LAYER = "channel routing, sub-step kernel"
MOVES = "cell_steps_per_s"


def read(t):
    return t.ms_a_day("kinwave_substep")

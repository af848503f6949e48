"""kinwave_sweep_ms: Device ms a daily step of the overland sweep kernel."""
UNIT = "ms"
LAYER = "overland sweep, K5"
MOVES = "cell_steps_per_s"


def read(t):
    return t.ms_a_day("kinwave_sweep")

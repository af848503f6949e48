"""kinwave_sharded_ms: Device ms a daily step of the natural sweep kernel,
its channel and overland launches summed."""
UNIT = "ms"
LAYER = "sharded and scan sweep, K6"
MOVES = "cell_steps_per_s"


def read(t):
    return t.ms_a_day("kinwave_sharded")

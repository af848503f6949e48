"""torch_kernels_ms: Device ms a daily step of every activity that is none of
the program's five CUDA kernels."""
UNIT = "ms"
LAYER = "land phase and post-routing"
MOVES = "cell_steps_per_s"


def read(t):
    return t.other_ms_a_day()

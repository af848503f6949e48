"""segment_sum_ms: Device ms a daily step of the segment-sum kernels."""
UNIT = "ms"
LAYER = "segment sums, K7"
MOVES = "cell_steps_per_s"


def read(t):
    return t.ms_a_day("segment_sum")

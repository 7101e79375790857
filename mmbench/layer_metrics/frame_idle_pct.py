"""The card's idle share of the traced window of a frame cell."""

UNIT = "%"
LAYER = "device"
MOVES = "frame_ms"


def read(workload, trace):
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

"""The card's idle share of the traced window of a generation cell."""

UNIT = "%"
LAYER = "device"
MOVES = "gen_chunks_per_s"


def read(workload, trace):
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

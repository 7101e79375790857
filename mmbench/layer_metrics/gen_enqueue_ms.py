"""The host time of one ``generate_area_fused`` call (which only enqueues the area's
launches), the mean over the traced window's calls."""

UNIT = "ms"
LAYER = "generation entry"
MOVES = "gen_chunks_per_s"


def read(workload, trace):
    return workload.spans.mean_ms("generate")

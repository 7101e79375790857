"""K7's (feature application: its cull and its column pass) share of its roofline, on the
first areas completed in the traced window: their need over their launches' device time."""

UNIT = "%"
LAYER = "feature kernels"
MOVES = "gen_chunks_per_s"


def read(workload, trace):
    return workload.roofline("k7", trace)

"""K3's (caves: the carve test and the column pass) share of its roofline, on the first
areas completed in the traced window: their need over their launches' device time."""

UNIT = "%"
LAYER = "terrain kernels"
MOVES = "gen_chunks_per_s"


def read(workload, trace):
    return workload.roofline("k3", trace)

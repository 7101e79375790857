"""K11's (the 1-spp path-traced sample) share of its roofline on the checked frame: the need
of that frame's rays, counted by the plain reference tracer, over the device time of its
seven launches."""

UNIT = "%"
LAYER = "path tracer"
MOVES = "frame_ms"


def read(workload, trace):
    return workload.k11_roofline(trace)

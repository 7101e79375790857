"""The host time of ``Engine.present`` (the denoise, the upscale, the present and the
frame's copy to the host, which waits for the frame's work), a frame's mean."""

UNIT = "ms"
LAYER = "frame post"
MOVES = "frame_ms"


def read(workload, trace):
    return workload.spans.mean_ms("present")

"""The host time of ``Engine.tick`` (the scheduler's host work, the scene updates' and the
sample's launches; it does not wait for the card), a frame's mean."""

UNIT = "ms"
LAYER = "engine"
MOVES = "frame_ms"


def read(workload, trace):
    return workload.spans.mean_ms("tick")

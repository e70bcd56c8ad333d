"""The 90th percentile (nearest rank) of the latency of every frame answered
inside the window: from the camera's handover to the engine step that
returned the frame's last token, by the harness's clock."""
import math


def read(run):
    if not run.frames:
        return None
    lat = sorted(t1 - t0 for t0, t1, *_ in run.frames)
    return lat[math.ceil(0.9 * len(lat)) - 1]

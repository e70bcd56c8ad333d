"""Frames answered inside the window (every answer token out) over the
window's seconds, by the harness's clock."""


def read(run):
    if not run.frames or run.window_s <= 0:
        return None
    return len(run.frames) / run.window_s

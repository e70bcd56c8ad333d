"""Tokens of every optimizer step completed inside the window over the
window's seconds, by the harness's clock; the window ends on the
synchronise of its last step's loss and gradient norm."""


def read(run):
    if not run.steps or run.window_s <= 0:
        return None
    return sum(run.steps) / run.window_s

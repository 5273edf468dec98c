"""Queries answered in the window over the window's seconds: every call
that started in it, from the first call's send to the last call's answer."""


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    return sum(c.n for c in run.calls if c.ok) / run.window_s

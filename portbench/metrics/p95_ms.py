"""95th percentile, by nearest rank over every call of the window, of a
call's latency: the client's host clock from send to results in hand."""

import math


def nearest_rank(xs, p: float) -> float:
    """``xs[ceil(p N) - 1]`` of the sorted values (copied from the
    program's ``serve/queue.py``)."""
    xs = sorted(xs)
    return float(xs[min(len(xs), max(1, math.ceil(p * len(xs)))) - 1])


def read(run):
    lat = [c.seconds for c in run.calls if c.ok]
    return nearest_rank(lat, 0.95) * 1e3 if lat else None

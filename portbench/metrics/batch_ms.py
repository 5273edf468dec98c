"""Median of the client's host-clock milliseconds per ``search`` call."""

import statistics


def read(run):
    lat = [c.seconds for c in run.calls if c.ok]
    return statistics.median(lat) * 1e3 if lat else None

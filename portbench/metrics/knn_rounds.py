"""Mean over the window's calls of the kNN engine's ``rounds``."""


def read(run):
    vals = [c.stats["rounds"] for c in run.calls if c.ok and c.stats and "rounds" in c.stats]
    return sum(vals) / len(vals) if vals else None

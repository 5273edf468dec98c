"""Mean over the window's calls of the engine's ``dists_per_query``, the
paper's figure of merit (pivot and exact distances a query)."""


def read(run):
    vals = [c.stats["dists_per_query"] for c in run.calls
            if c.ok and c.stats and "dists_per_query" in c.stats]
    return sum(vals) / len(vals) if vals else None

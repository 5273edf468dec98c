"""The least time the card needs for the distances the engine reports
(``portbench/work.py``), summed over the traced window's calls, as a share
of the device's busy time in that window (all its operations)."""

from portbench.work import least_seconds


def read(run):
    if not run.trace or run.trace.get("busy_s", 0) <= 0:
        return None
    total = 0.0
    for c in run.calls:
        if not c.ok or not c.stats or "dists_per_query" not in c.stats:
            continue
        least = least_seconds(run.metric, c.stats["dists_per_query"], c.n, run.n_rows,
                              run.dim, c.out_items, run.card, run.traffic["kind"])
        if least is None:
            return None
        total += least
    return 100.0 * total / run.trace["busy_s"]

"""Mean per call of the self time of the engine's host-only spans
(``bss.range.assemble`` and ``.stats``; ``bss.knn.sort`` and
``.schedule``), in ms: host work that starts once the card's results are
in hand, so the card idles under it."""

from portbench.metrics.search_ms import calls

HOST_ONLY = ("bss.range.assemble", "bss.range.stats", "bss.knn.sort", "bss.knn.schedule")


def read(run):
    found = calls(run)
    if found is None:
        return None
    roots, recs = found
    return sum(r.self_s for r in recs if r.name in HOST_ONLY) * 1e3 / len(roots)

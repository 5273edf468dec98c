"""Mean device ms of the kNN rounds' top-k: the ``bss.knn.top_k`` spans'
CUDA event pairs (one span a round).  Where no card ran the work the spans
have no device ms, and nothing is read."""

from portbench.metrics.search_ms import calls


def read(run):
    found = calls(run)
    if found is None:
        return None
    ms = [r.device_ms for r in found[1] if r.name == "bss.knn.top_k" and r.device_ms is not None]
    return sum(ms) / len(ms) if ms else None

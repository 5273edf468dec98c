"""Mean per call of the engine's reads of a device tensor to the host
(``repro_torch.obs.record.to_host``), the count on each call's root span."""

from portbench.metrics.search_ms import calls


def read(run):
    found = calls(run)
    if found is None:
        return None
    roots = found[0]
    return sum(r.reads for r in roots) / len(roots)

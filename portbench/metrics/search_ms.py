"""Median over the traced window's calls of the program's own root span
``retrieval.search`` (``repro_torch.obs.record``), in ms: the inside twin
of ``batch_ms``.  Also the ring's reading that the other program-span
readers share (``calls``)."""

import statistics

ROOT = "retrieval.search"


def calls(run):
    """(the ``ROOT`` records of the window's calls, every record of those
    calls), or None where the program records no spans (it has no
    ``repro_torch.obs.record``) or the ring holds no root in the window
    (the control, an untraced run).  The ring and the harness share a
    clock (``time.perf_counter``)."""
    try:
        from repro_torch.obs import record
    except ImportError:
        return None
    if not run.calls:
        return None
    lo, hi = run.calls[0].t_send, run.calls[-1].t_done
    recs = record.spans()
    roots = [r for r in recs if r.name == ROOT and r.parent is None and lo <= r.t0 <= hi]
    if not roots:
        return None
    ids = {r.call for r in roots}
    return roots, [r for r in recs if r.call in ids]


def read(run):
    found = calls(run)
    if found is None:
        return None
    return statistics.median((r.t1 - r.t0) * 1e3 for r in found[0])

"""Mean device ms a call of the range exact phase: the ``bss.range.exact``
spans that carry a CUDA event pair (the fused pass's masked distance tile
over the surviving tiles; the epilogue's own ``bss.range.exact`` span
carries none).  A pair times the stream from its start event to its end
event, so the reading holds the phase's kernels and any wait in between
for the host to launch the next of them.  Where no card ran the work the
spans have no device ms, and nothing is read."""

from portbench.metrics.search_ms import calls

SPAN = "bss.range.exact"


def read(run):
    """The spans' device ms summed per call, averaged over the calls that
    hold one; None where none does."""
    found = calls(run)
    if found is None:
        return None
    per_call: dict = {}
    for r in found[1]:
        if r.name == SPAN and r.device_ms is not None:
            per_call[r.call] = per_call.get(r.call, 0.0) + r.device_ms
    return sum(per_call.values()) / len(per_call) if per_call else None

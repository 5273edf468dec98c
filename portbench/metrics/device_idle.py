"""Share of the traced window in which no operation ran on the device:
1 - busy / window, from the profiler's device events."""


def read(run):
    if not run.trace or run.trace.get("busy_s", 0) <= 0 or run.trace["window_s"] <= 0:
        return None  # no device operation in the trace: nothing to read
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])

"""One reader per metric, ``metrics/<metric name>.py``, found by the name
``BENCHMARK.json`` gives the metric.  A reader's ``read(run)`` takes the
run's record (``portbench.harness.RunRecord``) and returns the metric's
value, or None where the run holds nothing to read: the harness then
leaves the metric out of the result."""

# Copy of src/repro/obs/buckets.py, kept so the port imports nothing of the JAX
# package; tests/test_torch_copies.py pins it to the original.
"""Bucket ladders for cumulative-bucket histograms.

A histogram's Prometheus exposition is only as useful as its bucket
boundaries: a scrape-side ``histogram_quantile`` interpolates inside the
bucket an observation landed in, so the ladder has to straddle the
metric's dynamic range.  Latencies span microseconds to seconds and
distance counts span 1 to millions, so the *default* ladder is
log-spaced; metrics with a known, narrower range (batch sizes, kNN round
counts) override it with a hand-picked ladder in :data:`LADDERS`.

Everything here is host-side and numpy-free — ladders are plain tuples of
floats consumed by :class:`repro_torch.obs.registry.Histogram`, which keeps one
cumulative count per boundary (plus the implicit ``+Inf`` overflow) and
exposes them as ``_bucket{le="..."}`` series.
"""

from __future__ import annotations

import math

__all__ = ["DEFAULT_LADDER", "LADDERS", "ladder_for", "log_ladder",
           "validate_ladder"]


def log_ladder(lo: float, hi: float, per_decade: int = 1) -> tuple:
    """Log-spaced bucket boundaries from ``lo`` to ``hi`` inclusive, with
    ``per_decade`` boundaries per factor of 10.  Boundaries are rounded to
    9 significant digits so the exposition's ``le`` strings round-trip
    exactly through ``float()``."""
    if not (lo > 0 and hi > lo):
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    if per_decade < 1:
        raise ValueError(f"per_decade must be >= 1, got {per_decade}")
    lo_e = round(math.log10(lo) * per_decade)
    hi_e = round(math.log10(hi) * per_decade)
    out = tuple(
        float(f"{10 ** (e / per_decade):.9g}") for e in range(lo_e, hi_e + 1)
    )
    return validate_ladder(out)


def validate_ladder(bounds) -> tuple:
    """Check a ladder is a strictly-increasing tuple of finite floats and
    return it as such (raises ``ValueError`` otherwise)."""
    out = tuple(float(b) for b in bounds)
    if not out:
        raise ValueError("ladder must have at least one boundary")
    for b in out:
        if not math.isfinite(b):
            raise ValueError(f"non-finite boundary {b} (+Inf is implicit)")
    if any(a >= b for a, b in zip(out, out[1:])):
        raise ValueError(f"boundaries must strictly increase, got {out}")
    return out


# seconds: 10us .. 10s, 2 boundaries/decade — host-side serving latencies
_SECONDS = log_ladder(1e-5, 10.0, 2)
# counts: 1 .. 1e6, 1 boundary/decade with a 3x midpoint — distance tallies
_COUNTS = validate_ladder(
    [b for e in range(0, 7) for b in (10.0 ** e, 3.0 * 10.0 ** e)][:-1]
)

DEFAULT_LADDER = log_ladder(1e-6, 1e3, 1)

# per-metric overrides; anything not listed gets DEFAULT_LADDER.  Keys are
# repo-side metric names (slash-namespaced, pre-`prom_name`).
LADDERS: dict = {
    "serve/span_s": _SECONDS,
    "serve/engine_s": _SECONDS,
    "serve/call_s": _SECONDS,
    "index/mutation_s": _SECONDS,
    "serve/batch_size": tuple(float(2 ** e) for e in range(0, 9)),
    "engine/dists_per_query": _COUNTS,
    "engine/knn_rounds": tuple(float(r) for r in (1, 2, 3, 4, 6, 8, 12, 16)),
}


def ladder_for(name: str) -> tuple:
    """Bucket boundaries for a metric name: its :data:`LADDERS` override,
    else :data:`DEFAULT_LADDER`."""
    return LADDERS.get(name, DEFAULT_LADDER)

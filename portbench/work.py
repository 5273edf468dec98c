"""The least time the card needs for the distances a call computed: the
larger of its operations at the card's rate and its bytes once at the HBM
rate (the roofline model).

* Operations: the engine's ``dists_per_query`` times the call's queries
  times ``d`` terms: 2 float32 operations a term for l2 and cosine (at the
  float32 peak), one special-function result a term for the probability
  metrics (a logarithm for JSD; a division for Triangular), at the SFU rate.
* Bytes: the corpus and the queries read once, the answer written once
  (kNN: an 8-byte id and a 4-byte distance a neighbour; range: an 8-byte id
  a hit).
"""

from __future__ import annotations

SFU_METRICS = ("jsd", "triangular")


def least_seconds(metric: str, dists: float, n_queries: int, n_rows: int, dim: int,
                  out_items: int, card: dict, kind: str) -> float | None:
    """None where the card's rate for the metric is not known."""
    if metric in SFU_METRICS:
        rate, ops = card.get("sfu_per_s"), dists * n_queries * dim
    else:
        rate, ops = card.get("fp32_flops"), 2.0 * dists * n_queries * dim
    hbm = card.get("hbm_bytes_per_s")
    if not rate or not hbm:
        return None
    n_bytes = 4 * dim * (n_rows + n_queries) + (12 if kind == "knn" else 8) * out_items
    return max(ops / rate, n_bytes / hbm)

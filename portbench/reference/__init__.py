"""The plain reference: one module per metric, found by the metric's name.

Each module gives ``prepare(x)``, the rows in the form the next two take
(cosine: scaled to unit length); ``pairwise(q, x)`` (float64 ``(nq, d)``,
``(n, d)`` -> ``(nq, n)``); ``paired(q, x)`` (``(a, d)``, ``(a, k, d)`` ->
``(a, k)``); ``pair_bytes(d)``, the bytes ``pairwise`` holds per pair; and
``control(q, x, precision)``, the distances of the raw rows computed in a
lower precision than the configuration states.  The modules import torch and
nothing of the program: they compute each metric from its definition.
"""

"""Device forest of the port: array-encoded batched walks for every
hyperplane partition tree in the repo (paper §4's 12 variants and §5's
monotone / LRT family), on the H100's masked tile kernels.

``encode`` flattens a built host tree into structure-of-arrays level
tables; ``walk`` runs the batched frontier-per-level range search, whose
result sets and per-query distance counts equal the numpy walks of
``core/tree.py`` / ``core/lrt.py``.
"""

from repro_torch.forest.encode import (
    EncodedForest,
    EncodedMonotone,
    encode_monotone,
    encode_tree,
)
from repro_torch.forest.walk import forest_range_search, monotone_range_search

__all__ = [
    "EncodedForest",
    "EncodedMonotone",
    "encode_tree",
    "encode_monotone",
    "forest_range_search",
    "monotone_range_search",
]

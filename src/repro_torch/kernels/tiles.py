# Copy of src/repro/kernels/tiles.py, kept so the port imports nothing of the JAX
# package; tests/test_torch_copies.py pins it to the original.
"""Tile-size knobs for the masked Pallas kernel family.

The fused engines tile their work as (query-tile x corpus-block) cells with
a K-lane chunk bounding the VPU broadcast transient.  The defaults
(128 / 128 / 64) match the MXU systolic array and the BSS block size, but
real-TPU autotuning (see ROADMAP "Pallas masked-kernel autotuning") needs a
way to try other shapes WITHOUT a rebuild — so each constant reads an
environment variable at import time:

    REPRO_TILE_BQ      query-tile rows   (kernel bm / bq)      default 128
    REPRO_TILE_BLOCK   corpus-block cols (kernel bn / bb)      default 128
    REPRO_TILE_KCHUNK  K lanes reduced per VPU pass            default 64
    REPRO_TILE_VPU     standalone VPU-kernel tile (bm = bn)    default 64

This module is import-light on purpose (no jax): it must be readable by
tooling/subprocesses without paying the jax import.  Consumers:
``kernels/pairwise_dist.py`` (bm/bn), ``kernels/planar_exclusion.py``
(bq/bb), ``kernels/jsd_dist.py`` / ``kernels/tri_dist.py`` (K-chunk),
``core/flat_index.py`` and ``forest/walk.py`` (query-tile default).
"""

from __future__ import annotations

import os

__all__ = ["TILE_BQ", "TILE_BLOCK", "TILE_KCHUNK", "TILE_VPU"]


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        val = int(raw)
    except ValueError as e:
        raise ValueError(f"{name} must be an integer, got {raw!r}") from e
    if val <= 0:
        raise ValueError(f"{name} must be positive, got {val}")
    return val


# query-tile rows of every masked/unmasked pairwise kernel (bm / bq)
TILE_BQ = _env_int("REPRO_TILE_BQ", 128)

# corpus-block columns (bn / bb); the BSS index build keeps its own `block`
# parameter — for "block pruned == grid cell skipped" they should agree
TILE_BLOCK = _env_int("REPRO_TILE_BLOCK", 128)

# K lanes reduced per VPU pass in the broadcast-reduction tile kernels
# (jsd / triangular); bounds the (bm, bn, Kc) VMEM transient
TILE_KCHUNK = _env_int("REPRO_TILE_KCHUNK", 64)

# default square tile of the STANDALONE VPU kernels (the unmasked
# jsd/triangular entry points, where the transcendental cost dominates and
# a smaller tile keeps the broadcast transient cheap); the BSS masked
# exact phase always overrides with bm=TILE_BQ / bn=TILE_BLOCK
TILE_VPU = _env_int("REPRO_TILE_VPU", 64)

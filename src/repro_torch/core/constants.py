# Copy of src/repro/core/constants.py, kept so the port imports nothing of the JAX
# package; tests/test_torch_copies.py pins it to the original.
"""Shared numeric floors for the geometric machinery.

``MIN_DELTA`` is THE zero-baseline floor for every Hilbert / planar
computation that divides by an inter-pivot distance: the planar projection
``x = (d1^2 - d2^2) / (2 delta)``, the Hilbert exclusion criterion
``(d1^2 - d2^2) / delta > 2t``, and the kernels' in-VMEM copies of the same
math.  Before this constant existed the floors disagreed (``1e-300`` in
``core/tree.py`` vs ``1e-12`` everywhere else), so a duplicate pivot pair
(delta == 0) was clamped differently depending on which engine evaluated it
— same geometry, different exclusion decisions.

Soundness at the floor: with exact duplicates, ``d(q,p1) == d(q,p2)``
numerically (identical rows give identical float results), the numerator is
exactly 0 and ``0 / MIN_DELTA == 0`` — nothing is ever excluded through a
degenerate plane, which is the conservative (sound) behaviour.  A tiny
positive floor also keeps float32 arithmetic finite (``1e-300`` underflows
to 0 in float32 and produced inf/nan planar coordinates on device).
"""

from __future__ import annotations

# Minimum inter-pivot distance used as a divisor in planar / Hilbert math.
# float32-representable (unlike 1e-300) and far below any real distance.
MIN_DELTA = 1e-12

# Below this inter-pivot distance a plane is DEGENERATE (duplicate or
# near-duplicate pivots) and the apex x-coordinate is neutralised to 0 —
# the projection degrades to the sound triangle-inequality ring bound
# (x=0, y=d1) instead of dividing rounding noise by a tiny delta.  The
# hazard is real under jit: XLA fusion can evaluate d1^2 and d2^2 through
# different rewrites, so ``d1*d1 - d2*d2`` is ~1e-7 even when d1 == d2
# bitwise, and ``1e-7 / (2 * MIN_DELTA)`` is a catastrophically wrong
# planar coordinate.  1e-6 sits far above float32 noise and far below any
# meaningful pivot separation.
DEGENERATE_DELTA = 1e-6

__all__ = ["MIN_DELTA", "DEGENERATE_DELTA"]

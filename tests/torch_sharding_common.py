"""Shared pieces of the port's sharding tests: the three meshes the spec
trees are held to the reference's on, a stand-in for a JAX mesh (the
reference's spec functions read only ``mesh.axis_names`` and
``mesh.shape[axis]``, so no device is needed), and spec trees of either
package as plain tuples."""

from __future__ import annotations

from repro_torch.parallel.sharding import P, ShardMesh

# (axis names, shape): the 16 x 16 and 2 x 16 x 16 production meshes and a
# (2, 2) local mesh
MESHES = [
    (("data", "model"), (16, 16)),
    (("pod", "data", "model"), (2, 16, 16)),
    (("data", "model"), (2, 2)),
]


class StandInMesh:
    """What the reference's spec functions read of a ``jax.sharding.Mesh``."""

    def __init__(self, axis_names: tuple, shape: tuple):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, shape))


def meshes(names: tuple, shape: tuple) -> tuple[StandInMesh, ShardMesh]:
    """(the reference's stand-in, the port's mesh of ``meta`` devices)."""
    n = 1
    for s in shape:
        n *= s
    return StandInMesh(names, shape), ShardMesh(("meta",) * n, names, shape)


def spec_tuples(tree):
    """A tree of the reference's ``PartitionSpec``s or the port's ``P``s as
    the same tree of tuples (each entry as JAX normalises it)."""
    if isinstance(tree, dict):
        return {k: spec_tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [spec_tuples(v) for v in tree]
    if isinstance(tree, P):
        return tuple(tree)
    return tuple(P(*tree))  # a PartitionSpec, normalised as the port's P

"""Collectives over one axis of a :class:`ShardMesh`: the counterpart of
what GSPMD inserts when a layer's compute is split over the mesh.

One process drives every mesh device (``sharding``'s note), so a tensor
that "lives one per mesh device" is a list in mesh order, entry ``i`` on
``mesh.devices[i]``.  A collective over an axis (or a tuple of axes, the
first major) acts within each group of devices that share every other
coordinate, members ordered by their coordinate on the axis:

* ``all_gather(xs, mesh, axis, dim)`` — each member gets the group's
  tensors concatenated along ``dim`` in member order;
* ``reduce_scatter(xs, mesh, axis, dim)`` — member ``a`` gets piece ``a``
  (pieces of ``ceil(n / k)`` along ``dim``, the last shorter) of the
  group's sum;
* ``all_reduce(xs, mesh, axis)`` — each member gets the group's sum;
  ``all_reduce_max`` the elementwise maximum, outside autograd.

A sum adds the members in order 0 … k − 1 in float32 (float64 for a
float64 tensor; an integer tensor in its own dtype) and casts once, so its
bits do not depend on the run.  Each differentiable op is a
``torch.autograd.Function`` whose backward is its transpose, summing in
the same fixed order: all-gather ↔ reduce-scatter, all-reduce ↔
all-reduce.  A copy that a group holds replicated therefore carries a
partial gradient, and the true gradient is the sum over the copies, as
the transposes form it.

The ops run on any device type: CUDA devices (one card reused as several
mesh devices), CPU devices in the tests, and ``meta`` for the dry run's
shapes.  With ``probe=True`` (meta inputs only) the caller computes one
device's part and passes it for every member: the op computes the first
member and gives every other a tensor of its shape.  ``tally()`` counts
what they would move for one device, ring-reckoned (a group of k moves
(k − 1) / k of the whole, an all-reduce twice that), so the dry run reads
the activation collectives off a traced step: a recompute under remat and
the backward pass count again (into the tally that was open at the
forward, whatever thread runs the backward: on a card, autograd's device
thread).
"""

from __future__ import annotations

import contextlib
import threading
from typing import ContextManager, Iterator, Sequence

import numpy as np
import torch

from repro_torch.parallel.sharding import ShardMesh

__all__ = [
    "groups",
    "all_gather",
    "reduce_scatter",
    "all_reduce",
    "all_reduce_max",
    "piece_bounds",
    "tally",
    "tally_add",
    "moved",
]

_TALLY = threading.local()


def tally() -> ContextManager[dict]:
    """Bytes one device moves by kind while the block runs (module note)."""
    return _counting({})


@contextlib.contextmanager
def _counting(counts: dict | None) -> Iterator[dict | None]:
    """``counts`` the tally open in this thread while the block runs (a
    backward pass counts into its forward's)."""
    prev = _open()
    _TALLY.counts = counts
    try:
        yield counts
    finally:
        _TALLY.counts = prev


def _open():
    """The tally open in this thread, or None."""
    return getattr(_TALLY, "counts", None)


def tally_add(kind: str, nbytes: float) -> None:
    counts = _open()
    if counts is not None:
        counts[kind] = counts.get(kind, 0.0) + float(nbytes)


def _axes(axis) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def groups(mesh: ShardMesh, axis) -> list[list[int]]:
    """Mesh indices of each group over ``axis`` (module note)."""
    axes = _axes(axis)
    order = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(len(mesh.shape)) if i not in order]
    grid = np.arange(mesh.n_devices).reshape(mesh.shape)
    k = int(np.prod([mesh.shape[i] for i in order])) if order else 1
    return [list(map(int, g)) for g in np.transpose(grid, rest + order).reshape(-1, k)]


def piece_bounds(n: int, k: int, a: int) -> tuple[int, int]:
    """Piece ``a`` of ``k`` of a dim of ``n``: pieces of ``ceil(n / k)``."""
    step = -(-n // k)
    return min(n, a * step), min(n, (a + 1) * step)


def _wide(dtype: torch.dtype) -> torch.dtype:
    if dtype.is_floating_point:
        return torch.promote_types(dtype, torch.float32)
    return dtype


def _sum(parts: Sequence[torch.Tensor], device, dtype) -> torch.Tensor:
    """``parts`` added in order in the wide dtype on ``device``, cast once."""
    wide = _wide(dtype)
    acc = parts[0].to(device=device, dtype=wide)
    for p in parts[1:]:
        acc = acc + p.to(device=device, dtype=wide)
    return acc.to(dtype)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _check(xs, mesh: ShardMesh) -> None:
    if len(xs) != mesh.n_devices:
        raise ValueError(f"{len(xs)} tensors for a mesh of {mesh.n_devices} devices")


def _probe(xs, probe: bool) -> bool:
    """``probe`` (module note), checked: the inputs must be meta."""
    if probe and xs[0].device.type != "meta":
        raise ValueError(f"a probe takes meta tensors, not {xs[0].device}")
    return probe


def _alike(out: list, i0: int) -> list:
    return [out[i0] if i == i0 else torch.empty_like(out[i0]) for i in range(len(out))]


def _gather(xs, mesh, axis, dim, probe=False):
    out = [None] * len(xs)
    gs = groups(mesh, axis)
    for g in gs[:1] if probe else gs:
        for i in g[:1] if probe else g:
            out[i] = torch.cat([xs[q].to(mesh.devices[i]) for q in g], dim)
    k = len(gs[0])
    tally_add("all-gather", _nbytes(out[gs[0][0]]) * (k - 1) / k)
    return _alike(out, gs[0][0]) if probe else out


def _scatter(xs, mesh, axis, dim, probe=False):
    out = [None] * len(xs)
    gs = groups(mesh, axis)
    for g in gs[:1] if probe else gs:
        k = len(g)
        n = xs[g[0]].shape[dim]
        # the group's sum once (elementwise, so each piece has the bits its
        # own sum would), then each member's piece
        total = _sum([xs[q] for q in g], mesh.devices[g[0]], xs[g[0]].dtype)
        for a, i in enumerate(g[:1] if probe else g):
            lo, hi = piece_bounds(n, k, a)
            out[i] = total.narrow(dim, lo, hi - lo).to(mesh.devices[i], copy=True)
    k = len(gs[0])
    tally_add("reduce-scatter", _nbytes(xs[gs[0][0]]) * (k - 1) / k)
    return _alike(out, gs[0][0]) if probe else out


def _reduce(xs, mesh, axis, probe=False):
    out = [None] * len(xs)
    gs = groups(mesh, axis)
    for g in gs[:1] if probe else gs:
        total = _sum([xs[q] for q in g], mesh.devices[g[0]], xs[g[0]].dtype)
        for a, i in enumerate(g[:1] if probe else g):
            out[i] = total if a == 0 else total.to(mesh.devices[i], copy=True)
    k = len(gs[0])
    tally_add("all-reduce", 2 * _nbytes(xs[gs[0][0]]) * (k - 1) / k)
    return _alike(out, gs[0][0]) if probe else out


def _back(ctx, gs, fn, *args):
    """A transpose in the backward pass, tallied where the forward was;
    under a probe the one computed member's gradient alone (the others'
    inputs are its own)."""
    with _counting(ctx.counts):
        if ctx.probe:
            out = fn([gs[0]] * len(gs), *args, probe=True)
            return [out[0]] + [None] * (len(out) - 1)
        return fn(gs, *args)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, dim, probe, *xs):
        ctx.spec, ctx.probe, ctx.counts = (mesh, axis, dim), probe, _open()
        return tuple(_gather(xs, mesh, axis, dim, probe))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, None, *_back(ctx, gs, _scatter, *ctx.spec))


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, dim, probe, *xs):
        ctx.spec, ctx.probe, ctx.counts = (mesh, axis, dim), probe, _open()
        return tuple(_scatter(xs, mesh, axis, dim, probe))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, None, *_back(ctx, gs, _gather, *ctx.spec))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, probe, *xs):
        ctx.spec, ctx.probe, ctx.counts = (mesh, axis), probe, _open()
        return tuple(_reduce(xs, mesh, axis, probe))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, *_back(ctx, gs, _reduce, *ctx.spec))


class _Moved(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kind, nbytes, x):
        ctx.spec, ctx.counts = (kind, nbytes), _open()
        tally_add(kind, nbytes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with _counting(ctx.counts):
            tally_add(*ctx.spec)
        return None, None, g


def moved(x: torch.Tensor, kind: str, nbytes: float) -> torch.Tensor:
    """``x`` itself, tallying ``nbytes`` (one device's share) under ``kind``
    in the forward and again in the backward pass: the bytes of an
    exchange built from plain indexing (the MoE's all-to-all).  Outside a
    ``tally()`` it is ``x``, with no autograd node."""
    if _open() is None:
        return x
    return _Moved.apply(kind, float(nbytes), x)


def _trivial(mesh: ShardMesh, axis) -> bool:
    return all(mesh.size(a) == 1 for a in _axes(axis))


def all_gather(xs: Sequence[torch.Tensor], mesh: ShardMesh, axis, dim: int,
               probe: bool = False) -> list:
    _check(xs, mesh)
    if _trivial(mesh, axis):
        return list(xs)
    return list(_AllGather.apply(mesh, _axes(axis), dim, _probe(xs, probe), *xs))


def reduce_scatter(xs: Sequence[torch.Tensor], mesh: ShardMesh, axis, dim: int,
                   probe: bool = False) -> list:
    _check(xs, mesh)
    if _trivial(mesh, axis):
        return list(xs)
    return list(_ReduceScatter.apply(mesh, _axes(axis), dim, _probe(xs, probe), *xs))


def all_reduce(xs: Sequence[torch.Tensor], mesh: ShardMesh, axis,
               probe: bool = False) -> list:
    _check(xs, mesh)
    if _trivial(mesh, axis):
        return list(xs)
    return list(_AllReduce.apply(mesh, _axes(axis), _probe(xs, probe), *xs))


@torch.no_grad()
def all_reduce_max(xs: Sequence[torch.Tensor], mesh: ShardMesh, axis,
                   probe: bool = False) -> list:
    """Each member gets the group's elementwise maximum (no gradient: it
    only steadies a softmax)."""
    _check(xs, mesh)
    if _trivial(mesh, axis):
        return [x.detach() for x in xs]
    probe = _probe(xs, probe)
    out = [None] * len(xs)
    gs = groups(mesh, axis)
    for g in gs[:1] if probe else gs:
        top = xs[g[0]].detach().to(mesh.devices[g[0]])
        for q in g[1:]:
            top = torch.maximum(top, xs[q].detach().to(mesh.devices[g[0]]))
        for a, i in enumerate(g[:1] if probe else g):
            out[i] = top if a == 0 else top.to(mesh.devices[i], copy=True)
    k = len(gs[0])
    tally_add("all-reduce", 2 * _nbytes(xs[gs[0][0]]) * (k - 1) / k)
    return _alike(out, gs[0][0]) if probe else out

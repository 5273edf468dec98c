"""Parameter trees of the port's models, shared by every family.

A model is an ``nn.Module`` whose parameters are the reference's tree under
the reference's names (``param_shapes``: a name maps to ``(shape, dtype)``
or to a list of them).  It is built on the ``meta`` device, so a full
configuration costs nothing until ``init_params`` (the reference's
distribution from a ``torch.Generator``) or ``load_jax_params`` (the
reference's own numbers) puts its parameters on a device: the CUDA device
unless the caller passes ``device="cpu"``, raising where there is no card.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from repro_torch.core.flat_index import resolve_device

__all__ = ["ParamModule", "check_ids", "from_numpy", "load_jax_params", "cast_model"]


def check_ids(ids, vocab: int, name: str = "ids") -> None:
    """Raise unless every id lies in [0, vocab).  The reference's gathers
    clamp an id out of range; torch raises on the CPU and asserts on the
    card, so ids are checked on the host where they are made."""
    a = np.asarray(ids)
    if a.size and (a.min() < 0 or a.max() >= vocab):
        raise ValueError(
            f"{name} must lie in [0, {vocab}); got [{a.min()}, {a.max()}]"
        )


def _is_leaf(v) -> bool:
    return isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], tuple)


def _meta(spec) -> nn.Parameter:
    shape, dtype = spec
    return nn.Parameter(torch.empty(shape, dtype=dtype, device="meta"))


class ParamModule(nn.Module):
    """Parameters as the reference's tree (``param_shapes``), built on the
    ``meta`` device and placed by ``init_params`` / ``load_jax_params``."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        for name, spec in self.param_shapes().items():
            if _is_leaf(spec):
                setattr(self, name, _meta(spec))
            else:
                setattr(self, name, nn.ParameterList([_meta(s) for s in spec]))

    def param_shapes(self) -> dict:
        raise NotImplementedError

    def _zero_init(self, name: str) -> bool:
        """Whether the reference initialises leaf ``name`` to zeros."""
        return False

    def _leaves(self):
        """(name, list index or None, (shape, dtype)) of every parameter, in
        the reference tree's order."""
        for name, spec in self.param_shapes().items():
            if _is_leaf(spec):
                yield name, None, spec
            else:
                for i, s in enumerate(spec):
                    yield name, i, s

    def _set(self, name: str, i: int | None, value: torch.Tensor) -> None:
        p = nn.Parameter(value)
        if i is None:
            setattr(self, name, p)
        else:
            getattr(self, name)[i] = p

    def abstract_params(self) -> dict:
        """The parameter tree as ``meta`` tensors (no allocation)."""
        out: dict = {}
        for name, i, (shape, dt) in self._leaves():
            t = torch.empty(shape, dtype=dt, device="meta")
            if i is None:
                out[name] = t
            else:
                out.setdefault(name, []).append(t)
        return out

    def init_params(self, generator: torch.Generator, device=None):
        """Draw every parameter as the reference does: a float32 standard
        normal over sqrt(fan), fan = ``shape[-2]`` (``shape[-1]`` for 1-D),
        cast to its dtype, from ``generator`` (on ``device``'s type); the
        leaves the reference zeroes (``_zero_init``) are zeros.  The
        distribution is the reference's, not JAX's numbers.  Returns the
        model."""
        dev = resolve_device(device)
        for name, i, (shape, dt) in self._leaves():
            if self._zero_init(name):
                self._set(name, i, torch.zeros(shape, dtype=dt, device=dev))
                continue
            fan = shape[-2] if len(shape) > 1 else shape[-1]
            w = torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32)
            w /= math.sqrt(fan)
            self._set(name, i, w.to(dt))
            del w  # a bf16 leaf's float32 draw goes before the next draw
        return self

    def _p(self) -> dict:
        """The live parameters under the tree's names (what a model's
        blocks take, as a split step gives each mesh device its tree)."""
        return {k: getattr(self, k) for k in self.param_shapes()}

    def param_tree(self) -> dict:
        """The parameters as the reference's tree (the dict, its lists),
        detached tensors sharing the parameters' storage: what the train
        step and a checkpoint take."""
        out: dict = {}
        for name, i, _ in self._leaves():
            p = (getattr(self, name) if i is None else getattr(self, name)[i]).detach()
            if i is None:
                out[name] = p
            else:
                out.setdefault(name, []).append(p)
        return out

    def load_param_tree(self, params: dict):
        """Make the tensors of ``params`` (``param_tree``'s structure, e.g. a
        trained state's ``"params"``) the model's parameters, as they are.
        Returns the model."""
        for name, i, (shape, dt) in self._leaves():
            t = params[name] if i is None else params[name][i]
            if tuple(t.shape) != tuple(shape) or t.dtype != dt:
                raise ValueError(f"{name}: got {tuple(t.shape)} {t.dtype}, "
                                 f"want {tuple(shape)} {dt}")
            self._set(name, i, t.detach())
        return self

    def param_specs(self, mesh) -> dict:
        """The reference's partition specs of the parameter tree over
        ``mesh`` (a ``ShardMesh``), per family."""
        raise NotImplementedError

    def param_bytes(self) -> int:
        return sum(math.prod(shape) * dt.itemsize for _, _, (shape, dt) in self._leaves())


def from_numpy(a) -> torch.Tensor:
    """A host array of the reference's tree as a CPU tensor of its own
    dtype.  A bfloat16 array (numpy dtype name ``bfloat16``) is read
    through its 16-bit pattern, so ``ml_dtypes`` is never needed here."""
    a = np.array(a, copy=True)  # contiguous and writable
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def load_jax_params(model: ParamModule, params: dict, device=None):
    """Fill ``model`` with the reference's parameter tree ``params`` (numpy
    arrays: the dict, its lists), on ``device`` (the CUDA device unless
    ``"cpu"``).  Layouts stay the reference's, so both packages compute the
    same thing.  Returns the model."""
    dev = resolve_device(device)
    for name, i, (shape, dt) in model._leaves():
        a = params[name] if i is None else params[name][i]
        t = from_numpy(a)
        if tuple(t.shape) != tuple(shape) or t.dtype != dt:
            where = name if i is None else f"{name}[{i}]"
            raise ValueError(
                f"{where}: the tree holds {tuple(t.shape)} {t.dtype}, the "
                f"model wants {tuple(shape)} {dt}"
            )
        model._set(name, i, t.to(dev))
    return model


def cast_model(model: ParamModule, dtype: torch.dtype = torch.float32,
               device="cpu") -> ParamModule:
    """A copy of ``model`` in ``dtype`` on ``device`` over the same weights
    (upcast): e.g. the float32 CPU forward that a bf16 model on the card is
    held against.  A leaf the reference keeps in float32 (a norm, a router)
    stays float32."""
    out = type(model)(dataclasses.replace(model.cfg, dtype=dtype))
    dev = resolve_device(device)
    shapes = dict(((name, i), dt) for name, i, (_, dt) in out._leaves())
    for name, i, _ in model._leaves():
        p = getattr(model, name) if i is None else getattr(model, name)[i]
        out._set(name, i, p.detach().to(device=dev, dtype=shapes[name, i]))
    return out

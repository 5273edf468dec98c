"""Optimizers of the port: AdamW (fp32 states) and Adafactor (factored
second moment, no momentum), the port of ``repro.optim.optimizers``.

Plain functions on the reference's trees of tensors (``repro_torch.pytree``),
in the reference's arithmetic and order.  Every constant that meets a
tensor inside ``update`` is a float32 tensor on the tensor's device or a
Python scalar that torch rounds to float32, as XLA rounds a weak-typed
one.  A quotient with a constant on either side is one float32 division of
two tensors: torch forms ``x / t`` of a Python ``x`` as ``x * (1 / t)``,
and on CUDA ``t / c`` of a Python ``c`` as ``t * (1 / c)``, two roundings
each.  Nothing inside ``update`` reads a value to the host.

One card has no mesh, so ``state_specs`` (the optimizer state's partition
specs) raises, as ``param_specs`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.configs.common import SHARDING_ITEM
from repro_torch.pytree import leaves, leaves_upto, tree_map, unflatten

__all__ = [
    "Optimizer",
    "adamw",
    "adafactor",
    "cosine_schedule",
    "clip_by_global_norm",
    "make_optimizer",
]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    # update(grads, state, params) -> (new params, new state)
    update: Callable[..., tuple[Any, Any]]
    # state_specs(param_specs): the reference's partition specs; raises here
    state_specs: Callable[[Any], Any]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a float32 0-d tensor on ``like``'s device (no host copy)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _state_specs(_param_specs):
    raise NotImplementedError(f"optimizer state partitions are {SHARDING_ITEM}")


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as one float32 division (torch multiplies a CUDA tensor by
    the reciprocal of a Python divisor)."""
    return torch.div(x, _f32(c, x))


def _constant_lr(lr: float) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda step: _f32(lr, step)


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.1):
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = _div(peak * step, max(warmup, 1))
        frac = torch.clamp(_div(step - warmup, max(total - warmup, 1)), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm).
    The leaves' squared norms are summed in JAX's leaf order."""
    flat = leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in flat))
    scale = torch.clamp_max(
        torch.div(_f32(max_norm, gnorm), torch.clamp_min(gnorm, 1e-9)), 1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


def adamw(
    lr: Callable | float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
) -> Optimizer:
    lr_fn = lr if callable(lr) else _constant_lr(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        step_dev = leaves(params)[0].device
        return {
            "m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_dev),
        }

    @torch.no_grad()
    def update(grads, state, params, _unused_step=None):
        step = state["step"] + 1
        if grad_clip:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        lr_t = lr_fn(step)
        t = step.float()
        bc1 = 1 - torch.pow(_f32(b1, t), t)
        bc2 = 1 - torch.pow(_f32(b2, t), t)

        def upd(p, g, m, v):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mh, vh = m / bc1, v / bc2
            delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
            return (p.float() - lr_t * delta).to(p.dtype), m, v

        out = [upd(*a) for a in zip(leaves(params), leaves(grads), leaves(state["m"]),
                                     leaves(state["v"]))]
        new_params = unflatten(params, [o[0] for o in out])
        new_m = unflatten(params, [o[1] for o in out])
        new_v = unflatten(params, [o[2] for o in out])
        return new_params, {"m": new_m, "v": new_v, "step": step}

    return Optimizer(init, update, _state_specs)


def adafactor(
    lr: Callable | float = 1e-2,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
    scan_leading_dim: bool = True,
) -> Optimizer:
    """Factored Adafactor (Shazeer & Stern, 2018), momentum-free.

    For params with ndim >= 2 the second moment is factored over the last two
    dims (row/col running means); smaller params keep a full second moment.

    ``scan_leading_dim``: a stacked leaf (ndim >= 3, leading dim >= 8) is
    updated one leading slice at a time, as the reference's ``lax.scan``
    does: the RMS update clip is per slice, and the float32 transients are
    one slice's.
    """
    lr_fn = lr if callable(lr) else _constant_lr(lr)

    def _factored(p):
        return p.ndim >= 2

    def init(params):
        def one(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)  # noqa: E731
            if _factored(p):
                return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}

        return {
            "f": tree_map(one, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device),
        }

    @torch.no_grad()
    def update(grads, state, params, _unused=None):
        step = state["step"] + 1
        t = step.float()
        beta = 1.0 - t ** (-decay)
        lr_t = lr_fn(step)

        def upd_slice(p, g, f):
            g = g.float()
            g2 = g * g + eps
            if "vr" in f:
                vr = beta * f["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * f["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                rfac = torch.rsqrt(
                    vr / torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True), eps))
                cfac = torch.rsqrt(vc)
                u = g * rfac[..., None] * cfac[..., None, :]
                newf = {"vr": vr, "vc": vc}
            else:
                v = beta * f["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v)
                newf = {"v": v}
            # update clipping (RMS)
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp_min(_div(rms, clip_threshold), 1.0)
            newp = p.float() - lr_t * (u + weight_decay * p.float())
            return newp.to(p.dtype), newf

        def upd(p, g, f):
            if scan_leading_dim and p.ndim >= 3 and p.shape[0] >= 8:
                outs = [upd_slice(p[i], g[i], {k: v[i] for k, v in f.items()})
                        for i in range(p.shape[0])]
                return (torch.stack([o[0] for o in outs]),
                        {k: torch.stack([o[1][k] for o in outs]) for k in outs[0][1]})
            return upd_slice(p, g, f)

        out = [upd(p, g, f) for p, g, f in zip(leaves(params), leaves(grads),
                                                 leaves_upto(state["f"], params))]
        new_params = unflatten(params, [o[0] for o in out])
        new_f = unflatten(params, [o[1] for o in out])
        return new_params, {"f": new_f, "step": step}

    return Optimizer(init, update, _state_specs)


def make_optimizer(kind: str, total_steps: int = 10_000) -> Optimizer:
    if kind == "adamw":
        return adamw(lr=cosine_schedule(3e-4, 200, total_steps))
    if kind == "adafactor":
        return adafactor(lr=cosine_schedule(1e-2, 200, total_steps))
    raise ValueError(kind)

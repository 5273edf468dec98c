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

Each optimizer is split where a mesh splits it: ``prepare`` reads the
whole gradient tree (the step count, the learning rate, AdamW's global
clip factor) and ``leaf`` updates one parameter and its own state from
those scalars (AdamW scaling its gradient by the clip factor first).  ``update`` is the reference's functional step (new trees);
``update_`` writes each new leaf into the old tensors in place, leaf by
leaf, through the same ``leaf`` (so the same operations in the same
order, bit for bit): the port's counterpart of the reference's
``donate_argnums=(0,)``, holding one leaf's transients instead of a second
state.  ``elementwise`` says whether ``leaf`` works element by element
given the scalars, so that a piece of a leaf updates alone on its own
device (AdamW; Adafactor's factored moments and RMS clip reach over whole
dims).  ``state_specs`` is the reference's: the state's partition specs
from the parameters'.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.parallel.sharding import P, ShardedTensor
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
    # prepare(grads, state) -> the step's scalars ("step": the new count):
    # what reads the whole gradient tree
    prepare: Callable[[Any, Any], dict]
    # leaf(p, g, s, scalars) -> (new p, new s): one leaf, s its state dict
    leaf: Callable[..., tuple[torch.Tensor, dict]]
    # split(state, params) -> each leaf's state dict (views of ``state``'s
    # tensors), in ``params``' leaf order; join(params, dicts, step) the
    # state tree back
    split: Callable[[Any, Any], list]
    join: Callable[[Any, list, torch.Tensor], Any]
    # state_specs(param_specs) -> the state's partition specs
    state_specs: Callable[[Any], Any]
    elementwise: bool

    def update(self, grads, state, params, _unused_step=None):
        """(new params, new state): the reference's functional update."""
        sc = self.prepare(grads, state)
        out = [self.leaf(p, g, s, sc)
               for p, g, s in zip(leaves(params), leaves(grads), self.split(state, params))]
        return (unflatten(params, [o[0] for o in out]),
                self.join(params, [o[1] for o in out], sc["step"]))

    @torch.no_grad()
    def update_(self, grads, state, params) -> None:
        """``update`` written into ``params`` and ``state`` in place, one
        leaf at a time (``leaf_``)."""
        sc = self.prepare(grads, state)
        for p, g, s in zip(leaves(params), leaves(grads), self.split(state, params)):
            self.leaf_(p, g, s, sc)
        state["step"].copy_(sc["step"])

    @torch.no_grad()
    def leaf_(self, p: torch.Tensor, g: torch.Tensor, s: dict, sc: dict) -> None:
        """``leaf`` written into ``p`` and ``s`` in place.  An elementwise
        optimizer goes ``CHUNK`` elements at a time (each element's
        operations are the same, so are its bits), so its transients are a
        chunk's, not a leaf's."""
        if self.elementwise and p.numel() > CHUNK and p.is_contiguous() and all(
                v.is_contiguous() for v in s.values()):
            flat_p, flat_g = p.view(-1), g.reshape(-1)
            flat_s = {k: v.view(-1) for k, v in s.items()}
            for i in range(0, flat_p.numel(), CHUNK):
                sl = slice(i, i + CHUNK)
                self.leaf_(flat_p[sl], flat_g[sl], {k: v[sl] for k, v in flat_s.items()}, sc)
            return
        new_p, new_s = self.leaf(p, g, s, sc)
        p.copy_(new_p)
        for k, v in new_s.items():
            s[k].copy_(v)


# elements an elementwise in-place update takes at a time (64 MiB of float32
# transients each)
CHUNK = 1 << 24


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a float32 0-d tensor on ``like``'s device (no host copy)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


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


def _clip_scale(grads, max_norm: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(the factor that scales ``grads`` to a global norm of at most
    ``max_norm``, the norm).  The leaves' squared norms are summed in JAX's
    leaf order; a leaf in pieces (a ``ShardedTensor``) sums its pieces'
    own squares in piece order."""
    flat = leaves(grads)
    gnorm = torch.sqrt(sum(g.sum_sq() if isinstance(g, ShardedTensor) else
                           torch.sum(g.float() ** 2) for g in flat))
    scale = torch.clamp_max(
        torch.div(_f32(max_norm, gnorm), torch.clamp_min(gnorm, 1e-9)), 1.0)
    return scale, gnorm


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    scale, gnorm = _clip_scale(grads, max_norm)
    return tree_map(lambda g: _clipped(g, scale), grads), gnorm


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
    def prepare(grads, state):
        step = state["step"] + 1
        # the global clip's factor; each leaf is scaled by it in ``leaf``
        # (elementwise: the bits of scaling the whole tree first)
        sc = {"clip": _clip_scale(grads, grad_clip)[0]} if grad_clip else {}
        lr_t = lr_fn(step)
        t = step.float()
        bc1 = 1 - torch.pow(_f32(b1, t), t)
        bc2 = 1 - torch.pow(_f32(b2, t), t)
        return {**sc, "step": step, "lr": lr_t, "bc1": bc1, "bc2": bc2}

    @torch.no_grad()
    def leaf(p, g, s, sc):
        if "clip" in sc:
            g = _clipped(g, sc["clip"])
        g = g.float()
        m = b1 * s["m"] + (1 - b1) * g
        v = b2 * s["v"] + (1 - b2) * g * g
        mh, vh = m / sc["bc1"], v / sc["bc2"]
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        return (p.float() - sc["lr"] * delta).to(p.dtype), {"m": m, "v": v}

    def split(state, params):
        return [{"m": m, "v": v} for m, v in zip(leaves(state["m"]), leaves(state["v"]))]

    def join(params, dicts, step):
        return {"m": unflatten(params, [d["m"] for d in dicts]),
                "v": unflatten(params, [d["v"] for d in dicts]), "step": step}

    def state_specs(param_specs):
        return {"m": param_specs, "v": param_specs, "step": P()}

    return Optimizer(init, prepare, leaf, split, join, state_specs, elementwise=True)


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
    def prepare(grads, state):
        step = state["step"] + 1
        t = step.float()
        return {"step": step, "beta": 1.0 - t ** (-decay), "lr": lr_fn(step)}

    def upd_slice(p, g, f, beta, lr_t):
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

    @torch.no_grad()
    def leaf(p, g, f, sc):
        beta, lr_t = sc["beta"], sc["lr"]
        if scan_leading_dim and p.ndim >= 3 and p.shape[0] >= 8:
            outs = [upd_slice(p[i], g[i], {k: v[i] for k, v in f.items()}, beta, lr_t)
                    for i in range(p.shape[0])]
            return (torch.stack([o[0] for o in outs]),
                    {k: torch.stack([o[1][k] for o in outs]) for k in outs[0][1]})
        return upd_slice(p, g, f, beta, lr_t)

    def split(state, params):
        return leaves_upto(state["f"], params)

    def join(params, dicts, step):
        return {"f": unflatten(params, dicts), "step": step}

    def state_specs(param_specs):
        def one(spec):
            # vr drops the last dim's sharding, vc the second-to-last's
            parts = tuple(spec)
            if len(parts) >= 2:
                return {"vr": P(*parts[:-1]), "vc": P(*(parts[:-2] + parts[-1:]))}
            return {"v": P(*parts) if parts else P()}

        return {"f": tree_map(one, param_specs), "step": P()}

    return Optimizer(init, prepare, leaf, split, join, state_specs, elementwise=False)


def make_optimizer(kind: str, total_steps: int = 10_000) -> Optimizer:
    if kind == "adamw":
        return adamw(lr=cosine_schedule(3e-4, 200, total_steps))
    if kind == "adafactor":
        return adafactor(lr=cosine_schedule(1e-2, 200, total_steps))
    raise ValueError(kind)

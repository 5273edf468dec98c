"""Train-step factory of the port: microbatch gradient accumulation and the
optimizer's apply, the port of ``repro.train.step``.

The state is the reference's tree, ``{"params", "opt", "step"}`` (plus
``"residual"`` with compression), ``step`` an int32 tensor, so a
checkpoint of either package restores in the other.  ``loss_fn(params,
batch)`` takes the parameter tree, as the reference's does;
``functional_loss`` makes one from a port model (which holds its
parameters) and its ``loss(batch)``.  Gradients come from
``torch.autograd`` against the tree's tensors, put into the model for the
call by ``torch.func.functional_call``.  Microbatches (the reference's
``lax.scan``) are a loop that accumulates in ``accum_dtype``.  Nothing in
a step reads a value to the host; the loop's ``float(loss)`` is the one
sync a step.

``apply`` is the reference's functional update (a new state);
``apply_`` writes the new parameters, moments and residual into the old
tensors in place, leaf by leaf, with the same operations: the counterpart
of the reference's ``jax.jit(step, donate_argnums=(0,))``, which the loop
and the launcher use.  It never holds two optimizer states.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from repro_torch.optim import Optimizer, int8_error_feedback, int8_error_feedback_
from repro_torch.pytree import leaves, leaves_with_paths, tree_map, unflatten

__all__ = ["make_train_step", "init_state", "functional_loss", "to_device", "TrainStep"]


def init_state(params, optimizer: Optimizer, compression: bool = False) -> dict:
    dev = leaves(params)[0].device
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if compression:
        state["residual"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    return state


class _Loss(nn.Module):
    """Holds the model so ``functional_call`` can put a parameter tree into
    it for one call of ``loss``."""

    def __init__(self, model: nn.Module, loss: Callable[[dict], torch.Tensor]):
        super().__init__()
        self.model = model
        self.loss = loss

    def forward(self, batch: dict) -> torch.Tensor:
        return self.loss(batch)


def functional_loss(model: nn.Module, loss: Callable[[dict], torch.Tensor]) -> Callable:
    """``loss_fn(params, batch)``: ``loss(batch)`` (e.g.
    ``configs.common.loss_for(family, model)``) with ``model``'s parameters
    taken from the tree ``params`` (``model.param_tree()``'s structure)."""
    holder = _Loss(model, loss)

    def loss_fn(params, batch):
        named = {"model." + ".".join(map(str, path)): t
                 for path, t in leaves_with_paths(params)}
        return torch.func.functional_call(holder, named, (batch,))

    return loss_fn


def to_device(batch: dict, device) -> dict:
    """A stream's numpy batch as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


def _value_and_grad(loss_fn: Callable, params, batch) -> tuple[torch.Tensor, Any]:
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    return loss.detach(), unflatten(params, list(grads))


@dataclasses.dataclass(frozen=True)
class TrainStep:
    """``step(state, batch) -> (state, {"loss"})``, in two parts that can be
    timed apart: ``grads`` (forward and backward, over the microbatches)
    and ``apply`` (compression, the optimizer, the step count)."""

    loss_fn: Callable
    optimizer: Optimizer
    microbatches: int = 1
    compression: bool = False
    accum_dtype: torch.dtype = torch.float32

    def _split(self, batch: dict) -> list[dict]:
        m = self.microbatches
        for x in batch.values():
            if x.shape[0] % m != 0:
                raise ValueError(
                    f"batch size {x.shape[0]} not divisible by microbatches {m}")
        split = {k: x.reshape(m, x.shape[0] // m, *x.shape[1:]) for k, x in batch.items()}
        return [{k: x[i] for k, x in split.items()} for i in range(m)]

    def grads(self, params, batch: dict) -> tuple[torch.Tensor, Any]:
        """(loss, gradients): over the whole batch, or summed over the
        microbatches in ``accum_dtype`` and divided by their count."""
        if self.microbatches == 1:
            return _value_and_grad(self.loss_fn, params, batch)
        first = leaves(params)[0]
        acc_l = torch.zeros((), dtype=torch.float32, device=first.device)
        acc_g = tree_map(lambda p: torch.zeros(p.shape, dtype=self.accum_dtype,
                                               device=p.device), params)
        for mb in self._split(batch):
            l, g = _value_and_grad(self.loss_fn, params, mb)
            acc_g = tree_map(lambda a, x: a + x.to(self.accum_dtype), acc_g, g)
            acc_l = acc_l + l
        return (acc_l / self.microbatches,
                tree_map(lambda g: g / self.microbatches, acc_g))

    @torch.no_grad()
    def apply(self, state: dict, grads) -> dict:
        new_state = dict(state)
        if self.compression:
            grads, new_state["residual"] = int8_error_feedback(grads, state["residual"])
        new_params, new_opt = self.optimizer.update(grads, state["opt"], state["params"])
        new_state["params"] = new_params
        new_state["opt"] = new_opt
        new_state["step"] = state["step"] + 1
        return new_state

    @torch.no_grad()
    def apply_(self, state: dict, grads) -> dict:
        """``apply`` written into ``state``'s tensors in place; returns
        ``state``."""
        if self.compression:
            grads = int8_error_feedback_(grads, state["residual"])
        self.optimizer.update_(grads, state["opt"], state["params"])
        state["step"].copy_(state["step"] + 1)
        return state

    def __call__(self, state: dict, batch: dict) -> tuple[dict, dict]:
        loss, grads = self.grads(state["params"], batch)
        return self.apply(state, grads), {"loss": loss}

    def step_(self, state: dict, batch: dict) -> tuple[dict, dict]:
        """One step updating ``state`` in place (``apply_``)."""
        loss, grads = self.grads(state["params"], batch)
        return self.apply_(state, grads), {"loss": loss}


def make_train_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    optimizer: Optimizer,
    microbatches: int = 1,
    compression: bool = False,
    accum_dtype: torch.dtype = torch.float32,
) -> TrainStep:
    """``accum_dtype``: gradient-accumulation precision (float32, the safe
    default; bfloat16 halves the accumulator's memory)."""
    return TrainStep(loss_fn, optimizer, microbatches, compression, accum_dtype)

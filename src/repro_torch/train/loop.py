"""Fault-tolerant training loop of the port, the port of
``repro.train.loop``:

  * checkpoint/restart: periodic async checkpoints of (state, the data
    stream's state); on start, resume from the latest checkpoint,
  * elastic restart: checkpoints hold host-side leaves, so a restart may
    place them on another device (``device=``),
  * straggler watchdog: an EMA of each step's wall time; a step slower than
    ``straggler_factor`` x EMA is logged and counted,
  * optional int8 error-feedback gradient compression (``repro_torch.optim``),
  * each step updates the state in place (``TrainStep.step_``: the
    counterpart of the reference's ``donate_argnums=(0,)``), so the loop
    never holds two optimizer states.

The loop runs on the CUDA device unless it is given ``device="cpu"``; given
``sharded`` (a ``parallel.sharded_step.ShardedTrainStep``) it runs that
step over its mesh, the state in pieces, and a restart restores the latest
checkpoint under that mesh whatever mesh saved it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.flat_index import resolve_device
from repro_torch.optim import Optimizer
from repro_torch.pytree import tree_map
from repro_torch.serve.queue import now
from repro_torch.train.step import init_state, make_train_step, to_device

__all__ = ["TrainLoop", "TrainLoopConfig"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = "checkpoints"
    keep_last: int = 3
    log_every: int = 10
    microbatches: int = 1
    compression: bool = False
    straggler_factor: float = 3.0


class TrainLoop:
    def __init__(
        self,
        loss_fn: Callable,
        optimizer: Optimizer,
        stream,  # data pipeline with next()/state()/restore()
        cfg: TrainLoopConfig,
        device=None,
        sharded=None,
    ):
        self.cfg = cfg
        self.optimizer = optimizer
        self.stream = stream
        self.sharded = sharded
        self.device = sharded.mesh.lead if sharded is not None else resolve_device(device)
        self.ckpt = CheckpointManager(cfg.checkpoint_dir, cfg.keep_last)
        self.step_fn = sharded if sharded is not None else make_train_step(
            loss_fn, optimizer, cfg.microbatches, cfg.compression)
        self.stragglers = 0
        self.losses: list[float] = []
        self.step_seconds: list[float] = []  # each step's wall time, the sync included

    def init_or_restore(self, init_params_fn: Callable) -> Any:
        """A fresh state from ``init_params_fn()`` (a parameter tree), or the
        latest checkpoint's, with the stream's state restored."""
        params = tree_map(lambda t: t.to(self.device), init_params_fn())
        state = init_state(params, self.optimizer, self.cfg.compression)
        latest = self.ckpt.latest_step()
        if latest is None:
            return state if self.sharded is None else self.sharded.shard(state)
        state, extra = self.ckpt.restore(
            state, step=latest, device=self.device,
            placements=None if self.sharded is None else self.sharded.placements)
        self.stream.restore(extra["stream"])
        print(f"[restore] resumed from step {latest}")
        return state

    def run(self, state: Any, crash_at: int | None = None) -> Any:
        ema = None
        start = int(state["step"] if self.sharded is None
                    else state["step"].gather(self.device))
        for step in range(start, self.cfg.total_steps):
            batch = to_device(self.stream.next(), self.device)
            t0 = now()
            state, metrics = self.step_fn.step_(state, batch)
            loss = float(metrics["loss"])  # blocks: the one sync a step
            dt = now() - t0
            self.losses.append(loss)
            self.step_seconds.append(dt)
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            if dt > self.cfg.straggler_factor * ema and step > start + 3:
                self.stragglers += 1
                print(f"[straggler] step {step} took {dt:.3f}s (ema {ema:.3f}s)")
            if (step + 1) % self.cfg.log_every == 0:
                print(f"step {step + 1}: loss={loss:.4f} ({dt * 1e3:.0f} ms)")
            if (step + 1) % self.cfg.checkpoint_every == 0:
                self.ckpt.save(
                    step + 1, state, extra={"stream": self.stream.state()},
                    blocking=False,
                )
            if crash_at is not None and step + 1 >= crash_at:
                self.ckpt.wait()
                raise RuntimeError(f"simulated crash at step {step + 1}")
        self.ckpt.wait()
        return state

"""Fault-tolerant checkpointing, the port of ``repro.checkpoint.manager``,
in the reference's on-disk format, so a checkpoint written by either
package restores in the other:

  * one ``.npy`` file per leaf of the state tree and a ``manifest.json``
    (each leaf's key, file, shape, logical dtype and the first 16 hex
    digits of its sha256);
  * leaf keys are the reference's: dict keys and list indices joined with
    ``/``, dict keys sorted (``repro_torch.pytree``);
  * bfloat16 (and fp8) leaves are stored as their same-width unsigned
    integer pattern with the logical dtype in the manifest, and read back
    through that pattern, so no ``ml_dtypes`` is needed;
  * two-phase commit: written into ``step_K.tmp/``, then renamed to
    ``step_K/``: a crash mid-save never corrupts the latest checkpoint;
  * async save: every leaf is copied to the host before the writer thread
    starts, so a later in-place update never reaches a save in flight;
  * restore places the leaves on any device (``device=``) or over any
    mesh (``placements=``, the counterpart of the reference's
    ``shardings=``): a state saved under one mesh restores under another
    (an elastic reshard).  A leaf laid out over a mesh (a
    ``ShardedTensor``) is saved whole, so either package reads either
    checkpoint.

Leaves are written, read and hashed by a pool of threads (``np.save``,
``np.load`` and sha256 release the interpreter lock), one leaf each: the
files and the manifest are the reference's, in the reference's order.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.core.flat_index import resolve_device
from repro_torch.parallel.sharding import ShardedTensor
from repro_torch.pytree import leaves, leaves_with_paths, path_key, unflatten

__all__ = ["CheckpointManager"]

IO_THREADS = 8  # leaves written / read at once

# logical dtype -> (torch dtype, the same-width integer torch and numpy
# dtypes it is read through, the numpy dtype it is stored as)
_EXOTIC = {
    "bfloat16": (torch.bfloat16, torch.int16, np.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8, np.uint8),
}
_BY_TORCH = {dt: name for name, (dt, _, _, _) in _EXOTIC.items()}


def _host_copy(leaf) -> tuple[np.ndarray, str]:
    """(a storable host array of ``leaf`` that owns its memory, its logical
    dtype name)."""
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.gather("cpu")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = _BY_TORCH.get(t.dtype)
        if name is None:
            arr = t.to("cpu", copy=True).numpy()
            return arr, arr.dtype.name
        _, int_t, _, stored = _EXOTIC[name]
        return t.view(int_t).to("cpu", copy=True).numpy().view(stored), name
    arr = np.array(leaf, copy=True)
    name = arr.dtype.name  # an ml_dtypes bfloat16 array is named "bfloat16"
    if name in _EXOTIC:
        return arr.view(_EXOTIC[name][3]), name
    return arr, name


def _from_storable(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical in _EXOTIC:
        dt, _, int_np, _ = _EXOTIC[logical]
        return torch.from_numpy(arr.view(int_np)).view(dt)
    return torch.from_numpy(arr)


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr)).hexdigest()[:16]


class CheckpointManager:
    def __init__(self, directory: str | Path, keep_last: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        # the last save: host-copy and write seconds, bytes written
        self.last_save: dict = {}

    # ------------------------------------------------------------------ save

    def save(self, step: int, state: Any, extra: dict | None = None,
             blocking: bool = True) -> None:
        """Two-phase-commit save of a tree of tensors (+ JSON-able
        ``extra``)."""
        t0 = time.perf_counter()
        host = [(path_key(p), *_host_copy(leaf)) for p, leaf in leaves_with_paths(state)]
        self.last_save = {"step": step, "host_copy_s": time.perf_counter() - t0}
        if blocking:
            self._write(step, host, extra or {})
        else:
            self.wait()
            self._thread = threading.Thread(target=self._write, args=(step, host, extra or {}))
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: list, extra: dict) -> None:
        t0 = time.perf_counter()
        tmp = self.dir / f"step_{step:09d}.tmp"
        final = self.dir / f"step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

        def one(i: int, key: str, arr: np.ndarray, logical: str) -> dict:
            fname = f"leaf_{i:05d}.npy"
            np.save(tmp / fname, arr)
            return {"key": key, "file": fname, "shape": list(arr.shape), "dtype": logical,
                    "sha256": _sha(arr)}

        with ThreadPoolExecutor(IO_THREADS) as pool:
            entries = list(pool.map(one, range(len(host)), *zip(*host)))
        manifest = {"step": step, "extra": extra, "leaves": entries, "treedef": ""}
        n_bytes = sum((tmp / m["file"]).stat().st_size for m in entries)
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic commit
        self._gc()
        self.last_save.update(write_s=time.perf_counter() - t0, bytes=n_bytes)

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # --------------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        return sorted(
            int(p.name.split("_")[1])
            for p in self.dir.glob("step_*")
            if not p.name.endswith(".tmp")
        )

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: int | None = None, device=None,
                verify: bool = True, placements: Any = None) -> tuple[Any, dict]:
        """Restore into the structure of ``like`` (a tree of tensors, ``meta``
        tensors, arrays or ``ShardedTensor``s: only its structure and keys
        are read), every leaf on ``device``: the CUDA device unless
        ``"cpu"``, raising where there is none.  With ``placements`` (a tree
        of ``Placement``s, ``like``'s structure) each leaf is laid out over
        its mesh instead, as a ``ShardedTensor``.  Returns (state, the
        save's ``extra``)."""
        if placements is not None:
            flat_pl = leaves(placements)
            dev = torch.device("cpu")
        else:
            dev = resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat_like = leaves_with_paths(like)
        if len(flat_like) != len(manifest["leaves"]):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, "
                f"restore target has {len(flat_like)}"
            )
        by_key = {m["key"]: m for m in manifest["leaves"]}

        def load(path: tuple) -> torch.Tensor:
            key = path_key(path)
            m = by_key[key]
            arr = np.load(d / m["file"])
            if verify and _sha(arr) != m["sha256"]:
                raise IOError(f"checksum mismatch for {key} in step {step}")
            return _from_storable(arr, m["dtype"])

        with ThreadPoolExecutor(IO_THREADS) as pool:
            out = [t.to(dev) for t in pool.map(load, [p for p, _ in flat_like])]
        if placements is not None:
            if len(flat_pl) != len(out):
                raise ValueError(f"{len(flat_pl)} placements for {len(out)} leaves")
            out = [ShardedTensor.place(t, pl) for t, pl in zip(out, flat_pl)]
        return unflatten(like, out), manifest["extra"]

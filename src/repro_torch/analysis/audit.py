"""Runtime audit of the port's engine passes — the counterpart of
``repro.analysis.jaxpr_audit``.

The reference traces each engine jit and walks the jaxpr.  The port's
engines are eager torch, so the audit watches them run instead.  It wraps
the pass functions that play the part of the reference's jits (``PASSES``:
the bound phase, the range and kNN passes of both precisions and both
realisations, the sharded round and merge, the forest walks) in every
namespace that holds them, drives the public entry points
(``bss_query_batched``, ``bss_knn_batched``, ``shard_bss`` with
``sharded_query_batched`` / ``sharded_knn_batched``,
``forest_range_search``, ``monotone_range_search``) over small synthetic
indexes across the {metric x backend x realisation x precision} matrix, and
checks every pass call:

* ``sync``: nothing in a pass waits for the host.  On a CUDA device the
  pass runs under ``torch.cuda.set_sync_debug_mode("error")``, which is
  authoritative (it also catches copies between the device and the host);
  on every device a ``TorchDispatchMode`` flags the operators that
  synchronise on a card (``_SYNC_OPS``, boolean indexing,
  ``repeat_interleave`` without ``output_size``), which is all the CPU has
  and on a card covers what the prototype debug mode misses;
* ``f64``: no operator inside a pass makes a float64 tensor;
* ``bf16-present`` / ``bf16-absent``: bfloat16 appears in a cell's passes
  if and only if the cell runs ``precision="bf16"``;
* ``taint``: with bf16, a dynamic taint walk from the storage of the bf16
  mirror (``index.device_bf16``, the sharded ``data16``, the forest
  ``leaf_bf16``) marks every operator output, and every in-place target,
  that has a tainted input; the kernel wrappers (``KERNEL_WRAPPERS``) pass
  taint across their launches, which do not dispatch.  The bound-phase
  outputs (``_clean_outputs``, the reference's ``_UNTAINTED_SPECS``) must
  stay clean;
* ``bound-bits``: the bf16 cell's bounds and ``alive`` masks equal its fp32
  sibling's bit for bit;
* ``coverage``: every pass the cell must run fired.

The documented host points stay outside the passes: range hit assembly,
the kNN driver's per-round copy and ``done`` test, and the "torch" adaptive
realisation's choice between the gathered cells and the dense pass.

``audit_rebuilds`` is the counterpart of ``audit_compile_cache``: a stream
of 1-10 requests, range and kNN, through ``ServingFront`` with a short
bucket ladder, before and after a generation swap.  Every pass must see
one batch shape per bucket the stream touches, per entry point, and no
kernel library may load twice (``_build.load_count``: the port's only
rebuild).  ``audit_index`` holds one batch of a full-size index to the
same checks.

The wrappers live only while one of these functions runs; the engines run
unwrapped otherwise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib
import sys
import threading
import warnings
from collections import Counter
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core.backends import EngineOpts

__all__ = [
    "AuditProblem",
    "AUDIT_METRICS",
    "PASSES",
    "KERNEL_WRAPPERS",
    "run_audit",
    "audit_rebuilds",
    "audit_index",
    "watch_call",
]

AUDIT_METRICS = ("l2", "cosine", "jsd", "triangular")
AUDIT_KNN_K = 10        # ``audit_index``'s kNN round
REBUILD_BUCKETS = (4, 8)  # ``audit_rebuilds``' bucket ladder

# module -> the pass functions it defines (the reference's engine jits)
PASSES = {
    "repro_torch.core.flat_index": (
        "_fused_lower_bounds", "_query_batched", "_query_batched_bf16", "_dense_hit_mask",
        "_cells_exact", "_cells_exact_bf16", "_knn_round", "_knn_round_bf16",
        "_knn_round_cells", "_knn_round_cells_bf16",
    ),
    "repro_torch.parallel.shard_index": ("_knn_round", "_merge_top_k"),
    "repro_torch.forest.walk": ("_forest_walk", "_monotone_walk"),
}
# the kernel wrappers: their launches go through ctypes and do not dispatch
KERNEL_WRAPPERS = {
    "repro_torch.kernels.pairwise_dist": ("pairwise_kernel_call",
                                          "masked_pairwise_kernel_call"),
    "repro_torch.kernels.planar_exclusion": ("planar_lower_bound_pairs_kernel_call",),
}
# the public entry points, wrapped by ``audit_rebuilds`` to tell the passes
# of a range batch from those of a kNN batch
_ENTRIES = {"bss_query_batched": "range", "bss_knn_batched": "knn"}

# operators that wait for the host on a card (the CPU's stand-in for
# ``set_sync_debug_mode``): a value read to the host, or an output whose
# size depends on the data
_SYNC_OPS = {
    "_local_scalar_dense", "nonzero", "masked_select", "is_nonzero", "equal",
    "_unique", "_unique2", "unique_dim", "unique_consecutive", "unique_dim_consecutive",
    "lift_fresh",
}
_BOOL_INDEX_OPS = {"index", "index_put", "index_put_", "_index_put_impl_"}
_F64 = torch.float64  # lint: disable=R3


@dataclasses.dataclass(frozen=True)
class AuditProblem:
    cell: str    # matrix cell, e.g. "bss/jsd/torch-adaptive/bf16"
    fn: str      # pass, e.g. "flat_index._query_batched_bf16"
    check: str   # sync | f64 | bf16-present | bf16-absent | taint | bound-bits
                 # | coverage | shapes | loads
    detail: str

    def format(self) -> str:
        return f"[{self.cell}] {self.fn}: {self.check}: {self.detail}"


def _label(modname: str, name: str) -> str:
    return f"{modname.rsplit('.', 1)[1]}.{name}"


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _key(t: torch.Tensor):
    """Taint key of a tensor: its storage (views and in-place targets share
    it), or None for an empty one."""
    if t.numel() == 0:
        return None
    return (t.device, t.untyped_storage().data_ptr())


def _digest(t: torch.Tensor) -> str:
    a = t.detach().cpu().contiguous()
    return f"{tuple(a.shape)}{a.dtype}" + hashlib.sha256(a.numpy().tobytes()).hexdigest()


def _syncs(func, args, kwargs) -> bool:
    """Whether ``func`` waits for the host on a card."""
    name = func._overloadpacket.__name__
    if name in _SYNC_OPS:
        return True
    if name in _BOOL_INDEX_OPS:
        indices = args[1] if len(args) > 1 else kwargs.get("indices", ())
        return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in indices or ())
    if name == "repeat_interleave" and func._overloadname in ("Tensor", "self_Tensor"):
        return kwargs.get("output_size") is None
    return False


def _clean_outputs(fn: str, out) -> dict:
    """The outputs of a pass that must not depend on the bf16 corpus (the
    reference's ``_UNTAINTED_SPECS``), by name."""
    if fn == "flat_index._query_batched_bf16":
        return {"alive": out[1], "tile_mask": out[2]}
    if fn == "flat_index._knn_round_bf16":
        return {"alive": out[4]}
    if fn == "shard_index._knn_round":
        return {"alive": out[2]}
    if fn == "walk._forest_walk":
        ref_hits, _, counts, _, _, obs = out
        return {"counts": counts, **{f"ref_hits[{i}]": h for i, h in enumerate(ref_hits)},
                **{f"obs.{k}": v for k, v in obs.items()}}
    if fn == "walk._monotone_walk":
        root_hit, p2_hits, _, counts, _, _, obs = out
        return {"root_hit": root_hit, "counts": counts,
                **{f"p2_hits[{i}]": h for i, h in enumerate(p2_hits)},
                **{f"obs.{k}": v for k, v in obs.items()}}
    return {}


def _bound_bits(fn: str, args, kwargs, out) -> dict:
    """The bounds and survival masks a pass makes or reads, which the bf16
    cell must share with its fp32 sibling bit for bit."""
    if fn == "flat_index._fused_lower_bounds":
        return {"lb": out}
    if fn in ("flat_index._query_batched", "flat_index._query_batched_bf16"):
        return {"alive": out[1]}
    if fn in ("flat_index._knn_round", "flat_index._knn_round_bf16"):
        return {"alive": out[4]}
    if fn == "shard_index._knn_round":
        return {"alive": out[2]}
    if fn == "flat_index._dense_hit_mask":  # (metric_name, queries, data, valid, alive, t)
        return {"alive": args[4] if len(args) > 4 else kwargs["alive"]}
    return _clean_outputs(fn, out) if fn.startswith("walk.") else {}


@dataclasses.dataclass
class _Cell:
    name: str
    bf16: bool
    must: tuple = ()
    seeds: tuple = ()
    calls: Counter = dataclasses.field(default_factory=Counter)
    problems: dict = dataclasses.field(default_factory=dict)
    bits: dict = dataclasses.field(default_factory=dict)  # label -> set of digests
    bf16_seen: bool = False

    def problem(self, fn: str, check: str, detail: str) -> None:
        p = AuditProblem(self.name, fn, check, detail)
        self.problems.setdefault(p, None)


class _Watch(TorchDispatchMode):
    """Sees every operator a pass dispatches (``_Auditor.see``) in the thread
    that runs the pass."""

    def __init__(self, auditor: "_Auditor"):
        super().__init__()
        self.auditor = auditor

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # the innermost pass running is the one the operator belongs to
        self.auditor.see(self.auditor.local.stack[-1], func, args, kwargs, out)
        return out


class _Auditor:
    """The wrappers' shared state: the current cell, the taint set of the
    running pass, and (``shapes_only``) the batch shapes each pass saw."""

    def __init__(self, shapes_only: bool = False):
        self.shapes_only = shapes_only
        self.cell: _Cell | None = None
        self.local = threading.local()
        self.lock = threading.Lock()
        self.shapes: dict[tuple[str, str], set] = {}
        self.taint: set | None = None
        self.pending: list = []

    # -- wrappers ---------------------------------------------------------

    def wrap_pass(self, fn: str, original: Callable) -> Callable:
        def audited(*args, **kwargs):
            if self.shapes_only:
                q = _tensors(args)
                with self.lock:
                    entry = getattr(self.local, "entry", "-")
                    self.shapes.setdefault((entry, fn), set()).add(
                        int(q[0].shape[0]) if q else -1)
                return original(*args, **kwargs)
            cell = self.cell
            if cell is None:
                return original(*args, **kwargs)
            cell.calls[fn] += 1
            stack = getattr(self.local, "stack", [])
            if stack:  # nested in another pass, whose watch already sees it
                stack.append(fn)
                try:
                    out = original(*args, **kwargs)
                finally:
                    stack.pop()
                self.pending.append((fn, args, kwargs, out))
                return out
            out = self._run(cell, fn, original, args, kwargs)
            self.pending.append((fn, args, kwargs, out))
            self._settle(cell)
            return out

        audited.__audit_original__ = original
        return audited

    def wrap_kernel(self, original: Callable) -> Callable:
        def audited(*args, **kwargs):
            out = original(*args, **kwargs)
            if self.taint is not None and any(
                    _key(t) in self.taint for t in _tensors((args, kwargs))):
                self.taint.add(_key(out))
            return out

        audited.__audit_original__ = original
        return audited

    def wrap_entry(self, kind: str, original: Callable) -> Callable:
        def audited(*args, **kwargs):
            self.local.entry = kind
            with self.lock:
                self.shapes.setdefault((kind, "entry"), set()).add(len(args[1]))
            try:
                return original(*args, **kwargs)
            finally:
                self.local.entry = "-"

        audited.__audit_original__ = original
        return audited

    # -- one pass ---------------------------------------------------------

    def _run(self, cell: _Cell, fn: str, original: Callable, args, kwargs):
        """Run one top-level pass under the watch, and on a card under the
        sync debug mode as well; a pass that mode stopped runs again
        without it, so that the audit goes on."""
        arg_tensors = _tensors((args, kwargs))
        self.taint = {_key(s) for s in cell.seeds} if cell.bf16 else None
        if any(t.dtype == torch.bfloat16 for t in arg_tensors):
            self._bf16(cell, fn, "a bfloat16 argument")
        self.local.stack = [fn]
        try:
            if not any(t.is_cuda for t in arg_tensors):
                with _Watch(self):
                    return original(*args, **kwargs)
            torch.cuda.synchronize()
            mode = torch.cuda.get_sync_debug_mode()
            try:
                torch.cuda.set_sync_debug_mode("error")
                with _Watch(self):
                    return original(*args, **kwargs)
            except RuntimeError as e:
                if "synchroniz" not in str(e):
                    raise
                cell.problem(fn, "sync", str(e).strip().splitlines()[0])
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            self.pending.clear()
            self.taint = {_key(s) for s in cell.seeds} if cell.bf16 else None
            with _Watch(self):
                return original(*args, **kwargs)
        finally:
            self.local.stack = []

    def _settle(self, cell: _Cell) -> None:
        """Check the outputs of the pass that just returned, and of the
        passes nested in it, outside the watch."""
        pending, self.pending = self.pending, []
        for fn, args, kwargs, out in pending:
            for name, t in _clean_outputs(fn, out).items():
                if self.taint is not None and _key(t) in self.taint:
                    cell.problem(fn, "taint", f"{name} depends on the bf16 corpus "
                                 "(pruning must not depend on the precision)")
            for name, t in _bound_bits(fn, args, kwargs, out).items():
                cell.bits.setdefault(name, set()).add(_digest(t))
        self.taint = None

    # -- every operator of a pass -----------------------------------------

    def see(self, fn: str, func, args, kwargs, out) -> None:
        cell = self.cell
        op = f"aten.{func._overloadpacket.__name__}.{func._overloadname}"
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if _syncs(func, args, kwargs):
            cell.problem(fn, "sync", f"{op} waits for the host on a card")
        if any(t.dtype == _F64 for t in outs):
            cell.problem(fn, "f64", f"{op} makes a float64 tensor")
        if any(t.dtype == torch.bfloat16 for t in ins + outs):
            self._bf16(cell, fn, op)
        if self.taint is None:
            return
        tainted = any(_key(t) in self.taint for t in ins)
        if func._schema.is_mutable:
            # an in-place or out= write taints its target and never cleans it
            if tainted:
                schema = func._schema.arguments
                vals = {**{a.name: v for a, v in zip(schema, args)}, **kwargs}
                self.taint.update(
                    _key(vals[a.name]) for a in schema
                    if a.alias_info is not None and a.alias_info.is_write
                    and isinstance(vals.get(a.name), torch.Tensor))
                self.taint.update(_key(t) for t in outs)
            return
        for t in outs:  # a fresh output may reuse the block of a freed tainted one
            (self.taint.add if tainted else self.taint.discard)(_key(t))

    def _bf16(self, cell: _Cell, fn: str, where: str) -> None:
        cell.bf16_seen = True
        if not cell.bf16:
            cell.problem(fn, "bf16-present", f"bfloat16 in an fp32 cell ({where})")


class _CallWatch(TorchDispatchMode):
    """``_Watch`` for one call outside the pass matrix (``watch_call``): every
    operator it dispatches, in any thread (the backward's too), is seen as
    the call's own."""

    def __init__(self, auditor: "_Auditor", fn: str):
        super().__init__()
        self.auditor, self.fn = auditor, fn

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.auditor.see(self.fn, func, args, kwargs, out)
        return out


def watch_call(name: str, fn: Callable, *args, **kwargs) -> tuple[object, list[AuditProblem]]:
    """(``fn(*args, **kwargs)``, its problems): every operator the call
    dispatches is watched as a pass's are, for a host sync (the audit's
    operator list; on a card also ``set_sync_debug_mode("warn")``) and a
    float64 tensor.  bfloat16 is allowed.  The train step is audited so."""
    auditor = _Auditor()
    cell = _Cell(name, bf16=True)
    auditor.cell = cell
    cuda = any(t.is_cuda for t in _tensors((args, kwargs)))
    mode = torch.cuda.get_sync_debug_mode() if cuda else None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("warn")
            with _CallWatch(auditor, name):
                out = fn(*args, **kwargs)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(mode)
    for w in caught:
        if "synchroniz" in str(w.message):
            cell.problem(name, "sync", str(w.message).strip().splitlines()[0])
    return out, list(cell.problems)


# ---------------------------------------------------------------------------
# wrapping every namespace that holds a pass
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _patched(auditor: _Auditor, entries: bool = False):
    """Replace each pass and kernel wrapper (and with ``entries`` the
    public entry points) in every ``repro_torch`` module that holds it:
    ``shard_index`` imports its passes from ``flat_index``."""
    targets = []
    for modname, names in PASSES.items():
        home = importlib.import_module(modname)
        targets += [(getattr(home, n), auditor.wrap_pass(_label(modname, n), getattr(home, n)))
                    for n in names]
    for modname, names in KERNEL_WRAPPERS.items():
        home = importlib.import_module(modname)
        targets += [(getattr(home, n), auditor.wrap_kernel(getattr(home, n))) for n in names]
    if entries:
        home = importlib.import_module("repro_torch.core.flat_index")
        targets += [(getattr(home, n), auditor.wrap_entry(kind, getattr(home, n)))
                    for n, kind in _ENTRIES.items()]
    modules = [m for name, m in list(sys.modules.items())
               if name.split(".")[0] == "repro_torch" and m is not None]
    saved = []
    try:
        for original, wrapped in targets:
            for m in modules:
                for attr, value in list(vars(m).items()):
                    if value is original:
                        saved.append((m, attr, original))
                        setattr(m, attr, wrapped)
        yield
    finally:
        for m, attr, original in reversed(saved):
            setattr(m, attr, original)


@contextlib.contextmanager
def _in_cell(auditor: _Auditor, cell: _Cell, log: Callable[[str], None]):
    """Make ``cell`` current, then check what it ran."""
    log(f"audit {cell.name}")
    auditor.cell = cell
    try:
        yield cell
    finally:
        auditor.cell = None
    for fn in cell.must:
        if not cell.calls[fn]:
            cell.problem(fn, "coverage", "the pass never fired in this cell")
    if not cell.calls:
        cell.problem("-", "coverage", "no pass fired")
    if cell.bf16 and cell.calls and not cell.bf16_seen:
        cell.problem("-", "bf16-absent", "precision=bf16 but no bfloat16 in any pass")


def _bound_bits_agree(fp32: _Cell, bf16: _Cell) -> None:
    """The bf16 cell's bounds and survival masks are its fp32 sibling's."""
    for name in sorted(set(fp32.bits) | set(bf16.bits)):
        a, b = fp32.bits.get(name, set()), bf16.bits.get(name, set())
        if a != b:
            bf16.problem("-", "bound-bits", f"{name}: {len(b - a)} of the bf16 cell's "
                         f"{len(b)} differ from the fp32 cell's {len(a)}")


# ---------------------------------------------------------------------------
# the matrix
# ---------------------------------------------------------------------------


def _synth(metric: str, n: int, dim: int, seed: int):
    """Small clustered corpus and queries (isotropic gaussians defeat the
    planar bounds, so the adaptive path would never gather cells), on the
    simplex for the probability-space metrics: the reference's ``_synth``."""
    rng = np.random.default_rng(seed)
    n_clusters = 16
    centers = rng.normal(size=(n_clusters, dim)) * 8.0
    lab = np.repeat(np.arange(n_clusters), -(-n // n_clusters))[:n]
    db = (centers[lab] + rng.normal(size=(n, dim)) * 0.15).astype(np.float32)
    q = (centers[:8] + rng.normal(size=(8, dim)) * 0.15).astype(np.float32)
    if metric in ("jsd", "triangular"):
        db = np.abs(db) + 0.05
        db /= db.sum(axis=1, keepdims=True)
        q = np.abs(q) + 0.05
        q /= q.sum(axis=1, keepdims=True)
    return db, q


def _range_radii(metric: str, db, q, lb: np.ndarray) -> tuple[float, float]:
    """(narrow, wide) radii from the oracle's distances: narrow leaves few
    alive cells (the adaptive "torch" path gathers them), wide floods them
    (the dense pass), so both exact-phase realisations run.  Where the 2%
    quantile of the distances still leaves more cells alive than the
    adaptive path gathers (Triangular's looser bounds), the narrow radius
    is the 4% quantile of the bounds ``lb`` instead."""
    from repro_torch.core.flat_index import _DENSE_ALIVE_FRAC
    from repro_torch.core.npdist import pairwise_np

    d = pairwise_np(metric, q, db)
    narrow = float(np.quantile(d, 0.02))
    if (lb <= np.float32(narrow)).mean() > _DENSE_ALIVE_FRAC:
        narrow = float(np.quantile(lb, 0.04))
    return narrow, float(np.quantile(d, 0.6))


_LB = "flat_index._fused_lower_bounds"


def _bss_must(backend: str, realisation: str, bf16: bool) -> tuple:
    if backend == "cuda":
        return (_LB, "flat_index._query_batched_bf16", "flat_index._knn_round_bf16") if bf16 \
            else (_LB, "flat_index._query_batched", "flat_index._knn_round")
    if realisation == "dense":
        return (_LB, "flat_index._query_batched_bf16", "flat_index._knn_round_bf16") if bf16 \
            else (_LB, "flat_index._dense_hit_mask", "flat_index._knn_round")
    if bf16:
        return (_LB, "flat_index._cells_exact_bf16", "flat_index._query_batched_bf16",
                "flat_index._knn_round_cells_bf16", "flat_index._knn_round_cells")
    return (_LB, "flat_index._cells_exact", "flat_index._dense_hit_mask",
            "flat_index._knn_round_cells")


def _sharded_must(backend: str, bf16: bool) -> tuple:
    exact = ("flat_index._query_batched_bf16" if bf16 else
             "flat_index._query_batched" if backend == "cuda" else "flat_index._dense_hit_mask")
    return (_LB, exact, "shard_index._knn_round", "shard_index._merge_top_k")


def _mesh(device: torch.device, n: int):
    from repro_torch.parallel import ShardMesh, local_mesh

    return local_mesh(n) if device.type == "cuda" else ShardMesh(("cpu",) * n)


def run_audit(full: bool = False, device=None,
              log: Callable[[str], None] | None = None) -> tuple[list[AuditProblem], list]:
    """Drive the engine matrix on ``device`` (default: the CUDA device; raises
    without one, as ``build_bss`` does) and check every pass.

    ``full=False`` audits the l2 column: every entry point, backend,
    realisation and precision still runs.  ``full=True`` runs all four
    supermetrics.  Backends: ``"torch"``, plus ``"cuda"`` on a card.
    Returns (problems, cells): each cell's name, the passes it ran and its
    problems."""
    from repro_torch.core import flat_index, lrt, tree
    from repro_torch.forest import encode_monotone, encode_tree
    from repro_torch.forest.walk import forest_range_search, monotone_range_search
    from repro_torch.parallel import shard_index

    device = flat_index.resolve_device(device)
    log = log or (lambda s: None)
    metrics = AUDIT_METRICS if full else ("l2",)
    backends = ("cuda", "torch") if device.type == "cuda" else ("torch",)
    auditor = _Auditor()
    cells: list[_Cell] = []

    def run(name, bf16, must, seeds, drive):
        cell = _Cell(name, bf16, must, seeds)
        with _in_cell(auditor, cell, log):
            drive()
        cells.append(cell)
        return cell

    with _patched(auditor):
        for metric in metrics:
            db, q = _synth(metric, 512, 8, seed=3)
            idx = flat_index.build_bss(metric, db, n_pivots=6, n_pairs=8, block=32, seed=5,
                                       device=device)
            t_narrow, t_wide = _range_radii(metric, db, q, flat_index.bss_lower_bounds(idx, q))
            # the adaptive "torch" path at a pruning and at a flooding radius
            # runs both exact-phase realisations; "cuda" ignores realisation
            legs = [(b, r) for b in backends
                    for r in (("dense",) if b == "cuda" else ("adaptive", "dense"))]
            for backend, realisation in legs:
                pair = []
                for precision in ("fp32", "bf16"):
                    opts = EngineOpts(backend=backend, realisation=realisation,
                                      precision=precision)
                    bf16 = precision == "bf16"

                    def drive(opts=opts):
                        for t in (t_narrow, t_wide):
                            flat_index.bss_query_batched(idx, q, t, opts=opts)
                        flat_index.bss_knn_batched(idx, q, 3, r0=t_narrow, opts=opts)

                    pair.append(run(f"bss/{metric}/{backend}-{realisation}/{precision}", bf16,
                                    _bss_must(backend, realisation, bf16),
                                    (idx.device_bf16,) if bf16 else (), drive))
                _bound_bits_agree(*pair)

            for n_shards in (1, 2):
                sidx = shard_index.shard_bss(idx, _mesh(device, n_shards))
                for backend in backends:
                    pair = []
                    for precision in ("fp32", "bf16"):
                        opts = EngineOpts(backend=backend, precision=precision)
                        bf16 = precision == "bf16"

                        def drive(opts=opts):
                            shard_index.sharded_query_batched(sidx, q, t_narrow, opts=opts)
                            shard_index.sharded_knn_batched(sidx, q, 3, opts=opts)

                        pair.append(run(f"sharded{n_shards}/{metric}/{backend}/{precision}",
                                        bf16, _sharded_must(backend, bf16),
                                        tuple(sidx.data16) if bf16 else (), drive))
                    _bound_bits_agree(*pair)

            walks = (
                ("forest", "walk._forest_walk", forest_range_search,
                 encode_tree(tree.build_tree("hpt_random_fixed", metric, db, seed=7),
                             device=device)),
                ("monotone", "walk._monotone_walk", monotone_range_search,
                 encode_monotone(lrt.build_monotone_tree("closer", "far", metric, db, seed=7),
                                 device=device)),
            )
            for kind, fn, search, enc in walks:
                for backend in backends:
                    pair = []
                    for precision in ("fp32", "bf16"):
                        opts = EngineOpts(backend=backend, precision=precision)
                        bf16 = precision == "bf16"
                        pair.append(run(
                            f"{kind}/{metric}/{backend}/{precision}", bf16, (fn,),
                            (enc.leaf_bf16,) if bf16 else (),
                            lambda search=search, enc=enc, opts=opts: search(
                                enc, q, t_narrow, opts=opts)))
                    _bound_bits_agree(*pair)

    return [p for c in cells for p in c.problems], [
        {"cell": c.name, "passes": dict(c.calls), "problems": len(c.problems)} for c in cells]


def audit_index(index, queries: np.ndarray, t: float) -> tuple[list[AuditProblem], list]:
    """One batch of ``queries`` on a built single-device ``index`` on a card,
    straight through its ``"cuda"`` passes: the range pass and one kNN round
    of ``AUDIT_KNN_K`` (at the initial radius ``bss_knn_batched`` would
    take) in fp32 and in bf16, each held to
    ``run_audit``'s checks, the bf16 bounds and ``alive`` to the fp32 ones.
    Returns (problems, cells) as ``run_audit``."""
    import math

    from repro_torch.core import flat_index as fi
    from repro_torch.kernels.tiles import TILE_BQ

    auditor = _Auditor()
    device = index.torch_device
    metric = fi._engine_metric(index.metric_name)
    q = torch.as_tensor(fi._engine_queries(index.metric_name, queries), device=device)
    t_dev = torch.full((q.shape[0],), t, dtype=torch.float32, device=device)
    dev = index.device
    k = AUDIT_KNN_K
    kw = dict(block=index.block, bq=TILE_BQ, backend="cuda")
    data16 = index.device_bf16
    eps = torch.tensor(index.bf16_margin(), dtype=torch.float32, device=device)
    j0 = min(index.n_blocks - 1, max(0, math.ceil(2 * k / index.block) - 1))
    cells = []
    with _patched(auditor):
        for precision in ("fp32", "bf16"):
            bf16 = precision == "bf16"
            cell = _Cell(f"index/{index.metric_name}/cuda/{precision}", bf16,
                         (_LB, f"flat_index._query_batched{'_bf16' * bf16}",
                          f"flat_index._knn_round{'_bf16' * bf16}"),
                         (data16,) if bf16 else ())
            with _in_cell(auditor, cell, lambda s: None):
                if bf16:
                    fi._query_batched_bf16(metric, q, t_dev, dev, data16, eps, **kw)
                else:
                    fi._query_batched(metric, q, t_dev, dev, **kw)
                lb = fi._fused_lower_bounds(metric, q, dev.pivots, dev.pairs, dev.deltas,
                                            dev.boxes, backend="cuda")
                radii = torch.sort(lb, dim=1).values[:, j0].contiguous()
                if bf16:
                    fi._knn_round_bf16(metric, q, radii, lb, dev, data16, eps, k=k, **kw)
                else:
                    fi._knn_round(metric, q, radii, lb, dev, k=k, **kw)
            cells.append(cell)
        _bound_bits_agree(*cells)
    return [p for c in cells for p in c.problems], [
        {"cell": c.name, "passes": dict(c.calls), "problems": len(c.problems)} for c in cells]


# ---------------------------------------------------------------------------
# bounded rebuilds through the serving front
# ---------------------------------------------------------------------------


def audit_rebuilds(device=None,
                   sizes=tuple(range(1, 11))) -> tuple[list[AuditProblem], dict]:
    """Replay a stream of ``sizes`` waves (each n range and n kNN requests)
    through ``ServingFront`` with ``REBUILD_BUCKETS``, then append rows (a new
    generation) and replay it again.  Every pass must see exactly one batch
    shape per bucket the stream touches, per entry point, and every kernel
    library must have loaded at most once.  Returns (problems, info)."""
    from repro_torch.core import flat_index
    from repro_torch.core.backends import bucket_for
    from repro_torch.kernels import _build
    from repro_torch.serve.front import ServingFront

    device = flat_index.resolve_device(device)
    db, q = _synth("l2", 320, 8, seed=11)
    index = flat_index.build_bss("l2", db, n_pivots=6, n_pairs=8, block=64, seed=13,
                                 device=device)
    extra, _ = _synth("l2", 64, 8, seed=12)
    buckets = REBUILD_BUCKETS
    # the front splits a wave into top-bucket chunks plus a remainder
    touched: set[int] = set()
    for n in sizes:
        while n > 0:
            chunk = min(n, buckets[-1])
            touched.add(bucket_for(chunk, buckets))
            n -= chunk
    qbig = np.concatenate([q] * (max(sizes) // len(q) + 1))
    auditor = _Auditor(shapes_only=True)
    generations = []
    with _patched(auditor, entries=True):
        for wave in range(2):
            generations.append(int(index.generation))
            for n in sizes:
                # every request queued before the driver starts: the batches
                # are the ladder's, not the scheduler's
                with ServingFront(index, buckets=buckets, max_delay_s=0.01,
                                  start=False) as front:
                    futs = [front.submit(v, "range", t=0.5 + 0.01 * i)
                            for i, v in enumerate(qbig[:n])]
                    futs += [front.submit(v, "knn", k=3) for v in qbig[:n]]
                    front.start()
                    for f in futs:
                        f.result(timeout=300)
                    if wave == 0 and n == sizes[-1]:
                        front.append(extra)  # the generation swap
                        index = front.index
    problems = []
    shapes = {f"{entry}/{fn}": sorted(s) for (entry, fn), s in sorted(auditor.shapes.items())}
    for (entry, fn), seen in sorted(auditor.shapes.items()):
        if seen != touched:
            problems.append(AuditProblem(
                "serving/rebuilds", f"{entry}/{fn}", "shapes",
                f"batch shapes {sorted(seen)}, the ladder {list(buckets)} predicts "
                f"{sorted(touched)} for sizes {min(sizes)}..{max(sizes)}"))
    for entry in _ENTRIES.values():
        if not any(e == entry and fn != "entry" for e, fn in auditor.shapes):
            problems.append(AuditProblem("serving/rebuilds", entry, "coverage",
                                         "no pass fired for this entry point"))
    loads = {name: _build.load_count(name) for name in _build.SOURCES}
    for name, n in loads.items():
        if n > 1:
            problems.append(AuditProblem("serving/rebuilds", name, "loads",
                                         f"library loaded {n} times"))
    info = {"buckets": list(buckets), "sizes": list(sizes), "touched": sorted(touched),
            "generations": generations, "shapes": shapes, "loads": loads,
            "device": str(device)}
    return problems, info

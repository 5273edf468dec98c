"""Builds the port's CUDA C++ sources and loads them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers, so
``nvcc`` takes seconds, not minutes) and is compiled on first use into its
own shared library under ``build/repro_torch/`` at the root of the
checkout::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o <name>-<hash>.so <name>.cu

The file name carries a hash of the source and the flags, so an unchanged
tree never rebuilds and an edited source never loads a stale library.
``build()`` starts one ``nvcc`` per missing library, all at once, and keeps
each compiler log (``-Xptxas=-v``: registers, shared memory, spills) beside
its library.  Nothing is compiled when this module is imported.

A serving front launches kernels from its own driver thread while client
threads may call the engines directly, so one lock covers the load of a
library (``library``: each source is built and loaded once per process,
which ``load_count`` reports) and another every wrapper's launch count
(``count_launch``), so a launch never waits for another source's build.

``load_count`` is what a serving front's compile guard watches.  Loading a
library is the port's only form of a rebuild, and a library is loaded
once per process, so the count reads 0 before the first use and 1 after
it: the guard only catches a library loaded again within the process.
It is not a check on ``nvcc`` or on the card's JIT.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "build", "library", "check", "compiler_log", "load_count",
           "count_launch", "reset_counts"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

SOURCES = ("pairwise_dist", "planar_exclusion", "prob_dist")

_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# No flag changes rounding: a kernel whose bits must equal its plain version
# spells each rounding step as an intrinsic (__fmul_rn, __fadd_rn, ...),
# which nvcc never contracts into an FMA.  Never --use_fast_math: division
# and sqrtf stay IEEE and fp32 denormals are kept.

_LIBS: dict[str, ctypes.CDLL] = {}
# times each source's library was built or loaded in this process
_LOADS: dict[str, int] = dict.fromkeys(SOURCES, 0)
_LOCK = threading.Lock()  # build and load
_COUNT_LOCK = threading.Lock()  # launch counts


def _target(name: str) -> Path:
    digest = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    return _BUILD / f"{name}-{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in filter(None, (home, "/usr/local/cuda")):
        cand = Path(root) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels cannot be built"
    )


def build(names=SOURCES) -> float:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together.  Returns the seconds it took;
    raises with the compiler's output if any build fails."""
    start = time.perf_counter()
    jobs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - start


def compiler_log(name: str) -> str:
    """The ``nvcc`` output kept beside ``name``'s library ('' if it was
    built by another tree state or not yet)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first use,
    with each C entry point in ``signatures`` (function name -> ctypes
    argument types) declared to return ``int`` (a ``cudaError_t``).  Safe
    to call from several threads: the first caller builds and loads, the
    others wait for it."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
            _LOADS[name] += 1
    return lib


def load_count(name: str) -> int:
    """How many times ``csrc/<name>.cu``'s library was built or loaded in
    this process: 1 once it serves, and it never grows after that."""
    return _LOADS[name]


def count_launch(counts: dict[str, int], entry: str) -> None:
    """Add one launch of ``entry`` to a wrapper's count, exactly even when
    several threads launch at once."""
    with _COUNT_LOCK:
        counts[entry] += 1


def reset_counts(counts: dict[str, int]) -> None:
    """Zero every entry of a wrapper's launch count."""
    with _COUNT_LOCK:
        for entry in counts:
            counts[entry] = 0


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch:
    too many threads, too much shared memory, no image for this card)."""
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: cudaError_t {err}")

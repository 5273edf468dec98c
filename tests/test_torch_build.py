"""Loading the port's kernel libraries and counting launches from several
threads (``repro_torch.kernels._build``), on the CPU with a stubbed
builder: no ``nvcc`` and no card are needed.

A serving front launches kernels from its driver thread while client
threads may call the engines directly, so the first use of a source can
come from two threads at once.  Each source must be built and loaded once,
and the launch counts that ``chip_smoke.py`` reads must stay exact.
"""

from __future__ import annotations

import sys
import threading
import time
import types

import pytest
import torch

from repro_torch.kernels import _build, launch_counts, pairwise_dist, planar_exclusion
from repro_torch.kernels import reset_launch_counts

THREADS = 8


class _FakeLib:
    def __init__(self, path):
        self.path = path


def _run_threads(fn, n=THREADS):
    barrier = threading.Barrier(n)
    errors = []

    def body(i):
        try:
            barrier.wait(timeout=30)
            fn(i)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == []


def test_library_builds_and_loads_each_source_once_under_8_threads(monkeypatch):
    builds: list[str] = []

    def slow_build(names=_build.SOURCES):
        builds.extend(names)
        time.sleep(0.05)  # a window for a second thread to race the first
        return 0.05

    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", _FakeLib)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_LOADS", dict.fromkeys(_build.SOURCES, 0))
    libs: dict[str, set] = {name: set() for name in _build.SOURCES}

    def load_all(i):
        for name in _build.SOURCES[i % 3:] + _build.SOURCES[:i % 3]:
            libs[name].add(id(_build.library(name, {})))

    _run_threads(load_all)
    assert sorted(builds) == sorted(_build.SOURCES)
    assert all(len(ids) == 1 for ids in libs.values())
    assert {name: _build.load_count(name) for name in _build.SOURCES} == \
        dict.fromkeys(_build.SOURCES, 1)
    _run_threads(load_all)  # loaded libraries are served without a rebuild
    assert len(builds) == len(_build.SOURCES)
    assert _build.load_count("prob_dist") == 1


class _YieldingCounts(dict):
    """A launch count that lets another thread run between reading an
    entry and writing it back, so an unlocked ``counts[entry] += 1``
    loses launches."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


class _StubLib:
    """A loaded library whose every C entry point returns cudaSuccess."""

    def __getattr__(self, entry):
        return lambda *args: 0


class _NoDevice:
    def __init__(self, device):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_wrapper_launch_counts_stay_exact_under_8_threads(monkeypatch):
    """Both wrappers' ``_launch``, with stubbed C entry points and CPU
    tensors, from 8 threads: every launch is counted once."""
    monkeypatch.setattr(_build, "library", lambda name, signatures: _StubLib())
    monkeypatch.setattr(torch.cuda, "device", _NoDevice)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(pairwise_dist, "LAUNCHES",
                        _YieldingCounts(dict.fromkeys(pairwise_dist.LAUNCHES, 0)))
    monkeypatch.setattr(planar_exclusion, "LAUNCHES",
                        _YieldingCounts(dict.fromkeys(planar_exclusion.LAUNCHES, 0)))
    per_thread = 200
    entries = (("pairwise_dist", "masked_pairwise_l2"), ("prob_dist", "pairwise_jsd"))
    out = torch.empty(4, 4)
    planes = (torch.zeros(4, 3), torch.zeros(3), torch.zeros(2, 3, 4))

    def launch(i):
        source, entry = entries[i % 2]
        for _ in range(per_thread):
            pairwise_dist._launch(source, entry, out)
            planar_exclusion._launch("planar_lower_bound", planes, (4, 2, 3), 4, 2)

    _run_threads(launch)
    counts = launch_counts()
    assert counts["masked_pairwise_l2"] == counts["pairwise_jsd"] == THREADS // 2 * per_thread
    assert counts["planar_lower_bound"] == THREADS * per_thread
    assert sum(counts.values()) == 2 * THREADS * per_thread
    reset_launch_counts()
    assert set(launch_counts().values()) == {0}


def test_unknown_entry_is_not_counted():
    with pytest.raises(KeyError):
        _build.count_launch(pairwise_dist.LAUNCHES, "no_such_kernel")
    assert "no_such_kernel" not in launch_counts()

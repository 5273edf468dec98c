"""The port's copies of framework-neutral reference modules stay equal to
their originals: the same code (one AST, once ``repro_torch.`` reads
``repro.``) and the same results, bit for bit, on seeded inputs."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro.core import constants as r_constants
from repro.core import exclusion as r_exclusion
from repro.core import npdist as r_npdist
from repro.core import projection as r_projection
from repro.core import refpoints as r_refpoints
from repro.data import metricsets as r_metricsets
from repro.kernels import tiles as r_tiles
from repro.obs import registry as r_registry
from repro.obs import schema as r_schema
from repro.obs import trace as r_trace
from repro.serve import queue as r_queue
from repro_torch.core import constants as t_constants
from repro_torch.core import exclusion as t_exclusion
from repro_torch.core import npdist as t_npdist
from repro_torch.core import projection as t_projection
from repro_torch.core import refpoints as t_refpoints
from repro_torch.data import metricsets as t_metricsets
from repro_torch.kernels import tiles as t_tiles
from repro_torch.obs import registry as t_registry
from repro_torch.obs import schema as t_schema
from repro_torch.obs import trace as t_trace
from repro_torch.serve import queue as t_queue

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

COPIES = [
    "core/constants.py",
    "core/npdist.py",
    "core/refpoints.py",
    "core/tree.py",
    "core/lrt.py",
    "kernels/tiles.py",
    "obs/schema.py",
    "obs/buckets.py",
    "obs/registry.py",
    "obs/spans.py",
    "obs/trace.py",
    "obs/export.py",
    "serve/queue.py",
    "data/metricsets.py",
]

# functions copied out of a reference module that the port otherwise
# rewrites: (module path, "Class.function" or "function")
COPIED_FUNCTIONS = [
    ("models/gnn.py", "PNAModel.partition_edges"),
]

NP_METRICS = ["l2", "cosine", "jsd", "triangular", "l1", "linf", "l1^0.5",
              "triangular^0.25"]


@pytest.mark.parametrize("relpath", COPIES)
def test_copy_is_the_original_code(relpath):
    orig = (SRC / "repro" / relpath).read_text()
    copy = (SRC / "repro_torch" / relpath).read_text()
    assert "repro_torch" not in orig
    assert ast.dump(ast.parse(orig)) == ast.dump(
        ast.parse(copy.replace("repro_torch.", "repro."))
    )


def _function_node(relpath: str, qualname: str, pkg: str) -> ast.AST:
    tree = ast.parse((SRC / pkg / relpath).read_text())
    for part in qualname.split("."):
        tree = next(n for n in ast.iter_child_nodes(tree)
                    if isinstance(n, (ast.ClassDef, ast.FunctionDef)) and n.name == part)
    return tree


@pytest.mark.parametrize("relpath, qualname", COPIED_FUNCTIONS)
def test_copied_function_is_the_original_code(relpath, qualname):
    """A host function the port copies (not the file around it) is the
    reference's code, decorators and docstring included."""
    orig = _function_node(relpath, qualname, "repro")
    copy = _function_node(relpath, qualname, "repro_torch")
    assert ast.dump(orig) == ast.dump(copy)


def _points(seed, n, dim, prob=True):
    rng = np.random.default_rng(seed)
    x = rng.random((n, dim)) + 1e-3
    return x / x.sum(axis=1, keepdims=True) if prob else x


@pytest.mark.parametrize("metric", NP_METRICS)
def test_npdist_bit_equal(metric):
    x, y = _points(1, 13, 9), _points(2, 21, 9)
    np.testing.assert_array_equal(
        t_npdist.pairwise_np(metric, x, y), r_npdist.pairwise_np(metric, x, y)
    )
    np.testing.assert_array_equal(  # 1-D operands and float32 inputs
        t_npdist.pairwise_np(metric, x[0].astype(np.float32), y),
        r_npdist.pairwise_np(metric, x[0].astype(np.float32), y),
    )


def test_npdist_power_registration_and_counter():
    assert t_npdist.register_power("jsd", 0.5) == r_npdist.register_power("jsd", 0.5)
    for bad in ("l1^0.7", "l1^0.50", "nope"):
        with pytest.raises(KeyError):
            t_npdist.pairwise_np(bad, np.ones((1, 2)), np.ones((1, 2)))
    x, y = _points(3, 5, 4), _points(4, 7, 4)
    tc, rc = t_npdist.DistanceCounter("l2", 5), r_npdist.DistanceCounter("l2", 5)
    for c in (tc, rc):
        c.pairwise(np.array([0, 3]), x[[0, 3]], y)
        c.pairwise(np.array([1]), x[[1]], y[0])
    np.testing.assert_array_equal(tc.per_query, rc.per_query)
    assert tc.mean == rc.mean


@pytest.mark.parametrize("metric", ["l2", "jsd", "l1^0.5"])
def test_refpoints_bit_equal(metric):
    data = _points(5, 300, 8)
    for mod in ("select_fft",):
        got = getattr(t_refpoints, mod)(metric, data, 7, np.random.default_rng(9),
                                        sample_cap=100)
        want = getattr(r_refpoints, mod)(metric, data, 7, np.random.default_rng(9),
                                         sample_cap=100)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        t_refpoints.select_random(np.random.default_rng(1), 50, 9),
        r_refpoints.select_random(np.random.default_rng(1), 50, 9),
    )
    assert t_refpoints.select_maxsep_pair(
        metric, data, np.random.default_rng(2), n_pairs=50
    ) == r_refpoints.select_maxsep_pair(metric, data, np.random.default_rng(2), n_pairs=50)
    assert t_refpoints.select_outlier(
        metric, data, np.random.default_rng(3), sample_cap=64
    ) == r_refpoints.select_outlier(metric, data, np.random.default_rng(3), sample_cap=64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_projection_numpy_branch_bit_equal(dtype):
    rng = np.random.default_rng(6)
    d1 = (np.abs(rng.normal(size=(40, 12))) + 0.1).astype(dtype)
    d2 = (np.abs(rng.normal(size=(40, 12))) + 0.1).astype(dtype)
    delta = (np.abs(rng.normal(size=(1, 12))) + 0.3).astype(dtype)
    delta[0, [2, 7]] = [0.0, 5e-7]  # a duplicate and a near-duplicate plane
    got = t_projection.project(d1, d2, delta, xp=np)
    want = r_projection.project(d1, d2, delta, xp=np)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        t_projection.project_x(d1, d2, delta, xp=np),
        r_projection.project_x(d1, d2, delta, xp=np),
    )
    box = rng.normal(size=(40, 12, 4)).astype(dtype)
    np.testing.assert_array_equal(
        t_projection.point_to_box(got[0], got[1], box, xp=np),
        r_projection.point_to_box(want[0], want[1], box, xp=np),
    )
    theta = rng.uniform(-1.5, 1.5, size=(1, 12)).astype(dtype)
    h = rng.normal(size=(1, 12)).astype(dtype)
    for g, w in zip(t_projection.rotate(got[0], got[1], theta, h, xp=np),
                    r_projection.rotate(want[0], want[1], theta, h, xp=np)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        t_projection.planar_lower_bound(got[0], got[1], d1, d2, xp=np),
        r_projection.planar_lower_bound(want[0], want[1], d1, d2, xp=np),
    )


@pytest.mark.parametrize("mech", ["hyperbolic", "hilbert"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_exclusion_numpy_branch_bit_equal(dtype, mech):
    """The port's exclusion predicates with ``xp=numpy`` (the host walks'
    branch) are the reference's bit for bit, duplicate refs (delta 0), NaN
    centre witnesses and +inf padded slots included."""
    rng = np.random.default_rng(17)
    nq, nodes, k = 9, 7, 5
    dq = np.abs(rng.normal(size=(nq, nodes, k))).astype(dtype)
    dq[:, 2, 4] = np.inf  # a padded slot
    ref = np.abs(rng.normal(size=(nodes, k, k))).astype(dtype)
    ref = ref + np.swapaxes(ref, 1, 2)
    ref[:, np.arange(k), np.arange(k)] = 0
    ref[3, 0, 1] = ref[3, 1, 0] = 0.0  # duplicate refs
    cover = np.abs(rng.normal(size=(1, nodes, k))).astype(dtype)
    centre = np.abs(rng.normal(size=(nodes, k))).astype(dtype)
    centre[1] = np.nan  # the witness disabled at build
    dcent = np.abs(rng.normal(size=(nq, nodes))).astype(dtype)
    dcent[0] = np.nan  # no centre in hand (the root)
    t = dtype(0.3)
    for fn, args in (
        ("cover_radius_exclusion_mask", (dq, cover, t)),
        ("hyperplane_exclusion_mask", (dq, ref, t, mech)),
        ("centre_witness_exclusion_mask", (dq, dcent, centre, t, mech)),
        ("hyperbolic_margin", (dq[..., 0], dq[..., 1])),
        ("hilbert_margin", (dq[..., 0], dq[..., 1], ref[None, :, 0, 2])),
        ("planar_margin", (dq[..., 0], dq[..., 1], centre[:, 0], cover[0, :, 0],
                           0.6, 0.8, 0.1)),
    ):
        got = getattr(t_exclusion, fn)(*args, xp=np)
        want = getattr(r_exclusion, fn)(*args, xp=np)
        assert got.dtype == want.dtype, fn
        np.testing.assert_array_equal(got, want, err_msg=fn)
    part = dict(theta=0.3, h=0.2, nx=0.6, ny=0.8, split=0.05)
    np.testing.assert_array_equal(
        t_exclusion.PlanarPartition(**part).separation(dq[..., 0], dq[..., 1], xp=np),
        r_exclusion.PlanarPartition(**part).separation(dq[..., 0], dq[..., 1], xp=np),
    )
    assert (t_exclusion.HILBERT, t_exclusion.HYPERBOLIC) == (
        r_exclusion.HILBERT, r_exclusion.HYPERBOLIC)


@pytest.mark.parametrize("gen,kw", [
    ("euc10", dict(n=500)),
    ("colors_surrogate", dict(n=700, dim=24)),
    ("nasa_surrogate", dict(n=600, dim=20)),
    ("topics_surrogate", dict(n=500, dim=16)),
])
def test_metricsets_generators_bit_equal(gen, kw):
    got = getattr(t_metricsets, gen)(seed=4, **kw)
    want = getattr(r_metricsets, gen)(seed=4, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for g, w in zip(t_metricsets.split_queries(got, 0.1, seed=2, max_queries=30),
                    r_metricsets.split_queries(want, 0.1, seed=2, max_queries=30)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("metric,sel", [("l2", 1e-3), ("cosine", 1e-2), ("jsd", 5e-3)])
def test_calibrate_threshold_bit_equal(metric, sel):
    data = t_metricsets.colors_surrogate(900, dim=16, seed=3)
    assert t_metricsets.calibrate_threshold(
        metric, data, sel, n_query_sample=50, n_data_sample=400
    ) == r_metricsets.calibrate_threshold(
        metric, data, sel, n_query_sample=50, n_data_sample=400
    )
    assert set(t_metricsets.DATASETS) == set(r_metricsets.DATASETS)
    assert set(t_metricsets.PROB_DATASETS) == set(r_metricsets.PROB_DATASETS)


def test_schema_normalise_and_validate_equal():
    assert t_schema.METRIC_NAMES == r_schema.METRIC_NAMES
    assert t_schema.SCHEMA_VERSION == r_schema.SCHEMA_VERSION

    def stats():
        return {"per_query_dists": np.array([3, 4]), "dists_per_query": 3.5}

    got = t_schema.normalise_stats(
        stats(), engine="bss", kind="range", backend="cuda", n_queries=2,
        excluded={"hilbert": [1, 2]},
    )
    want = r_schema.normalise_stats(
        stats(), engine="bss", kind="range", backend="cuda", n_queries=2,
        excluded={"hilbert": [1, 2]},
    )
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["excluded"]["hilbert"], want["excluded"]["hilbert"])
    assert got["excluded"]["hilbert"].dtype == np.int64
    assert t_schema.validate_stats(got) == r_schema.validate_stats(want) == []
    broken = dict(got, kind="nope", n_queries=3)
    assert t_schema.validate_stats(broken) == r_schema.validate_stats(broken)
    with pytest.raises(ValueError):
        t_schema.check_stats(broken)


def test_constants_and_tiles_equal():
    assert t_constants.MIN_DELTA == r_constants.MIN_DELTA
    assert t_constants.DEGENERATE_DELTA == r_constants.DEGENERATE_DELTA
    for name in ("TILE_BQ", "TILE_BLOCK", "TILE_KCHUNK", "TILE_VPU"):
        assert getattr(t_tiles, name) == getattr(r_tiles, name)
    env = dict(os.environ, REPRO_TILE_BQ="64", REPRO_TILE_BLOCK="256")
    out = subprocess.run(
        [sys.executable, "-c",
         "from repro_torch.kernels import tiles; print(tiles.TILE_BQ, tiles.TILE_BLOCK)"],
        env=env, capture_output=True, text=True, check=True,
    )
    assert out.stdout.split() == ["64", "256"]


def test_obs_and_queue_copies_give_the_same_results():
    """The copied registry, trace and queue helpers produce the reference's
    output on the same inputs: percentiles, snapshot, exposition, and a
    trace event list."""
    xs = np.random.default_rng(7).random(37).tolist()
    for p in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert t_queue.nearest_rank(xs, p) == r_queue.nearest_rank(xs, p)

    def fill(mod):
        reg = mod.MetricsRegistry()
        reg.counter("engine/dists", engine="bss", kind="range").inc(5)
        reg.gauge("index/generation").set(3)
        h = reg.histogram("serve/engine_s", kind="knn")
        for v in xs:
            h.observe(v * 1e-3)
        return reg

    t_reg, r_reg = fill(t_registry), fill(r_registry)
    assert t_reg.snapshot() == r_reg.snapshot()
    assert t_reg.to_prometheus() == r_reg.to_prometheus()
    ev = dict(name="dispatch/engine", start_s=1.25, dur_s=0.5, tid=0, cat="dispatch",
              args={"n": 1})
    assert t_trace.complete_event(**ev) == r_trace.complete_event(**ev)

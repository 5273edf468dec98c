"""The port's recsys family (``repro_torch.models.recsys``, ``configs``)
against the JAX package's, on the CPU.

Parameters are the JAX package's own (``init_params(PRNGKey(0))``), carried
over by ``load_jax_params``; batches are drawn with numpy from a seed and
given to both.  The reduced models (vocab 997, float32) must agree within
1e-5 in every forward and loss: both run IEEE float32, but XLA and torch
sum a product in another order.  A bfloat16 tree (the full two-tower
widths at vocab 31) crosses through its 16-bit pattern and must agree
within 2e-2 abs with every row's cosine at least 0.999: both round every
layer to bf16, each in its own order.  ``forward_retrieval_pruned`` is held
to a float64 transcription of its keys, to its own lexsort and to JAX's
block choice (differences only at ties on the budget's edge, counted).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jcommon
from repro.configs import recsys_archs as jarchs
from repro.configs.registry import registry as jax_registry
from repro_torch.configs import common
from repro_torch.configs import recsys_archs
from repro_torch.configs.registry import NOT_PORTED, all_cells, get_arch, registry
from repro_torch.core import flat_index
from repro_torch.models import recsys as R

ARCHS = ["wide-deep", "din", "two-tower-retrieval", "dlrm-rm2"]
TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = {jnp.int32: torch.int32, jnp.bool_: torch.bool, jnp.float32: torch.float32}


def _pair(arch: str):
    """(jax model, jax params, port model holding the same parameters, cfg)."""
    jm, jcfg, _ = jax_registry()[arch].make_reduced()
    tm, tcfg, _ = registry()[arch].make_reduced()
    params = jm.init_params(jax.random.PRNGKey(0))
    R.load_jax_params(tm, jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm, tcfg


def _batch(cfg, seed: int, batch: int = 16, candidates=None, train=True) -> dict:
    """A numpy batch of the cell's spec: ids below vocab, all-valid masks
    but the last history position, normal dense features, 0/1 labels."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, spec in common.recsys_batch_spec(cfg, batch, candidates, train).items():
        if spec.dtype == torch.int32:
            out[key] = rng.integers(0, cfg.vocab, size=spec.shape).astype(np.int32)
        elif spec.dtype == torch.bool:
            v = np.ones(spec.shape, bool)
            v[:, -1] = False
            out[key] = v
        elif key == "label":
            out[key] = (rng.random(spec.shape) < 0.5).astype(np.float32)
        else:
            out[key] = rng.normal(size=spec.shape).astype(np.float32)
    return out


def _torch(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_forward_and_loss_match_jax(arch):
    jm, params, tm, cfg = _pair(arch)
    batch = _batch(cfg, seed=1)
    np.testing.assert_allclose(_np(tm.forward(_torch(batch))),
                               np.asarray(jm.forward(params, batch)), **TOL)
    got = common.loss_for("recsys", tm)(_torch(batch))
    want = jcommon.loss_for("recsys", jm)(params, batch)
    assert got.shape == ()
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert torch.equal(registry()[arch].loss_fn(tm)(_torch(batch)), got)


@pytest.mark.parametrize("tower, ids", [("user_embed", "user_ids"), ("item_embed", "item_ids")])
def test_two_tower_towers_match_jax(tower, ids):
    jm, params, tm, cfg = _pair("two-tower-retrieval")
    x = _batch(cfg, seed=2, batch=64)[ids]
    got = _np(getattr(tm, tower)(torch.as_tensor(x)))
    np.testing.assert_allclose(got, np.asarray(getattr(jm, tower)(params, x)), **TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


def test_two_tower_retrieval_forward_matches_jax():
    """``forward`` with ``candidates`` (the ``retrieval_cand`` cell, one
    user against a candidate matrix)."""
    jm, params, tm, cfg = _pair("two-tower-retrieval")
    batch = _batch(cfg, seed=3, batch=1, candidates=4000, train=False)
    np.testing.assert_allclose(_np(tm.forward(_torch(batch))),
                               np.asarray(jm.forward(params, batch)), **TOL)


def test_bf16_tree_crosses_and_matches_jax():
    """The full two-tower widths in bfloat16 at vocab 31: the JAX tree
    arrives as numpy ``bfloat16`` arrays, read through their 16-bit
    pattern, so every parameter holds JAX's bits exactly."""
    jcfg = dataclasses.replace(jarchs.TWO_TOWER, vocab=31)
    tcfg = dataclasses.replace(recsys_archs.TWO_TOWER, vocab=31)
    jm, tm = jarchs._MODEL_CLS["two_tower"](jcfg), R.TwoTowerModel(tcfg)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    assert params["user_w"][0].dtype.name == "bfloat16"
    R.load_jax_params(tm, params, device="cpu")
    for got, want in ((tm.user_tables, params["user_tables"]), (tm.item_w[2], params["item_w"][2])):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.detach().view(torch.int16).numpy(),
                                      want.view(np.int16))
    rng = np.random.default_rng(4)
    for tower, fields in (("user_embed", 8), ("item_embed", 4)):
        ids = rng.integers(0, 31, size=(128, fields))
        a = np.asarray(getattr(jm, tower)(params, jnp.asarray(ids))).astype(np.float32)
        with torch.no_grad():
            b = _np(getattr(tm, tower)(torch.as_tensor(ids)))
        assert np.abs(a - b).max() <= 2e-2
        cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
        assert cos.min() >= 0.999, cos.min()


def test_load_jax_params_refuses_a_wrong_tree():
    """A leaf of another shape, or a float32 tree into a bf16 model (no
    silent rounding), raises naming the leaf."""
    jm, _, _ = jax_registry()["din"].make_reduced()
    tm, tcfg, _ = registry()["din"].make_reduced()
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match=r"item_table: .*float32.*bfloat16"):
        R.load_jax_params(R.DINModel(dataclasses.replace(tcfg, dtype=torch.bfloat16)),
                          params, device="cpu")
    params["attn_w"][1] = params["attn_w"][1].T
    with pytest.raises(ValueError, match=r"attn_w\[1\]"):
        R.load_jax_params(tm, params, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_shapes_match_jax(arch):
    """The full configs: the parameter tree's shapes and dtypes equal JAX's,
    as ``meta`` tensors (nothing allocated), and a model is built on
    ``meta`` until its parameters are placed."""
    jm, tm = jax_registry()[arch].model, registry()[arch].model
    want = jax.tree.leaves(jm.abstract_params())
    got = jax.tree.leaves(tm.abstract_params())
    assert [tuple(t.shape) for t in got] == [tuple(s.shape) for s in want]
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16 for t in got)
    assert all(s.dtype == jnp.bfloat16 for s in want)
    assert all(p.device.type == "meta" for p in tm.parameters())
    assert tm.param_bytes() == sum(s.size * 2 for s in want)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_draws_the_reference_distribution(arch):
    """normal / sqrt(fan), fan = shape[-2] (shape[-1] for 1-D), reproducible
    from the generator's seed; placed on the device asked for."""
    tm, _, _ = registry()[arch].make_reduced()
    tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    again, _, _ = registry()[arch].make_reduced()
    again.init_params(torch.Generator().manual_seed(0), device="cpu")
    for (name, i, (shape, dt)), p, q in zip(tm._leaves(), tm.parameters(), again.parameters()):
        assert p.device.type == "cpu" and p.dtype == dt and tuple(p.shape) == shape
        torch.testing.assert_close(p, q, rtol=0, atol=0)
        if p.numel() >= 4096:
            fan = shape[-2] if len(shape) > 1 else shape[-1]
            std = float(p.detach().std()) * np.sqrt(fan)
            assert abs(std - 1.0) < 0.05, (name, i, std)


def test_cast_model_upcasts_the_same_weights():
    tcfg = dataclasses.replace(recsys_archs.TWO_TOWER, vocab=31)
    tm = R.TwoTowerModel(tcfg).init_params(torch.Generator().manual_seed(0), device="cpu")
    up = R.cast_model(tm, torch.float32, "cpu")
    assert up.cfg.dtype == torch.float32 and tm.cfg.dtype == torch.bfloat16
    for a, b in zip(tm.parameters(), up.parameters()):
        assert b.dtype == torch.float32
        torch.testing.assert_close(a.detach().float(), b.detach(), rtol=0, atol=0)


def test_sharding_knobs_raise_with_their_item():
    """DLRM's parameter specs and DIN's ``serve_p99`` partition equal JAX's
    on the three meshes of ``torch_sharding_common``; ``batch_axes``
    leaves the logits' bits as they are, and inside a sharded step its spec
    must name the active mesh's axes (the name is kept from when the port
    raised here)."""
    from repro_torch.launch.simdevices import simulated_mesh
    from repro_torch.parallel.sharding import active_mesh
    from torch_sharding_common import MESHES, meshes, spec_tuples

    tm, cfg, _ = registry()["dlrm-rm2"].make_reduced()
    jm, _, _ = jax_registry()["dlrm-rm2"].make_reduced()
    for names, shape in MESHES:
        jmesh, tmesh = meshes(names, shape)
        assert spec_tuples(tm.param_specs(tmesh)) == spec_tuples(jm.param_specs(jmesh))
        assert spec_tuples(registry()["din"].cells["serve_p99"].partition(tmesh)) == \
            spec_tuples(jax_registry()["din"].cells["serve_p99"].input_partition(jmesh))
    tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    sharded = R.DLRMModel(dataclasses.replace(cfg, batch_axes=("data",))).load_param_tree(
        tm.param_tree())
    batch = _torch(_batch(cfg, seed=5))
    want = tm.forward(batch)
    assert torch.equal(sharded.forward(batch), want)
    with active_mesh(simulated_mesh(2)):
        assert torch.equal(sharded.forward(batch), want)
    with active_mesh(simulated_mesh(2, axis_names=("pod",))), \
            pytest.raises(ValueError, match="lacks"):
        sharded.forward(batch)


def test_check_ids_refuses_ids_out_of_range():
    R.check_ids(np.array([[0, 996]]), 997)
    for bad in (np.array([[0, 997]]), np.array([[-1, 3]])):
        with pytest.raises(ValueError, match=r"\[0, 997\)"):
            R.check_ids(bad, 997)


def test_embedding_bag_matches_jax():
    from repro.models import recsys as JR

    rng = np.random.default_rng(6)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    idx = rng.integers(0, 50, size=(6, 5)).astype(np.int32)
    valid = rng.random((6, 5)) < 0.6
    valid[0] = False
    for v in (None, valid):
        for combine in ("mean", "sum"):
            got = R.embedding_bag(torch.as_tensor(table), torch.as_tensor(idx),
                                  None if v is None else torch.as_tensor(v), combine)
            want = JR.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                    None if v is None else jnp.asarray(v), combine)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ----------------------------------------------------------------- registry

def test_registry_is_the_recsys_part_of_jax():
    """The port registers every name JAX does, in JAX's order; the recsys
    and LM bundles' configs and cells equal JAX's here (the LM bundles' own
    checks: ``tests/test_torch_lm_configs.py``; the GNN's:
    ``tests/test_torch_gnn.py``)."""
    jreg, treg = jax_registry(), registry()
    assert list(treg) == list(jreg)
    assert NOT_PORTED == {} and set(jreg) - set(treg) == set()
    assert all_cells() == [(n, c) for n, b in jreg.items() for c in b.cells]
    assert {a for a, _ in all_cells()} == set(treg)
    for name, b in treg.items():
        jb = jreg[name]
        if jb.family == "gnn":
            continue
        assert b.family == jb.family in ("lm", "recsys")
        assert dataclasses.asdict(b.cfg) | {"dtype": None} == \
            dataclasses.asdict(jb.cfg) | {"dtype": None}
        assert b.cfg.dtype == torch.bfloat16 and jb.cfg.dtype == jnp.bfloat16
        assert list(b.cells) == list(jb.cells)
        for cname, cell in b.cells.items():
            jcell = jb.cells[cname]
            assert (cell.kind, cell.note, cell.skip) == (jcell.kind, jcell.note, jcell.skip)
            want = jcell.inputs()
            got = cell.inputs()
            assert list(got) == list(want)
            for key, spec in got.items():
                assert spec.shape == want[key].shape
                assert spec.dtype == DTYPES[want[key].dtype.type]


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_bundles_match_jax(arch):
    (_, jcfg, _), (_, tcfg, batch_fn) = (jax_registry()[arch].make_reduced(),
                                         registry()[arch].make_reduced())
    assert dataclasses.asdict(tcfg) | {"dtype": None} == dataclasses.asdict(jcfg) | {"dtype": None}
    assert tcfg.dtype == torch.float32 and tcfg.vocab == 997
    batch = batch_fn(torch.Generator().manual_seed(0))
    spec = common.recsys_batch_spec(tcfg, batch=16, train=True)
    assert list(batch) == list(spec)
    for key, t in batch.items():
        assert tuple(t.shape) == spec[key].shape and t.dtype == spec[key].dtype
        if t.dtype == torch.int32:
            assert 0 <= int(t.min()) and int(t.max()) < 997


def test_unported_and_unknown_names_raise():
    """Every name JAX registers resolves (``pna`` too: nothing is left
    unported); an unknown name still raises ``KeyError``."""
    assert NOT_PORTED == {}
    for name in jax_registry():
        assert get_arch(name) is registry()[name]
    assert get_arch("pna").family == "gnn"
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")
    assert get_arch("two-tower-retrieval") is registry()["two-tower-retrieval"]
    for name in ("phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b", "gemma2-9b",
                 "deepseek-coder-33b", "llama3.2-1b"):
        assert get_arch(name) is registry()[name] and get_arch(name).family == "lm"


def test_arch_files_expose_their_bundle():
    from repro_torch.configs import din, dlrm_rm2, two_tower, wide_deep

    for mod in (din, dlrm_rm2, two_tower, wide_deep):
        assert mod.BUNDLE.name == mod.ARCH_ID and mod.CONFIG is mod.BUNDLE.cfg


# ------------------------------------------------------- pruned retrieval

def _pruned_case(n_blocks: int = 40, nq: int = 6, seed: int = 7):
    """The reduced two-tower pair, a BSS index over a clustered normalised
    corpus (the port's build on the CPU), and the pruned batch for both."""
    jm, params, tm, cfg = _pair("two-tower-retrieval")
    rng = np.random.default_rng(seed)
    centres = np.asarray(jm.user_embed(params, rng.integers(0, cfg.vocab, size=(12, 8))))
    n = 128 * n_blocks - 37  # a padded last block
    cand = centres[rng.integers(0, 12, size=n)] + (0.3 / 16) * rng.normal(size=(n, 256))
    cand = (cand / np.linalg.norm(cand, axis=1, keepdims=True)).astype(np.float32)
    idx = flat_index.build_bss("l2", cand, n_pivots=8, n_pairs=16, block=128, seed=1,
                               device="cpu")
    arrays = dict(candidates=idx.data, pivots=idx.pivots, pair_idx=idx.pairs.astype(np.int32),
                  deltas=idx.deltas, boxes=idx.boxes)
    user_ids = rng.integers(0, cfg.vocab, size=(nq, 8)).astype(np.int32)
    return jm, params, tm, user_ids, arrays, idx


def _keys64(u, arrays):
    """lb and cdist in float64 numpy, the reference's formulas."""
    f = np.float64  # lint: disable=R3
    u, piv = u.astype(f), arrays["pivots"].astype(f)
    boxes, deltas = arrays["boxes"].astype(f), arrays["deltas"].astype(f)
    pairs = arrays["pair_idx"]
    dq = np.sqrt(np.maximum((u * u).sum(-1)[:, None] + (piv * piv).sum(-1)[None] - 2 * u @ piv.T,
                            0))
    d1, d2 = dq[:, pairs[:, 0]], dq[:, pairs[:, 1]]
    delta = np.maximum(deltas[None], 1e-12)
    qx = (d1 * d1 - d2 * d2) / (2 * delta)
    qy = np.sqrt(np.maximum(d1 * d1 - (qx + delta / 2) ** 2, 0))
    qx, qy = qx[:, None], qy[:, None]
    dx = np.maximum(np.maximum(boxes[None, :, :, 0] - qx, qx - boxes[None, :, :, 1]), 0)
    dy = np.maximum(np.maximum(boxes[None, :, :, 2] - qy, qy - boxes[None, :, :, 3]), 0)
    lb = np.sqrt(dx * dx + dy * dy).max(-1)
    cx = 0.5 * (boxes[None, :, :, 0] + boxes[None, :, :, 1])
    cy = 0.5 * (boxes[None, :, :, 2] + boxes[None, :, :, 3])
    cdist = np.sqrt((qx - cx) ** 2 + (qy - cy) ** 2).mean(-1)
    return lb, cdist


def test_pruned_keys_match_float64_and_rows_follow_the_lexsort():
    _, _, tm, user_ids, arrays, _ = _pruned_case()
    budget = 15
    t = _torch(dict(arrays, user_ids=user_ids))
    with torch.no_grad():
        u = tm.user_embed(t["user_ids"])
        lb, cdist = R.pruned_block_keys(u.float(), t["pivots"], t["pair_idx"], t["deltas"],
                                        t["boxes"])
        scores, rows = tm.forward_retrieval_pruned(t, block=128, budget_blocks=budget)
    lb64, cd64 = _keys64(u.numpy(), arrays)
    np.testing.assert_allclose(lb.numpy(), lb64, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cdist.numpy(), cd64, rtol=1e-5, atol=1e-5)
    assert scores.shape == rows.shape == (len(user_ids), budget * 128)
    for q in range(len(user_ids)):
        top = np.lexsort((cdist[q].numpy(), lb[q].numpy()))[:budget]
        np.testing.assert_array_equal(rows[q].numpy(),
                                      (top[:, None] * 128 + np.arange(128)).ravel())
    cand = np.pad(arrays["candidates"], ((0, 0), (0, 0)))
    r = rows.numpy()
    want = np.einsum("qe,qke->qk", u.numpy(), cand[np.minimum(r, len(cand) - 1)])
    want[r >= len(cand)] = 0.0
    np.testing.assert_allclose(scores.numpy(), want, rtol=1e-5, atol=1e-5)


def test_lexsort_rows_is_jnp_lexsort():
    rng = np.random.default_rng(8)
    primary = rng.integers(0, 3, size=(5, 200)).astype(np.float32)  # ties everywhere
    secondary = rng.integers(0, 4, size=(5, 200)).astype(np.float32)
    got = R.lexsort_rows(torch.as_tensor(secondary), torch.as_tensor(primary)).numpy()
    want = np.asarray(jnp.lexsort((jnp.asarray(secondary), jnp.asarray(primary)), axis=1))
    np.testing.assert_array_equal(got, want)


def test_pruned_block_choice_matches_jax_up_to_edge_ties():
    """The blocks inside the budget equal JAX's for every query, except a
    block whose (lb, cdist) lies within 1e-5 of the budget's edge key
    (counted: fp32 summation order moves a key that close)."""
    jm, params, tm, user_ids, arrays, _ = _pruned_case(nq=8)
    budget = 15
    _, jrows = jm.forward_retrieval_pruned(
        params, dict(arrays, user_ids=user_ids), block=128, budget_blocks=budget)
    t = _torch(dict(arrays, user_ids=user_ids))
    with torch.no_grad():
        _, rows = tm.forward_retrieval_pruned(t, block=128, budget_blocks=budget)
        u = tm.user_embed(t["user_ids"]).numpy()
    lb64, cd64 = _keys64(u, arrays)
    edge_ties, bad = 0, []
    for q in range(len(user_ids)):
        a = set(rows[q].numpy()[::128] // 128)
        b = set(np.asarray(jrows[q])[::128] // 128)
        order = np.lexsort((cd64[q], lb64[q]))
        edge = (lb64[q, order[budget - 1]], cd64[q, order[budget - 1]])
        for blk in a ^ b:
            near = (abs(lb64[q, blk] - edge[0]) <= 1e-5
                    and abs(cd64[q, blk] - edge[1]) <= 1e-5)
            edge_ties += near
            if not near:
                bad.append((q, int(blk)))
    assert not bad, bad
    assert edge_ties <= 2 * len(user_ids), edge_ties


def test_supermetric_pruned_retrieval_beats_random():
    """The mirror of ``tests/test_arch_smoke.py``'s test on the port: pruned
    scoring with the planar bound recalls far more of the true top-k than
    a random block subset of the same budget, on a corpus clustered around
    user-tower outputs (the geometry a trained two-tower model gives)."""
    tm, cfg, _ = registry()["two-tower-retrieval"].make_reduced()
    jm, _, _ = jax_registry()["two-tower-retrieval"].make_reduced()
    R.load_jax_params(tm, jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0))),
                      device="cpu")
    rng = np.random.default_rng(0)
    n = 128 * 64
    with torch.no_grad():
        centres = tm.user_embed(torch.as_tensor(
            rng.integers(0, cfg.vocab, size=(20, cfg.n_user_fields)))).numpy()
    e_dim = centres.shape[1]
    cand = centres[rng.integers(0, 20, size=n)] + (
        0.3 / np.sqrt(e_dim)) * rng.normal(size=(n, e_dim)).astype(np.float32)
    cand = (cand / np.linalg.norm(cand, axis=1, keepdims=True)).astype(np.float32)
    idx = flat_index.build_bss("l2", cand, n_pivots=8, n_pairs=16, block=128, seed=1,
                               device="cpu")
    nq = 8
    user_ids = torch.as_tensor(rng.integers(0, cfg.vocab, size=(nq, cfg.n_user_fields)))
    batch = dict(user_ids=user_ids, candidates=torch.as_tensor(idx.data),
                 pivots=torch.as_tensor(idx.pivots), pair_idx=torch.as_tensor(idx.pairs),
                 deltas=torch.as_tensor(idx.deltas), boxes=torch.as_tensor(idx.boxes))
    budget = 24
    with torch.no_grad():
        scores, rows = tm.forward_retrieval_pruned(batch, block=128, budget_blocks=budget)
        dense = tm.forward(dict(user_ids=user_ids, candidates=batch["candidates"]))
    got = 0
    for q in range(nq):
        want = set(np.argsort(-dense[q].numpy())[:10].tolist())
        r, s = rows[q].numpy(), scores[q].numpy()
        got += len(want & set(r[np.argsort(-s)[:10]].tolist()))
    recall = got / (nq * 10)
    assert recall > 1.5 * (budget / 64), (recall, budget / 64)

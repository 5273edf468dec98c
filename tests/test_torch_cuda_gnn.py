"""GNN training on the card: the reduced PNA's segment reductions, both
edge layouts, loss and gradients on the CUDA device against the CPU, a
step run twice (bit for bit), a checkpoint restored and stepped.

Both devices run IEEE float32 (TF32 off); a segment sum adds each
segment's rows in their order on either device (``models/gnn.py``), so it
equals the CPU's bit for bit; the matmuls sum in another order, so the
loss agrees within 1e-5 relative.  The segment ops' gradients equal the
CPU's bit for bit too.  The float64 gradients agree within 1e-5 of each
leaf's largest.  PNA's float32 gradient is ill-conditioned where a
variance lies within a rounding of 0 (``chip_smoke.GNN_REL``'s note), so
a float32 leaf lies further than a rounding from the float64 one on
either device, by an amount that changes with each rounding: the card's
is held within 5e-2 of the CPU's float64 leaf, a bound for a wrong term.
On a well-conditioned graph (every node of degree 8, spread features) the
card's float32 gradient is held within 1e-4 of the CPU's float32 one, the
LM's bound, so a fault in the backward outside the segment ops shows.
The file imports no jax; on the card it runs as

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_gnn.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import batched_molecules
from repro_torch.kernels import _build
from repro_torch.models import gnn
from repro_torch.models.gnn import PNAConfig, PNAModel
from repro_torch.models.params import cast_model
from repro_torch.optim import adamw
from repro_torch.pytree import leaves, leaves_with_paths
from repro_torch.train.step import functional_loss, init_state, make_train_step, to_device

LOSS_REL = 1e-5
GRAD_REL = 1e-5
F32_GRAD_REL = 5e-2
SMALL = dict(name="t", n_layers=2, d_hidden=16, d_feat=8, n_classes=3)


@pytest.fixture
def card():
    """The CUDA device, or a skip where no sm_90 card and nvcc are."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    try:
        _build._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bits(t):
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.itemsize])


def _equal_trees(a, b) -> bool:
    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(_bits(x), _bits(y)) for (_, x), (_, y) in zip(la, lb))


def _node_batch(seed: int, n: int = 256, e: int = 1200) -> dict:
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(n, 8)).astype(np.float32),
            "edge_src": rng.integers(0, n - 16, e).astype(np.int32),
            "edge_dst": rng.integers(0, n - 16, e).astype(np.int32),
            "labels": rng.integers(0, 3, n).astype(np.int32),
            "label_mask": (rng.random(n) < 0.7).astype(np.float32)}


def _graph_batch(seed: int) -> dict:
    b = batched_molecules(np.random.default_rng(seed), 8, 10, 20, 8, 3)
    b["x"] = np.concatenate([b["x"], np.zeros((16, 8), np.float32)])
    b["graph_id"] = np.concatenate([b["graph_id"], np.full(16, 8, np.int32)])
    return b


def _partitioned(batch: dict, s_blocks: int = 8) -> dict:
    out = {k: v for k, v in batch.items() if k not in ("edge_src", "edge_dst")}
    ps, pd, pv = PNAModel.partition_edges(batch["edge_src"], batch["edge_dst"],
                                          batch["x"].shape[0], s_blocks)
    out.update(edge_src=ps, edge_dst_local=pd, edge_valid=pv)
    return out


def _models(dev, **kw):
    cpu = PNAModel(PNAConfig(**SMALL, **kw)).init_params(torch.Generator().manual_seed(0),
                                                         device="cpu")
    return cpu, cast_model(cpu, torch.float32, dev)


@pytest.mark.cuda
def test_segment_ops_on_card_equal_the_cpu_bit_for_bit(card):
    rng = np.random.default_rng(0)
    vals = torch.as_tensor(rng.normal(size=(20000, 75)).astype(np.float32))
    ids = torch.as_tensor(rng.integers(-5, 3000, 20000).astype(np.int32))
    vals = vals.clamp_min(0)  # ReLU's zeros: ties in the max and min
    w = torch.as_tensor(rng.normal(size=(2990, 75)).astype(np.float32))
    for fn in (gnn.segment_sum, gnn.segment_max, gnn.segment_min):
        outs = []
        for dev in ("cpu", card):
            v = vals.to(dev).requires_grad_(True)
            o = fn(v, ids.to(dev), 2990)
            g, = torch.autograd.grad((gnn._finite_or_zero(o) * w.to(dev)).sum(), v)
            outs.append((o.detach().cpu(), g.cpu()))
        (want, g_want), (got, g_got) = outs
        assert torch.equal(_bits(got), _bits(want)), fn.__name__
        assert torch.equal(_bits(g_got), _bits(g_want)), fn.__name__
    h = vals[:3000].clone().requires_grad_(True)
    idx = ids.clamp(0, 2999).long()
    g_cpu, = torch.autograd.grad(gnn.take_rows(h, idx).sum(), h)
    hd = h.detach().to(card).requires_grad_(True)
    g_dev, = torch.autograd.grad(gnn.take_rows(hd, idx.to(card)).sum(), hd)
    assert torch.equal(g_dev.cpu(), g_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("graph_level", [False, True], ids=["nodes", "graphs"])
def test_pna_on_card_matches_cpu(card, graph_level):
    """Both layouts' logits agree within 1e-5 on the card; the card's loss
    and gradients against the CPU's."""
    cpu, model = _models(card, graph_level=graph_level)
    flat = _graph_batch(1) if graph_level else _node_batch(1)
    part = _partitioned(flat)
    with torch.no_grad():
        a = model.forward(to_device(flat, card))
        b = model.forward(to_device(part, card))
    assert torch.allclose(a, b, rtol=1e-5, atol=1e-5)
    f64 = torch.float64  # lint: disable=R3

    def rel(x, y):
        return float((x.cpu().to(f64) - y).abs().max()) / float(y.abs().max())

    for batch in (flat, part):
        got = {}
        for dtype in (torch.float32, f64):
            c, d = cast_model(cpu, dtype, "cpu"), cast_model(model, dtype, card)
            lc, gc = make_train_step(functional_loss(c, c.loss_fn), None).grads(
                c.param_tree(), to_device(batch, "cpu"))
            ld, gd = make_train_step(functional_loss(d, d.loss_fn), None).grads(
                d.param_tree(), to_device(batch, card))
            assert abs(float(ld) - float(lc)) <= LOSS_REL * abs(float(lc))
            got[dtype] = leaves(gc), leaves(gd)
        (_, card32), (cpu64, card64) = got[torch.float32], got[f64]
        for x, y in zip(card64, cpu64):
            assert rel(x, y) <= GRAD_REL
        for x, y in zip(card32, cpu64):
            assert rel(x, y) <= F32_GRAD_REL


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["flat", "partitioned"])
def test_pna_steps_twice_and_from_a_checkpoint_are_bit_equal(card, layout, tmp_path):
    _, model = _models(card)
    batch = _node_batch(2)
    batch = to_device(_partitioned(batch) if layout == "partitioned" else batch, card)
    opt = adamw(lr=3e-4)
    step = make_train_step(functional_loss(model, model.loss_fn), opt)
    runs = []
    for _ in range(2):
        state = init_state(model.param_tree(), opt)
        for _ in range(3):
            state, m = step(state, batch)
        runs.append((state, m["loss"]))
    assert torch.equal(runs[0][1], runs[1][1]) and _equal_trees(runs[0][0], runs[1][0])
    state = runs[0][0]
    mgr = CheckpointManager(tmp_path, keep_last=1)
    mgr.save(3, state)
    restored, _ = mgr.restore(state, device=card)
    assert _equal_trees(step(state, batch)[0], step(restored, batch)[0])


def _conditioned_batch(seed: int, n: int = 512, deg: int = 8) -> dict:
    """Every node receives ``deg`` edges from other nodes (no degree below
    4) and the features are spread (standard deviation 2): every
    (node, channel) variance of the messages is 0 exactly (a channel no
    message lights) or far above its rounding."""
    rng = np.random.default_rng(seed)
    dst = np.repeat(np.arange(n), deg)
    src = (dst + rng.integers(1, n, dst.size)) % n
    return {"x": (rng.normal(size=(n, 8)) * 2.0).astype(np.float32),
            "edge_src": src.astype(np.int32), "edge_dst": dst.astype(np.int32),
            "labels": rng.integers(0, 3, n).astype(np.int32),
            "label_mask": (rng.random(n) < 0.7).astype(np.float32)}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_float32_gradient_within_1e4_on_a_well_conditioned_graph(card, seed):
    """ROADMAP Queue 3 item 16: on a graph where the float32 gradient is well
    conditioned (the CPU's float32 leaves within 1e-5 of its float64 ones,
    checked here), each of the card's float32 gradient leaves lies within
    1e-4 of that leaf's largest value of the CPU's float32 gradient (the
    LM's bound), and the loss within 1e-5 relative.  The 5e-2 check of the
    ill-conditioned graphs above stays as it is."""
    f64 = torch.float64  # lint: disable=R3

    def grads(m, b):
        return make_train_step(functional_loss(m, m.loss_fn), None).grads(m.param_tree(), b)

    def rel(x, y):
        return float((x.cpu().to(f64) - y.to(f64)).abs().max()) / float(y.abs().max())

    cpu = PNAModel(PNAConfig(**SMALL)).init_params(torch.Generator().manual_seed(seed),
                                                   device="cpu")
    batch = to_device(_conditioned_batch(seed), "cpu")
    l32, g32 = grads(cpu, batch)
    _, g64 = grads(cast_model(cpu, f64, "cpu"), dict(batch, x=batch["x"].to(f64)))
    for k in g32:
        assert rel(g32[k], g64[k]) <= 1e-5, k
    on_card = cast_model(cpu, torch.float32, card)
    lc, gc = grads(on_card, to_device(_conditioned_batch(seed), card))
    assert abs(float(lc) - float(l32)) <= LOSS_REL * abs(float(l32))
    for k in g32:
        assert rel(gc[k], g32[k]) <= 1e-4, (k, rel(gc[k], g32[k]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_pna_over_node_shards_on_card(card, shape):
    """PNA's ``"node"`` plan on the card's mesh devices (the well-conditioned
    graph above in the dst-partitioned layout, 512 nodes in 16 blocks):
    the logits within 1e-5 of the largest and the float32 loss within 1e-5
    relative of the one-device step on the card, each float32 gradient
    leaf within 1e-4 of its largest, the halo's all-gather and
    reduce-scatter counted, the gradient twice bit for bit."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharded_step import gather_state, sharded_step_for
    from repro_torch.pytree import tree_map

    model = PNAModel(PNAConfig(**SMALL)).init_params(torch.Generator(card).manual_seed(0),
                                                     device=card)
    batch = to_device(_partitioned(_conditioned_batch(0), 16), card)
    mesh = make_local_mesh(shape[1], n_devices=shape[0] * shape[1])
    with torch.no_grad():
        want = model.forward(batch)
        got = torch.cat(model.split_forward([model.param_tree()] * mesh.n_devices, batch, mesh))
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    one = make_train_step(functional_loss(model, model.loss_fn), adamw())
    loss, grads = one.grads(model.param_tree(), batch)
    step = sharded_step_for("gnn", model, adamw(), mesh)
    state = step.shard(init_state(tree_map(lambda t: t.clone(), model.param_tree()), adamw()))
    with coll.tally() as moved:
        l_sh, g_sh = step.grads(state, batch)
    halo = SMALL["n_layers"] * 512 * SMALL["d_hidden"] * 4 * (mesh.n_devices - 1) / mesh.n_devices
    assert moved["all-gather"] == moved["reduce-scatter"] == halo
    l_again, g_again = step.grads(state, batch)
    assert torch.equal(_bits(l_sh), _bits(l_again))
    assert abs(float(l_sh) - float(loss)) <= LOSS_REL * abs(float(loss))
    g_sh, g_again = gather_state(g_sh, card), gather_state(g_again, card)
    for k, g in grads.items():
        assert torch.equal(_bits(g_sh[k]), _bits(g_again[k])), k
        assert float((g_sh[k] - g).abs().max()) <= 1e-4 * float(g.abs().max()), k

"""The port's invariant audit on the card: the full matrix on ``"cuda"`` and
``"torch"`` with every pass under ``torch.cuda.set_sync_debug_mode
("error")``, a ``.item()`` injected into a pass caught there, the rebuild
audit through the serving front, and one batch of a built index through
``audit_index``.  The file imports no jax; on the card it runs as

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_invariants.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.analysis import audit
from repro_torch.core import flat_index
from repro_torch.kernels import _build, launch_counts, reset_launch_counts
from repro_torch.parallel import shard_index


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


@pytest.mark.cuda
def test_full_matrix_is_clean_on_the_card(card):
    reset_launch_counts()
    problems, cells = audit.run_audit(full=True, device=card)
    assert [p.format() for p in problems] == []
    names = {c["cell"] for c in cells}
    for metric in audit.AUDIT_METRICS:
        for backend in ("cuda-dense", "torch-adaptive", "torch-dense"):
            assert {f"bss/{metric}/{backend}/fp32", f"bss/{metric}/{backend}/bf16"} <= names
        for kind in ("sharded1", "sharded2", "forest", "monotone"):
            for backend in ("cuda", "torch"):
                assert f"{kind}/{metric}/{backend}/bf16" in names
    counts = launch_counts()
    # the audited passes ran through every kernel of the engine paths
    for entry in ("pairwise_l2", "masked_pairwise_l2", "masked_pairwise_l2_bf16",
                  "planar_lower_bound_pairs", "pairwise_jsd", "masked_pairwise_jsd",
                  "masked_pairwise_jsd_bf16", "pairwise_tri", "masked_pairwise_tri",
                  "masked_pairwise_tri_bf16"):
        assert counts[entry] > 0, entry


@pytest.mark.cuda
def test_injected_item_is_caught_on_the_card(card, monkeypatch):
    """The sync debug mode stops a pass that reads a value to the host, and
    the operator watch flags the read as well; the audit reports both and
    goes on."""
    real = flat_index._query_batched

    def faulty(*args, **kwargs):
        out = real(*args, **kwargs)
        float(out[0].sum().item())
        return out

    for module in (flat_index, shard_index):
        monkeypatch.setattr(module, "_query_batched", faulty)
    problems, _ = audit.run_audit(device=card)
    assert problems
    assert {(p.fn, p.check) for p in problems} == {("flat_index._query_batched", "sync")}
    details = [p.detail for p in problems]
    assert any("synchroniz" in d for d in details)  # the debug mode
    assert any("aten._local_scalar_dense" in d for d in details)  # the watch


@pytest.mark.cuda
def test_rebuilds_are_bounded_on_the_card(card):
    problems, info = audit.audit_rebuilds(device=card)
    assert problems == []
    assert info["touched"] == [4, 8] and info["generations"] == [0, 1]
    assert "range/flat_index._query_batched" in info["shapes"]
    assert all(n <= 1 for n in info["loads"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "jsd", "triangular"])
def test_audit_index_is_clean_on_the_card(card, metric):
    rng = np.random.default_rng(5)
    x = rng.random((6000, 24)).astype(np.float32) + 1e-3
    if metric != "l2":
        x /= x.sum(axis=1, keepdims=True)
    idx = flat_index.build_bss(metric, x[:5800], device=card)
    q = x[5800:]
    d = np.sort(flat_index.bss_lower_bounds(idx, q).ravel())
    problems, cells = audit.audit_index(idx, q, float(d[d.size // 4]))
    assert [p.format() for p in problems] == []
    assert [c["cell"] for c in cells] == [f"index/{metric}/cuda/fp32",
                                           f"index/{metric}/cuda/bf16"]

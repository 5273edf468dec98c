"""The port (``src/repro_torch``), its examples and ``chip_smoke.py``
import neither jax nor any module of the JAX package ``repro``, nor
``ml_dtypes`` (the card's machine has none)."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")
QUICKSTART = "examples/torch_quickstart.py"
EXAMPLE = "examples/torch_retrieval_serving.py"
LM_EXAMPLE = "examples/torch_lm_embedding_retrieval.py"
LAUNCHER = "repro_torch.launch.serve"
TRAIN_LAUNCHER = "repro_torch.launch.train"
# a finder that refuses to import jax or the JAX package
BLOCK = (
    "import sys\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
    "            raise ImportError(f'{name} is blocked')\n"
    "sys.meta_path.insert(0, Block())\n"
)


def _modules():
    out = []
    for rel in PORT_FILES:
        parts = pathlib.Path(rel).relative_to("src").with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("relpath", PORT_FILES + ["chip_smoke.py", QUICKSTART, EXAMPLE,
                                                  LM_EXAMPLE])
def test_no_jax_or_reference_import(relpath):
    tree = ast.parse((ROOT / relpath).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN + ("ml_dtypes",), (relpath, name)


def test_the_scan_covers_the_model_split():
    """The AST scan above reads the collectives of the model split and the
    modules that call them."""
    for rel in ("src/repro_torch/parallel/collectives.py",
                "src/repro_torch/parallel/sharded_step.py",
                "src/repro_torch/models/transformer.py", "src/repro_torch/models/layers.py"):
        assert rel in PORT_FILES, rel


def test_recsys_modules_load_no_jax():
    """The recsys family's model, registry and launcher, imported alone (the
    registry holds every family's names: 5 LM, PNA, 4 recsys)."""
    code = (
        "import sys\n"
        "import repro_torch.models.recsys, repro_torch.configs.registry\n"
        "import repro_torch.launch.serve\n"
        "from repro_torch.configs.registry import registry\n"
        "assert len(registry()) == 10\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('ml_dtypes',)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_lm_modules_and_the_lm_example_load_no_jax():
    """The LM family's model, layers, configs and registry, and the LM
    example run at a reduced size, in a process where importing jax,
    ``repro`` or ``ml_dtypes`` fails."""
    blocked = FORBIDDEN + ("ml_dtypes",)
    code = (
        BLOCK.replace(repr(FORBIDDEN), repr(blocked))
        + "import runpy\n"
        "import torch\n"
        "import repro_torch.models.transformer, repro_torch.models.layers\n"
        "import repro_torch.configs.lm_archs, repro_torch.configs.registry\n"
        "from repro_torch.configs.registry import get_arch\n"
        "model, cfg, batch_fn = get_arch('gemma2-9b').make_reduced()\n"
        "model.init_params(torch.Generator().manual_seed(0), device='cpu')\n"
        "logits, cache = model.prefill(batch_fn(torch.Generator().manual_seed(1))['tokens'])\n"
        "assert torch.isfinite(logits).all() and cache['k'].shape[0] == 2\n"
        f"sys.argv = ['x', '--device', 'cpu', '--windows', '512']\n"
        f"runpy.run_path({str(ROOT / LM_EXAMPLE)!r}, run_name='__main__')\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {blocked!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "exact=True" in out.stdout


def test_training_modules_and_a_step_load_no_jax():
    """The train loop, the checkpoint manager, the optimizers and the
    training launcher import, and one train step of the reduced two-tower
    runs and checkpoints, in a process where importing jax, ``repro`` or
    ``ml_dtypes`` fails."""
    blocked = FORBIDDEN + ("ml_dtypes",)
    code = (
        BLOCK.replace(repr(FORBIDDEN), repr(blocked))
        + "import tempfile\n"
        "import torch\n"
        "import repro_torch.train.loop, repro_torch.checkpoint.manager\n"
        "import repro_torch.optim, repro_torch.launch.train\n"
        "from repro_torch.checkpoint.manager import CheckpointManager\n"
        "from repro_torch.configs.registry import get_arch\n"
        "from repro_torch.data.pipeline import ClickStream\n"
        "from repro_torch.optim import adamw\n"
        "from repro_torch.train.step import functional_loss, init_state, make_train_step, "
        "to_device\n"
        "model, cfg, _ = get_arch('two-tower-retrieval').make_reduced()\n"
        "model.init_params(torch.Generator().manual_seed(0), device='cpu')\n"
        "step = make_train_step(functional_loss(model, model.loss_fn), adamw())\n"
        "state, m = step(init_state(model.param_tree(), adamw()),\n"
        "                to_device(ClickStream(cfg, 16).next(), 'cpu'))\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    CheckpointManager(d).save(1, state)\n"
        "    CheckpointManager(d).restore(state, device='cpu')\n"
        "assert torch.isfinite(m['loss'])\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {blocked!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sharded_engine_runs_with_jax_absent():
    """``repro_torch.parallel`` imports, a mesh-built index answers on CPU
    shards, the sharded train step steps the reduced Llama on a simulated
    (2, 2) mesh (``launch.simdevices``) with its layers split over "model"
    (``parallel.collectives``), the reduced PNA over node shards (the
    ``"node"`` plan) and the reduced DLRM and two tower with their tables
    in "model" pieces, ``launch.mesh`` lays out the production mesh and
    ``launch.dryrun`` reckons PNA's and the two tower's train cells and an
    LM serving and train cell on it, in a process where importing jax or
    ``repro`` fails."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np\n"
        "from repro_torch.core import flat_index\n"
        "from repro_torch.parallel import ShardMesh, shard_index\n"
        "x = np.random.default_rng(0).random((300, 6)).astype(np.float32)\n"
        "idx = flat_index.build_bss('l2', x[:290], n_pivots=4, n_pairs=4, block=32,\n"
        "                           mesh=ShardMesh(('cpu',) * 4))\n"
        "hits, st = flat_index.bss_query_batched(idx, x[290:], 0.4)\n"
        "ids, _, ks = flat_index.bss_knn_batched(idx, x[290:], 3)\n"
        "assert st['n_shards'] == ks['n_shards'] == 4 and ids.shape == (10, 3)\n"
        "assert isinstance(idx.sharded(), shard_index.ShardedBSSIndex)\n"
        "import torch\n"
        "from repro_torch.configs.registry import get_arch\n"
        "from repro_torch.launch import dryrun, mesh, simdevices\n"
        "from repro_torch.optim import adamw\n"
        "from repro_torch.parallel.sharded_step import sharded_step_for\n"
        "from repro_torch.train.step import init_state\n"
        "model, cfg, batch_fn = get_arch('llama3.2-1b').make_reduced()\n"
        "model.init_params(torch.Generator().manual_seed(0), device='cpu')\n"
        "step = sharded_step_for('lm', model, adamw(), simdevices.simulated_mesh(\n"
        "    4, (2, 2), ('data', 'model')))\n"
        "state, m = step.step_(step.shard(init_state(model.param_tree(), adamw())),\n"
        "                      batch_fn(torch.Generator().manual_seed(1)))\n"
        "assert torch.isfinite(m['loss']) and step.rows == 'model'\n"
        "from repro_torch.launch.train import MoleculeStream, train_model\n"
        "from repro_torch.train.step import to_device\n"
        "from repro_torch.data.pipeline import ClickStream\n"
        "for arch, rows in (('pna', 'node'), ('dlrm-rm2', 'split'),\n"
        "                   ('two-tower-retrieval', 'in_batch')):\n"
        "    model, cfg = train_model(get_arch(arch), True)\n"
        "    model.init_params(torch.Generator().manual_seed(0), device='cpu')\n"
        "    b = (MoleculeStream(cfg.d_feat, cfg.n_classes, 16) if arch == 'pna'\n"
        "         else ClickStream(cfg, batch=16)).next()\n"
        "    family = 'gnn' if arch == 'pna' else 'recsys'\n"
        "    step = sharded_step_for(family, model, adamw(), simdevices.simulated_mesh(\n"
        "        4, (2, 2), ('data', 'model')))\n"
        "    state, m = step.step_(step.shard(init_state(model.param_tree(), adamw())),\n"
        "                          to_device(b, 'cpu'))\n"
        "    assert torch.isfinite(m['loss']) and step.rows == rows, (arch, step.rows)\n"
        "import repro_torch.parallel.collectives\n"
        "for arch, shape in (('pna', 'ogb_products'), ('two-tower-retrieval', 'train_batch'),\n"
        "                    ('llama3.2-1b', 'decode_32k'), ('llama3.2-1b', 'train_4k')):\n"
        "    rec = dryrun.reckon_cell(arch, shape, mesh.make_production_mesh())\n"
        "    assert rec['status'] == 'reckoned' and rec['n_devices'] == 256\n"
        "    assert shape == 'decode_32k' or rec['collective_bytes']['all-gather (activations)'] > 0\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _run_blocked(target: str, args: list[str], cwd) -> subprocess.CompletedProcess:
    """Run a module (``-m`` style) or a script with jax and ``repro`` blocked;
    the child exits 3 if either was imported after all."""
    run = (f"runpy.run_module({target!r}, run_name='__main__')" if not target.endswith(".py")
           else f"runpy.run_path({str(ROOT / target)!r}, run_name='__main__')")
    code = (
        BLOCK
        + "import runpy\n"
        + f"sys.argv = [{target!r}, *{args!r}]\n"
        + "try:\n"
        + f"    {run}\n"
        + "    rc = 0\n"
        + "except SystemExit as e:\n"
        + "    rc = e.code or 0\n"
        + f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        + "print('imported:', bad)\n"
        + "sys.exit(3 if bad else rc)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("target, args", [
    ("repro_torch.analysis", ["--device", "cpu"]),
    (QUICKSTART, ["--device", "cpu", "--corpus", "2000", "--queries", "16"]),
    (LAUNCHER, ["--device", "cpu", "--corpus", "2000", "--queries", "16"]),
    (TRAIN_LAUNCHER, ["--arch", "two-tower-retrieval", "--reduced", "--steps", "3",
                      "--device", "cpu"]),
    (EXAMPLE, ["--device", "cpu", "--steps", "3", "--corpus", "500", "--queries", "16"]),
])
def test_audit_and_quickstart_run_with_jax_absent(tmp_path, target, args):
    """The audit's CLI and the quickstart pass on the CPU, their own checks
    included, in a process where importing jax or ``repro`` fails."""
    out = _run_blocked(target, args, tmp_path)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert "imported: []" in out.stdout


@pytest.mark.parametrize("target", ["repro_torch.analysis", QUICKSTART, LAUNCHER])
def test_audit_and_quickstart_need_a_card_by_default(tmp_path, target):
    """Without ``--device`` both run on the card, so they raise where there is
    none."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run_blocked(target, [], tmp_path)
    assert out.returncode not in (0, 3), out.stdout + out.stderr
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("target, args", [
    (TRAIN_LAUNCHER, ["--arch", "two-tower-retrieval", "--reduced"]), (EXAMPLE, []),
])
def test_training_entry_points_need_a_card_by_default(tmp_path, target, args):
    """Without ``--device`` the training launcher and the training-and-serving
    example run on the card, so they raise where there is none."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run_blocked(target, args, tmp_path)
    assert out.returncode not in (0, 3), out.stdout + out.stderr
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("arch", ["llama3.2-1b", "pna"])
def test_lm_and_gnn_training_run_with_jax_absent(tmp_path, arch):
    """The training launcher trains the reduced Llama and the
    reduced PNA on the CPU, printing finite losses, in a process where
    importing jax or ``repro`` fails (``models.gnn``, ``configs.pna`` and
    the LM's backward included)."""
    out = _run_blocked(TRAIN_LAUNCHER, ["--arch", arch, "--reduced", "--steps", "3",
                                        "--device", "cpu", "--checkpoint-dir", "ck"], tmp_path)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert "imported: []" in out.stdout and "done: final loss" in out.stdout
    assert "nan" not in out.stdout


@pytest.mark.parametrize("arch", ["llama3.2-1b", "pna"])
def test_lm_and_gnn_training_need_a_card_by_default(tmp_path, arch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run_blocked(TRAIN_LAUNCHER, ["--arch", arch, "--reduced"], tmp_path)
    assert out.returncode not in (0, 3), out.stdout + out.stderr
    assert "no CUDA device" in out.stderr

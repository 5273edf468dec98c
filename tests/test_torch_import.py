"""The port (``src/repro_torch``) and ``chip_smoke.py`` import neither jax
nor any module of the JAX package ``repro``."""

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


@pytest.mark.parametrize("relpath", PORT_FILES + ["chip_smoke.py"])
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
            assert name.split(".")[0] not in FORBIDDEN, (relpath, name)


def test_sharded_engine_runs_with_jax_absent():
    """``repro_torch.parallel`` imports, and a mesh-built index answers on
    CPU shards, in a process where importing jax or ``repro`` fails."""
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
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr

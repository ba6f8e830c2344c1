"""The port stands alone: no module of recnet_tpu_torch, and not
chip_smoke.py, imports the JAX package or JAX.

The AST walk catches every import statement, at any depth (inside
functions too); the subprocess check catches what the entry points pull in
at run time, indirectly included."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("recnet_tpu", "jax", "jaxlib")
SOURCES = sorted((REPO / "recnet_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
ENTRY_POINTS = ("recnet_tpu_torch.cli.eval", "recnet_tpu_torch.cli.serve",
                "recnet_tpu_torch.cli.caption", "recnet_tpu_torch.evaluation",
                "recnet_tpu_torch.cli.train", "recnet_tpu_torch.checkpoint")


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_module_of_the_port_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_walk_sees_nested_imports():
    tree = ast.parse("def f():\n    from recnet_tpu.metrics import x\n"
                     "import jax.numpy as jnp\nfrom . import jax\n")
    assert sorted(m for m in _imported_modules(tree) if _forbidden(m)) == [
        "jax.numpy", "recnet_tpu.metrics"]


def test_entry_points_load_neither_jax_nor_the_jax_package():
    code = ("import importlib, json, sys\n"
            f"for name in {list(ENTRY_POINTS)!r}:\n"
            "    importlib.import_module(name)\n"
            "print(json.dumps(sorted(m for m in sys.modules if "
            f"m.split('.')[0] in {list(FORBIDDEN)!r})))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []

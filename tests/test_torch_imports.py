"""The port imports no JAX: every module of mqe_tpu_torch imports in a process
where `jax`, `flax` and `mqe_tpu` cannot be imported, and chip_smoke.py
imports none of them either (the machine with the card has no JAX)."""
import ast
import os
import pkgutil
import subprocess
import sys

import mqe_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "mqe_tpu")

_CHILD = r"""
import importlib, importlib.abc, pkgutil, sys

FORBIDDEN = {forbidden!r}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"refused import of {{name}}")
        return None

sys.meta_path.insert(0, Refuse())
import mqe_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mqe_tpu_torch.__path__, "mqe_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
assert not bad, bad
print(len(names))
"""


def test_port_modules_import_without_jax():
    code = _CHILD.format(forbidden=FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n = int(out.stdout.strip().splitlines()[-1])
    expected = [m.name for m in pkgutil.walk_packages(mqe_tpu_torch.__path__, "mqe_tpu_torch.")]
    assert n == len(expected) >= 20


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    compile(tree, path, "exec")
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            roots.add("<dynamic>")
    return roots


def test_chip_smoke_imports_no_jax():
    roots = _imported_roots(os.path.join(REPO, "chip_smoke.py"))
    assert "mqe_tpu_torch" in roots and "torch" in roots
    assert not roots & set(FORBIDDEN) and "<dynamic>" not in roots, roots


def test_port_sources_name_no_jax_import():
    """Belt and braces for imports inside functions, which the import test
    above only reaches when they run."""
    pkg = os.path.dirname(mqe_tpu_torch.__file__)
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                roots = _imported_roots(os.path.join(dirpath, f))
                assert not roots & set(FORBIDDEN), (f, roots)

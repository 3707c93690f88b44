"""The port stands alone: importing every ``repro_torch`` module loads
neither JAX nor the reference package, and builds no kernel; no import
statement of the port or of ``chip_smoke.py`` names either."""

import ast

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 16, names
for name in ("repro_torch.kernels.radix_partition",
             "repro_torch.kernels.segment_reduce", "repro_torch.device",
             "repro_torch.core.collector", "repro_torch.interop"):
    assert name in names, name
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
from repro_torch.kernels import _build
assert not _build._libs
print(len(names))
"""


def test_every_module_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 16


def _imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_import_statement_names_jax_or_repro():
    root = os.path.join(os.path.dirname(__file__), "..")
    paths = [os.path.join(root, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(SRC, "repro_torch")):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    assert len(paths) >= 17
    for path in paths:
        for mod in _imported(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                path, mod)

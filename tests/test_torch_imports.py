"""The port stands alone: importing every ``repro_torch`` module loads
neither JAX nor the reference package (nor the dry-run's fake process
group and memory tracker), and builds no kernel; no import statement of
the port or of ``chip_smoke.py`` names either."""

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
assert len(names) >= 81, names
for name in ("repro_torch.core.cost_model", "repro_torch.core.plan_cache",
             "repro_torch.core.pipeline", "repro_torch.roofline",
             "repro_torch.roofline.analysis",
             "repro_torch.roofline.op_trace",
             "repro_torch.kernels.radix_partition",
             "repro_torch.kernels.segment_reduce",
             "repro_torch.kernels.combine_scatter",
             "repro_torch.kernels.flash_decode", "repro_torch.device",
             "repro_torch.core.collector", "repro_torch.interop",
             "repro_torch.models.common", "repro_torch.models.layers",
             "repro_torch.models.attention", "repro_torch.models.transformer",
             "repro_torch.models.registry", "repro_torch.configs",
             "repro_torch.configs.llama3_8b",
             "repro_torch.serving.serve_step", "repro_torch.launch.serve",
             "repro_torch.streaming", "repro_torch.streaming.service",
             "repro_torch.streaming.ingest", "repro_torch.streaming.windows",
             "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
             "repro_torch.distributed", "repro_torch.distributed.mesh",
             "repro_torch.distributed.wire",
             "repro_torch.distributed.compression",
             "repro_torch.core.skew", "repro_torch.distributed.fault",
             "repro_torch.distributed.coordination",
             "repro_torch.distributed.chaos",
             "repro_torch.distributed.elastic",
             "repro_torch.data.pipeline", "repro_torch.training",
             "repro_torch.training.losses", "repro_torch.training.optim",
             "repro_torch.training.grad_accum",
             "repro_torch.training.train_step", "repro_torch.launch.train",
             "repro_torch.configs.qwen1p5_32b",
             "repro_torch.configs.qwen2p5_14b",
             "repro_torch.configs.gemma2_27b", "repro_torch.models.moe",
             "repro_torch.configs.qwen3_moe_30b_a3b",
             "repro_torch.configs.llama4_scout_17b_a16e",
             "repro_torch.configs.internvl2_26b", "repro_torch.models.ssm",
             "repro_torch.models.mamba", "repro_torch.models.hybrid",
             "repro_torch.models.whisper",
             "repro_torch.configs.mamba2_2p7b",
             "repro_torch.configs.zamba2_1p2b",
             "repro_torch.configs.whisper_medium",
             "repro_torch.distributed.sharding",
             "repro_torch.distributed.act_sharding",
             "repro_torch.launch.mesh", "repro_torch.launch.dryrun"):
    assert name in names, name
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
# the dry-run's tools load inside the functions that use them
for name in ("torch.testing._internal.distributed.fake_pg",
             "torch.distributed._tools.mem_tracker"):
    assert name not in sys.modules, name
from repro_torch.kernels import _build
assert not _build._libs
print(len(names))
"""


def test_every_module_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 81


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
    assert len(paths) >= 75
    for path in paths:
        for mod in _imported(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                path, mod)

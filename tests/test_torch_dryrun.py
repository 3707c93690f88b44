"""The dry-run (``repro_torch.launch.dryrun``) on a fake process group.

The reference's ``test_dryrun_smallmesh_train_and_decode`` cells,
llama3-8b × train_4k and qwen3-moe-30b-a3b × decode_32k at full width, on a
``(2, 2)`` ``("data", "model")`` mesh of a ``"fake"`` group of 4 ranks, in
a subprocess (so that no default group outlives it): each row ``ok``, its
argument bytes equal to the specs' arithmetic on a shape-only 2 × 2 mesh
(each leaf's dims divided by the sizes of the axes that shard them: the
optimizer state and the whole batch for train, the parameters, the decode
state and the tokens for decode), no CUDA context made, the decode step's
attention traced through ``flash_decode``'s fake implementation, and its
memory and roofline fields consistent.  An unknown architecture is an
``error`` row and ``main`` returns 1.  The reference's own dry-run is no
oracle here (ROADMAP C.3).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.ckpt import flatten  # noqa: E402
from repro_torch.configs import (SHAPES, default_kv_dtype, get_config,  # noqa: E402
                                 input_specs, state_specs)
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.training.train_step import abstract_train_state  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
CELLS = (("llama3-8b", "train_4k"), ("qwen3-moe-30b-a3b", "decode_32k"))

SCRIPT = """
import json, sys
import torch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
dryrun.fake_world(4)
mesh = make_test_mesh(2, 2)
rows = [dryrun.run_cell(a, s, "2x2", mesh=mesh, verbose=False)
        for a, s in json.loads(sys.argv[1])]
rc = dryrun.main(["--arch", "gpt-2", "--shape", "train_4k"])
print("ROWS " + json.dumps({"rows": rows, "unknown_rc": rc}))
"""


class TwoByTwo:
    shape = {"data": 2, "model": 2}


def _nbytes(tree, specs) -> int:
    """One rank's bytes of ``tree`` under ``specs``; the decode state's
    position, a 0-d int32 in ``state_specs`` (the reference's aval), is a
    Python int on the host in the port's state: no device bytes."""
    total = 0
    for (keys, x), sp in zip(shd.leaves_with_paths(tree), flatten(specs)[0]):
        if isinstance(x, torch.Tensor) and keys[-1:] != ("pos",):
            n = 1
            for d in shd.local_shape(x.shape, sp, TwoByTwo):
                n *= d
            total += n * x.element_size()
    return total


def _spec_argument_bytes(arch, shape_name) -> int:
    cfg, shape = get_config(arch), SHAPES[shape_name]
    model = get_model(cfg)
    inputs = input_specs(cfg, shape)
    if shape.kind == "train":
        opt = abstract_train_state(model)
        return (_nbytes(opt, shd.param_pspecs(opt, TwoByTwo))
                + _nbytes(inputs, shd.batch_pspecs(inputs, TwoByTwo)))
    params = model.abstract_params()
    state = state_specs(cfg, shape,
                        kv_dtype=default_kv_dtype(arch, shape_name))
    return (_nbytes(params, shd.param_pspecs(params, TwoByTwo, fsdp=False))
            + _nbytes(state, shd.decode_state_pspecs(state, TwoByTwo, cfg))
            + _nbytes(inputs["tokens"],
                      shd.tokens_pspec(shape.global_batch, TwoByTwo)))


@pytest.fixture(scope="module")
def rows():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(SCRIPT),
                          json.dumps(CELLS)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("ROWS ")]
    assert line, out.stdout[-2000:]
    return json.loads(line[-1][5:])


@pytest.mark.parametrize("i", range(len(CELLS)))
def test_cell_is_ok_with_the_specs_argument_bytes(rows, i):
    r = rows["rows"][i]
    arch, shape = CELLS[i]
    assert (r["arch"], r["shape"], r["status"]) == (arch, shape, "ok"), r
    assert r["memory"]["argument_bytes"] == _spec_argument_bytes(arch, shape)
    assert r["cuda_initialized"] is False
    n = sum(x.numel() for x in flatten(
        get_model(get_config(arch)).abstract_params())[0])
    assert r["n_params"] == n and 0 < r["n_active"] <= n


@pytest.mark.parametrize("i", range(len(CELLS)))
def test_cell_memory_and_roofline_are_consistent(rows, i):
    r = rows["rows"][i]
    mem, rl = r["memory"], r["roofline"]
    assert mem["alias_bytes"] == mem["output_bytes"] > 0
    assert mem["temp_bytes"] > 0
    peak = (mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
            - mem["alias_bytes"])
    assert mem["peak_per_chip_gib"] == round(peak / 2**30, 3)
    assert mem["fits"] == (peak <= 80e9)
    assert rl["chips"] == 4 and rl["flops_per_chip"] > 0
    assert rl["bytes_per_chip"] > 0 and rl["collective_bytes_per_chip"] > 0
    assert rl["dominant"] in ("compute", "memory", "collective")
    assert rl["step_s"] == max(rl["compute_s"], rl["memory_s"],
                               rl["collective_s"])
    assert "all-gather" in rl["collective_ops"]


def test_train_cell_counts_its_microbatches(rows):
    r = rows["rows"][0]
    assert r["microbatches"] == 16  # 256 rows, 128 a DP rank
    ops = r["roofline"]["collective_ops"]
    assert ops["reduce-scatter"]["bytes"] > 0
    # a step runs 6·N·D model flops over 4 chips; the model axis's two
    # ranks compute the same rows, the layers' attention and remat more
    assert r["roofline"]["useful_ratio"] < 1.0


def test_decode_cell_traces_flash_decode(rows):
    r = rows["rows"][1]
    assert r["attention"] == "flash_decode"
    # one call a layer of qwen3-moe-30b-a3b's decode step
    assert r["traced_ops"]["repro_torch::flash_decode"] == 48
    assert "microbatches" not in r
    assert rows["rows"][0]["attention"] == "plain"


def test_unknown_architecture_is_an_error_row_and_exit_one(rows):
    assert rows["unknown_rc"] == 1

"""The sharded train step (ZeRO-3 over the reference's layouts), the
shards it keeps and the elastic restore, over gloo process groups on the
CPU, against the port's unsharded step and the reference.

Each process group lives in subprocesses, one a rank (as
``test_torch_distributed.py``'s gloo tests), so no default group is left
behind in the test process; one group at world size 1 is made and
destroyed in the test itself.

* At 2 ranks, a ``(2, 1)`` ``("data", "model")`` mesh, and at 4 ranks, a
  ``(2, 2)`` mesh and a ``(2, 1, 2)`` ``("pod", "data", "model")`` one
  (tuple axes): three steps of reduced llama3-8b (combiner and
  materialize accumulation) and reduced qwen3-moe-30b-a3b from the
  reference's initial state, each loss and grad norm within rtol 1e-4 and
  the master parameters within atol 1e-5 of the port's unsharded step and
  of the reference's jitted one (``test_train_step_against_reference``'s
  bounds); the same sharded run twice gives the same bits.
* Each rank's shard of the distributed master parameters equals the
  reference's ``jax.device_put(params, NamedSharding(mesh, spec))`` shard
  of the same index range (by index, not device order; a 4-device JAX
  subprocess).
* A state saved from ``(2, 2)`` at 4 ranks and ``elastic_restore``-d onto
  ``(1, 2)`` at 2 ranks is bit for bit the state saved (the counterpart
  of ``tests/integration/test_distributed.py::test_elastic_reshard_8_to_4``).
* At world size 1 the sharded step is the unsharded one bit for bit.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402
from repro.training import train_step as jtrain  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint.ckpt import flatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.training import train_step  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
STEPS = 3
SEQ = 16
#: (arch, TrainConfig overrides)
CASES = {"llama3-8b": ("llama3-8b", {}),
         "llama3-8b-materialize": ("llama3-8b",
                                   {"accum_mode": "materialize"}),
         "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {})}
#: world size -> the meshes its ranks run (shape, axis names, cases)
MESHES = {2: [((2, 1), ("data", "model"), tuple(CASES))],
          4: [((2, 2), ("data", "model"), tuple(CASES)),
              ((2, 1, 2), ("pod", "data", "model"), ("llama3-8b",))]}
LOSS_TOL = dict(rtol=1e-4)
MASTER_TOL = dict(rtol=0, atol=1e-5)


def _tc(over):
    return dict(num_microbatches=2, vocab_chunk=48, warmup_steps=1,
                total_steps=50, **over)


def _batches(vocab):
    dc = jpipe.DataConfig(vocab_size=vocab, seq_len=SEQ, global_batch=4)
    return [jpipe.global_batch(dc, i) for i in range(STEPS)]


WORKER = """
import sys, pickle, numpy as np, torch, torch.distributed as dist
rank, world, port, path = (int(sys.argv[1]), int(sys.argv[2]),
                           int(sys.argv[3]), sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import interop
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import flatten
from repro_torch.configs import get_config
from repro_torch.distributed import elastic, sharding as shd
from repro_torch.models.registry import get_model
from repro_torch.training import train_step as ts

with open(path + "/job.pkl", "rb") as f:
    job = pickle.load(f)
out = {"runs": {}, "shards": {}}

def shards_of(tree):
    # (global offset, data) of each leaf's shard on this rank
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    return [(tuple(int(o) for o in compute_local_shape_and_global_offset(
                x.shape, x.device_mesh, x.placements)[1]),
             x.to_local().numpy().copy()) for x in flatten(tree)[0]]

for shape, names, cases in job["meshes"]:
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    tag = "x".join(map(str, shape))
    for case in cases:
        arch, over = job["cases"][case]
        cfg = get_config(arch).reduced()
        model = get_model(cfg)
        tc = ts.TrainConfig(**over)
        init = job["init"][arch]
        rows = []
        for rep in range(2):
            state = interop.train_state_from_repro(cfg, init, device="cpu")
            state = shd.distribute(state, shd.param_shardings(state, mesh))
            if rep == 0 and case == cases[0]:
                out["shards"][tag] = shards_of(state["master"])
            step = ts.make_train_step(
                model, tc, param_pspecs=shd.param_pspecs(
                    model.abstract_params(), mesh),
                batch_pspecs=shd.batch_pspecs(job["batches"][arch][0], mesh))
            got = []
            for b in job["batches"][arch]:
                state, m = step(state, b)
                master = [x.full_tensor().numpy().copy() for x in
                          flatten(state["master"])[0]]
                got.append((float(m["loss"]), float(m["grad_norm"]),
                            master, int(state["step"].full_tensor())
                            if hasattr(state["step"], "full_tensor")
                            else int(state["step"])))
            rows.append(got)
        same = all(a[0] == b[0] and a[1] == b[1] and all(
            np.array_equal(x, y) for x, y in zip(a[2], b[2]))
            for a, b in zip(*rows))
        out["runs"][(tag, case)] = {"rows": rows[0], "repeat_bits": same}
    if job.get("save") == tag:  # the elastic source: the llama state
        cfg = get_config("llama3-8b").reduced()
        state = interop.train_state_from_repro(cfg, job["init"]["llama3-8b"],
                                               device="cpu")
        state = shd.distribute(state["master"],
                               shd.param_shardings(state["master"], mesh))
        ckpt.save(path + "/ckpt", 7, state)
if job.get("restore"):
    shape, names = job["restore"]
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    cfg = get_config("llama3-8b").reduced()
    example = get_model(cfg).abstract_params()
    tree, step = elastic.elastic_restore(path + "/ckpt", example, mesh)
    out["restored"] = {"step": step, "shards": shards_of(tree),
                       "whole": [x.full_tensor().numpy().copy()
                                 for x in flatten(tree)[0]]}
with open(path + f"/out{rank}.pkl", "wb") as f:
    pickle.dump(out, f)
dist.barrier()
dist.destroy_process_group()
print("RANK_OK", rank)
"""

REFERENCE_SHARDS = """
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax
from jax.sharding import Mesh, NamedSharding
from repro.distributed import sharding as jshd
path = sys.argv[1]
with open(path + "/job.pkl", "rb") as f:
    job = pickle.load(f)
params = job["init"]["llama3-8b"]["master"]
devs = jax.devices()
out = {}
for shape, names in job["ref_meshes"]:
    n = int(np.prod(shape))
    mesh = Mesh(np.asarray(devs[:n]).reshape(shape), names)
    specs = jshd.param_pspecs(params, mesh)
    placed = jax.device_put(params, jax.tree.map(
        lambda s: NamedSharding(mesh, s), specs))
    leaves = jax.tree.leaves(placed)
    out["x".join(map(str, shape))] = [
        {tuple((sl.start or 0) for sl in sh.index): np.asarray(sh.data)
         for sh in leaf.addressable_shards} for leaf in leaves]
with open(path + "/ref_shards.pkl", "wb") as f:
    pickle.dump(out, f)
print("REF_OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(world, path):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, str(path / "worker.py"), str(r), str(world),
         str(port), str(path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def _finish(procs, timeout=150):
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-4000:]


def _load(path, world):
    import pickle

    out = []
    for r in range(world):
        with open(path / f"out{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs (initial state, then per step loss, grad norm
    and master), the port's unsharded runs, and the gloo groups'
    outputs."""
    import pickle

    init, ref, port, batches = {}, {}, {}, {}
    for arch, _ in CASES.values():
        if arch not in init:
            jcfg = jget_config(arch).reduced()
            state = jtrain.init_train_state(jget_model(jcfg),
                                            jax.random.PRNGKey(0))
            init[arch] = jax.tree.map(np.asarray, state)
            batches[arch] = _batches(jcfg.vocab_size)
    base = {"cases": {k: (a, _tc(o)) for k, (a, o) in CASES.items()},
            "init": init, "batches": batches}
    paths, procs = {}, {}
    for world in (2, 4):  # the gloo groups run while the references do
        d = tmp_path_factory.mktemp(f"gloo{world}")
        job = dict(base, meshes=MESHES[world])
        if world == 4:
            job["save"] = "2x2"
        with open(d / "job.pkl", "wb") as f:
            pickle.dump(job, f)
        (d / "worker.py").write_text(textwrap.dedent(WORKER))
        paths[world] = d
        procs[world] = _launch(world, d)
    rdir = tmp_path_factory.mktemp("ref_shards")
    with open(rdir / "job.pkl", "wb") as f:
        pickle.dump({"init": init, "ref_meshes": [
            (s, n) for w in (2, 4) for s, n, _ in MESHES[w]]}, f)
    (rdir / "ref.py").write_text(textwrap.dedent(REFERENCE_SHARDS))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    ref_proc = subprocess.Popen([sys.executable, str(rdir / "ref.py"),
                                 str(rdir)], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    for case, (arch, over) in CASES.items():
        jmodel = jget_model(jget_config(arch).reduced())
        step = jax.jit(jtrain.make_train_step(
            jmodel, jtrain.TrainConfig(**_tc(over))))
        state = jax.tree.map(jax.numpy.asarray, init[arch])
        rows = []
        for b in batches[arch]:
            state, m = step(state, b)
            rows.append((float(m["loss"]), float(m["grad_norm"]),
                         [np.asarray(x) for x in
                          jax.tree.leaves(state["master"])],
                         int(state["step"])))
        ref[case] = rows
        cfg = get_config(arch).reduced()
        tstep = train_step.make_train_step(
            get_model(cfg), train_step.TrainConfig(**_tc(over)))
        tstate = interop.train_state_from_repro(cfg, init[arch], device="cpu")
        rows = []
        for b in batches[arch]:
            tstate, m = tstep(tstate, b)
            rows.append((float(m["loss"]), float(m["grad_norm"]),
                         [x.numpy().copy() for x in
                          flatten(tstate["master"])[0]], int(tstate["step"])))
        port[case] = rows
    for world in (2, 4):
        _finish(procs[world])
    _finish([ref_proc])
    # the elastic restore: the 4-rank checkpoint onto (1, 2) at 2 ranks
    d = tmp_path_factory.mktemp("elastic2")
    os.symlink(paths[4] / "ckpt", d / "ckpt")
    with open(d / "job.pkl", "wb") as f:
        pickle.dump(dict(base, meshes=[], restore=((1, 2),
                                                   ("data", "model"))), f)
    (d / "worker.py").write_text(textwrap.dedent(WORKER))
    _finish(_launch(2, d))
    with open(rdir / "ref_shards.pkl", "rb") as f:
        ref_shards = pickle.load(f)
    return {"ref": ref, "port": port, "init": init,
            "gloo": {w: _load(paths[w], w) for w in (2, 4)},
            "elastic": _load(d, 2), "ref_shards": ref_shards}


RUN_IDS = [(w, "x".join(map(str, shape)), case)
           for w, meshes in MESHES.items() for shape, _, cases in meshes
           for case in cases]


@pytest.mark.parametrize("world,tag,case", RUN_IDS)
def test_sharded_step_matches_unsharded_and_reference(runs, world, tag,
                                                      case):
    got = runs["gloo"][world][0]["runs"][(tag, case)]
    assert got["repeat_bits"], "two sharded runs differ"
    for label in ("port", "ref"):
        for (loss, gn, master, step), (wl, wg, wm, ws) in zip(
                got["rows"], runs[label][case]):
            np.testing.assert_allclose(loss, wl, **LOSS_TOL, err_msg=label)
            np.testing.assert_allclose(gn, wg, **LOSS_TOL, err_msg=label)
            assert step == ws
            assert len(master) == len(wm)
            for a, w in zip(master, wm):
                np.testing.assert_allclose(a, w, **MASTER_TOL,
                                           err_msg=label)
    # every rank reports the same whole state and metrics
    for other in runs["gloo"][world][1:]:
        o = other["runs"][(tag, case)]["rows"]
        for a, b in zip(got["rows"], o):
            assert a[0] == b[0] and a[1] == b[1]
            assert all(np.array_equal(x, y) for x, y in zip(a[2], b[2]))


SHARD_IDS = [(w, "x".join(map(str, s))) for w, m in MESHES.items()
             for s, _, _ in m]


@pytest.mark.parametrize("world,tag", SHARD_IDS)
def test_each_rank_holds_the_reference_shard_of_its_index_range(runs, world,
                                                                tag):
    ref = runs["ref_shards"][tag]
    for rank_out in runs["gloo"][world]:
        shards = rank_out["shards"][tag]
        assert len(shards) == len(ref)
        for (offset, data), leaf in zip(shards, ref):
            assert offset in leaf, (offset, sorted(leaf))
            want = leaf[offset]
            assert data.shape == want.shape
            assert data.tobytes() == want.tobytes()


def test_elastic_restore_from_four_ranks_onto_two_is_bit_for_bit(runs):
    want = [np.asarray(x) for x in
            jax.tree.leaves(runs["init"]["llama3-8b"]["master"])]
    for rank, out in enumerate(runs["elastic"]):
        r = out["restored"]
        assert r["step"] == 7
        assert len(r["whole"]) == len(want)
        for got, w in zip(r["whole"], want):
            assert got.dtype == w.dtype and got.tobytes() == w.tobytes()
        for (offset, data), w in zip(r["shards"], want):
            sl = tuple(slice(o, o + n) for o, n in zip(offset, data.shape))
            assert data.tobytes() == np.ascontiguousarray(w[sl]).tobytes()
    # the two ranks split the model axis: their shards differ somewhere
    a, b = (out["restored"]["shards"] for out in runs["elastic"])
    assert any(x[0] != y[0] for x, y in zip(a, b))


def test_sharded_step_at_world_one_is_the_unsharded_step_bit_for_bit(
        tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.data import pipeline
    from repro_torch.distributed import sharding as shd

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = get_config("llama3-8b").reduced()
        model = get_model(cfg)
        tc = train_step.TrainConfig(**_tc({}))
        dc = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                 global_batch=4)
        batches = [pipeline.global_batch(dc, i) for i in range(STEPS)]
        a, b = (train_step.init_train_state(
            model, torch.Generator().manual_seed(0)) for _ in range(2))
        b = shd.distribute(b, shd.param_shardings(b, mesh))
        plain = train_step.make_train_step(model, tc)
        sharded = train_step.make_train_step(
            model, tc, param_pspecs=shd.param_pspecs(a["master"], mesh))
        for batch in batches:
            a, ma = plain(a, batch)
            b, mb = sharded(b, batch)
            for k in ("loss", "grad_norm", "xent"):
                assert float(ma[k]) == float(mb[k]), k
        for k in ("master", "m", "v"):
            for x, y in zip(flatten(a[k])[0], flatten(b[k])[0]):
                assert torch.equal(x, y.to_local())
        assert int(b["step"].to_local()) == int(a["step"]) == STEPS
        assert set(sharded.comm) == {"all_gather", "reduce_scatter",
                                     "all_reduce"}
        # the activation hints lay a DTensor out as the reference pins it
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor

        from repro_torch.distributed import act_sharding as acts

        x = distribute_tensor(torch.zeros(2, 2, 1, 4, 4), mesh,
                              [Replicate(), Replicate()])
        try:
            acts.set_mesh(mesh)
            assert acts.attn_weights(x).placements == (Shard(0), Shard(1))
            assert acts.batch_major(x).placements == (Shard(0), Replicate())
            assert acts.seq_major(x, 3).placements == (Shard(0), Shard(3))
        finally:
            acts.clear()
    finally:
        dist.destroy_process_group()

"""The port's op trace (``repro_torch.roofline.op_trace``) against the
reference's HLO cost parser (``repro.roofline.hlo_parser``) on the CPU.

Counterparts of ``tests/roofline/test_hlo_parser.py`` (matmul FLOPs, a loop
counted L times, a slice write counted at the slice, the ring factors, a
round trip), and of the bytes claims the reference checks with its parser
(``tests/test_system.py``, ``tests/core/test_stream.py``: the flows' byte
ordering and the stream flow's peak) on the same WordCount inputs.  Then
the port's own contracts: each kernel entry point is one op whose bytes
are its tensors in and out, a mesh collective is one op with the same
wire bytes a shard on a ``LocalMesh`` and over gloo, the sort flow's
all-to-all is ``roofline.shuffle_wire_bytes``, and the dry-run's traced
collectives equal the sharded step's own count.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import MapReduce as JMapReduce  # noqa: E402
from repro.core import MapReduceApp as JMapReduceApp  # noqa: E402
from repro.roofline import hlo_parser  # noqa: E402

import repro_torch as T  # noqa: E402
from repro_torch.distributed import LocalMesh  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402
from repro_torch.roofline import op_trace  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
VOCAB = 512
I32 = torch.int32


# ---------------------------------------------------------------------------
# The parser's own cases
# ---------------------------------------------------------------------------


def _cost(fn, *args):
    _, tr = op_trace.trace(fn, *args)
    return op_trace.analyze_trace(tr)


def test_matmul_flops_within_one_percent_of_hlo_parser():
    n = 256
    ref = hlo_parser.analyze_text(jax.jit(lambda x: jnp.tanh(x @ x)).lower(
        jax.ShapeDtypeStruct((n, n), jnp.float32)).compile().as_text())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (n, n)).astype(np.float32))
    got = _cost(lambda: torch.tanh(x @ x))
    assert abs(got.flops - ref.flops) / ref.flops < 0.01, (got.flops,
                                                           ref.flops)
    assert got.flops_by_op["aten::mm"] == 2 * n ** 3


def test_a_loop_and_repeat_count_l_times_one_step():
    n, L = 256, 12
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (n, n)).astype(np.float32)) / n

    def one(c):
        return torch.tanh(c @ c)

    def loop():
        c = x
        for _ in range(L):
            c = one(c)
        return c

    def repeated():
        with op_trace.repeat(L):
            return one(x)

    c0 = _cost(one, x)
    for fn in (loop, repeated):
        c1 = _cost(fn)
        for a, b in ((c1.flops, c0.flops), (c1.bytes_accessed,
                                             c0.bytes_accessed)):
            assert abs(a - L * b) / (L * b) < 0.02, (fn.__name__, a, b)
    # outside a trace, repeat and loop do nothing
    with op_trace.repeat(3), op_trace.loop("microbatch"):
        assert one(x).shape == (n, n)


def test_a_slice_write_counts_the_slice_not_the_buffer():
    buf = torch.zeros(1 << 20)  # 4 MiB
    upd = torch.ones(8)
    c = _cost(lambda: buf.narrow(0, 5, 8).copy_(upd))
    assert c.bytes_accessed < 1 << 16, c.bytes_by_op
    assert c.bytes_accessed == 2 * 8 * 4  # the slice written, the update read


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("op", ["all-reduce", "all-gather", "reduce-scatter",
                                "all-to-all", "collective-permute"])
def test_wire_factor_equals_the_reference(op, n):
    assert op_trace._wire_factor(op, n) == hlo_parser._wire_factor(op, n)


def test_round_trip_finds_the_matmul():
    x = torch.ones(64, 64)
    out, tr = op_trace.trace(lambda: torch.sum(torch.exp(x) @ x))
    assert float(out) == pytest.approx(64 ** 3 * np.e)
    names = [op.name for op in tr.ops]
    assert "aten::mm" in names and tr.count("aten::mm") == 1
    assert analysis.collective_stats(tr, 4) == (0.0, {})


# ---------------------------------------------------------------------------
# The paper's bytes claims, on the reference's WordCount inputs
# ---------------------------------------------------------------------------


class JWordCount(JMapReduceApp):
    key_space = VOCAB
    value_aval = jax.ShapeDtypeStruct((), jnp.int32)
    emit_capacity = 8
    max_values_per_key = 1024

    def map(self, window, emit):
        emit(window, jnp.ones_like(window))

    def reduce(self, key, values, count):
        return jnp.sum(values)


class WordCount(T.MapReduceApp):
    key_space = VOCAB
    value_spec = T.ValueSpec((), I32)
    emit_capacity = 8
    max_values_per_key = 1024

    def map(self, window, emit):
        emit(window, torch.ones_like(window))

    def reduce(self, key, values, count):
        return values.sum()


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(
        np.int32)


def _ref_chunk(toks) -> int:
    """The stream chunk the reference's tiling picks for these items."""
    return JMapReduce(JWordCount(), flow="stream").plan.tiling.chunk_pairs


def _traced(flow, toks, chunk="auto"):
    mr = T.MapReduce(WordCount(), flow=flow, device="cpu",
                     stream_chunk_pairs=chunk)
    return mr.lower(torch.from_numpy(toks)).compile().traced_cost(
        torch.from_numpy(toks))


def test_flow_bytes_order_against_the_reference():
    """The reference's parser gives stream <= combine < reduce on
    ``tests/core/test_stream.py``'s tokens (XLA fuses the stream flow's
    carried table into its one fusion, so stream == combine there).  The
    port's trace gives the same order: its integer stream fold is one
    ``int_fold`` op a chunk (keys, rows and the carried table and counts
    in and out), under the combine flow's masked scatter and counts."""
    toks = _tokens((128, 8), 0)
    ref = {f: hlo_parser.analyze_text(JMapReduce(JWordCount(), flow=f).lower(
        jnp.asarray(toks)).compile().as_text()).bytes_accessed
        for f in ("stream", "combine", "reduce")}
    assert ref["stream"] <= ref["combine"] < ref["reduce"], ref
    chunk = _ref_chunk(toks)
    got = {f: _traced(f, toks, chunk).bytes_accessed
           for f in ("stream", "combine", "reduce")}
    assert got["stream"] <= got["combine"] < got["reduce"], got


def test_auto_moves_fewer_bytes_than_reduce():
    """``tests/test_system.py``'s step 3: the optimizer's flow (the stream
    flow for a derivable reducer) moves fewer bytes than the reduce
    flow."""
    toks = _tokens((128, 8), 0)
    auto = T.MapReduce(WordCount(), flow="auto", device="cpu")
    assert auto.plan.flow == "stream"
    assert _traced("auto", toks).bytes_accessed < _traced(
        "reduce", toks).bytes_accessed


def test_stream_peak_under_half_the_combine_peak():
    """``test_stream_peak_residency_bounded``'s inputs at the reference's
    stream chunk: the stream flow's peak is O(K + chunk), the combine
    flow's grows with the whole pair stream."""
    toks = _tokens((4096, 8), 4)
    chunk = _ref_chunk(toks)
    assert chunk < toks.size
    stream = _traced("stream", toks, chunk).peak_bytes
    combine = _traced("combine", toks, chunk).peak_bytes
    assert 0 < stream < combine / 2, (stream, combine)


# ---------------------------------------------------------------------------
# Kernels and collectives: one op each
# ---------------------------------------------------------------------------


def _pairs(n=512, K=64, d=3, seed=0):
    rng = np.random.default_rng(seed)
    keys = torch.from_numpy(rng.integers(0, K, n).astype(np.int32))
    vals = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    return keys, vals


def _kernel_calls():
    K = 64
    keys, vals = _pairs(K=K)
    acc = torch.zeros(K, 3)
    sk, order = torch.sort(keys.to(torch.int64), stable=True)
    sk, sv = sk.to(I32), vals[order]
    q = torch.randn(2, 4, 16)
    kv = torch.randn(2, 40, 2, 16)
    kv_len = torch.tensor([40, 17], dtype=I32)
    return {
        "onehot_fold": (ops.onehot_fold, (keys, vals, acc), {}),
        "chunk_monoid_fold": (ops.chunk_monoid_fold, (keys, vals, acc, "max"),
                              {}),
        "radix_partition": (ops.radix_partition, (keys, vals, K),
                            {"bucket_size": 16}),
        "radix_partition_multi": (ops.radix_partition, (keys, vals, K),
                                  {"bucket_size": 8, "fanouts": (2, 4)}),
        "segment_reduce": (ops.segment_reduce, (sk, sv, K, "add"),
                           {"acc": acc}),
        "onehot_combine": (ops.onehot_combine, (keys, vals, K), {}),
        "combine_scatter": (ops.combine_scatter, (keys, vals, K, "min"), {}),
        "flash_decode": (ops.flash_decode, (q, kv, kv.clone(), kv_len), {}),
        "int_fold": (ops.int_fold, (keys, torch.ones(512, 2, dtype=I32),
                                    torch.zeros(K, 2, dtype=torch.int64),
                                    torch.zeros(K, dtype=I32)), {}),
    }


@pytest.mark.parametrize("name", list(_kernel_calls()))
def test_each_kernel_entry_point_is_one_op_of_its_tensors(name):
    fn, args, kw = _kernel_calls()[name]
    want = fn(*args, **kw)
    out, tr = op_trace.trace(fn, *args, **kw)
    for a, b in zip(torch.utils._pytree.tree_leaves(out),
                    torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(a, b)
    (op,) = tr.ops  # the plain version's ATen ops are hidden
    assert op.name == f"repro_torch::{name}"
    ins = [x for x in torch.utils._pytree.tree_leaves((args, kw))
           if isinstance(x, torch.Tensor)]
    outs = torch.utils._pytree.tree_leaves(out)
    assert op.in_bytes == sum(x.numel() * x.element_size() for x in ins)
    assert op.out_bytes == sum(x.numel() * x.element_size() for x in outs)
    cost = op_trace.analyze_trace(tr)
    assert cost.bytes_accessed == op.in_bytes + op.out_bytes
    if name == "flash_decode":
        assert cost.flops == 4 * 2 * 4 * 40 * 16
    elif name == "int_fold":  # an add a pair and column, and its count
        assert cost.flops == 512 * (2 + 1)
    else:
        assert cost.flops == args[1].numel()


def test_the_sort_fold_records_its_two_kernels():
    keys, vals = _pairs(K=256)
    acc = torch.zeros(256, 3)
    _, tr = op_trace.trace(ops.sort_segment_fold, keys, vals, acc, "add",
                           bucket_size=64)
    assert [op.name for op in tr.ops] == ["repro_torch::radix_partition",
                                          "repro_torch::segment_reduce"]


def test_an_idle_hook_calls_through_and_stays_cheap():
    seen = []

    def f(x):
        seen.append(torch._C._len_torch_dispatch_stack())
        return x

    assert op_trace.kernel("onehot_fold", f, 1) == 1 and seen == [0]
    n = 20000

    def per_call(fn):
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            best = min(best, (time.perf_counter() - t0) / n)
        return best

    def g():
        return None

    hooked = per_call(lambda: op_trace.kernel("onehot_fold", g))
    plain = per_call(lambda: g())
    assert hooked - plain < 2e-6, (hooked, plain)


def _wc(vocab=64):
    return T.make_app(lambda item, emit: emit(item, torch.ones_like(item)),
                      lambda k, v, c: v.sum(), key_space=vocab,
                      value_spec=T.ValueSpec((), I32), emit_capacity=8,
                      max_values_per_key=1024)


def _dist_wire(mesh, flow, toks):
    mr = T.MapReduce(_wc(), flow=flow, device="cpu")
    cost = mr.lower(toks, options=T.ExecutionOptions(
        mesh=mesh)).traced_cost(toks)
    return {k: v["bytes"] for k, v in cost.collective_ops.items()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


GLOO = """
import json, sys, numpy as np, torch, torch.distributed as dist
rank, port = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
exec(sys.argv[3])
from repro_torch.distributed import ProcessGroupMesh
toks = torch.from_numpy(np.random.default_rng(3).integers(
    0, 64, (64, 8)).astype(np.int32))
out = {f: _dist_wire(ProcessGroupMesh(), f, toks) for f in
       ("stream", "sort", "reduce")}
dist.barrier()
dist.destroy_process_group()
print("WIRE " + json.dumps(out))
"""


def test_local_mesh_and_gloo_trace_equal_wire_bytes_a_shard():
    import inspect

    helpers = "\n".join(inspect.getsource(f) for f in (_wc, _dist_wire))
    helpers = "import repro_torch as T\nI32 = torch.int32\n" + helpers
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(GLOO), str(r), str(port),
         helpers], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    got = []
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-4000:]
        got.append(json.loads([ln for ln in so.splitlines()
                               if ln.startswith("WIRE ")][-1][5:]))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 64, (64, 8)).astype(np.int32))
    want = {f: _dist_wire(LocalMesh(2, "cpu"), f, toks)
            for f in ("stream", "sort", "reduce")}
    assert got[0] == got[1] == want
    assert want["stream"]["all-reduce"] > 0  # the counts' psum
    assert want["sort"]["all-to-all"] > 0


def test_sort_flow_all_to_all_is_the_shuffle_model():
    from repro_torch.core import skew as TSK

    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (256, 8)).astype(np.int32))
    for codec in ("raw", "delta"):
        mr = T.MapReduce(_wc(256), flow="sort", device="cpu")
        cost = mr.lower(toks, options=T.ExecutionOptions(
            mesh=LocalMesh(4, "cpu"), shuffle=TSK.ShuffleOptions(
                wire=codec, capacity=2048))).traced_cost(toks)
        model = analysis.shuffle_wire_bytes(
            codec, n_pairs=toks.numel(), key_space=256, num_shards=4,
            value_bytes=4, value_dtype="int32", capacity=2048)
        assert cost.collective_ops["all-to-all"]["bytes"] == model > 0


def test_stream_wire_bytes_do_not_grow_with_the_items():
    small = torch.from_numpy(_tokens((64, 8), 1) % 64)
    large = torch.from_numpy(_tokens((256, 8), 1) % 64)
    mesh = LocalMesh(2, "cpu")
    s0, s1 = (sum(_dist_wire(mesh, "stream", t).values())
              for t in (small, large))
    r0, r1 = (sum(_dist_wire(mesh, "reduce", t).values())
              for t in (small, large))
    assert s0 == s1 > 0 and r1 > r0 > 0


def test_compiled_traced_cost_is_one_call_and_cost_analysis_runs_none():
    toks = torch.from_numpy(_tokens((128, 8), 0))
    comp = T.MapReduce(WordCount(), flow="combine", device="cpu").lower(
        toks).compile()
    cost = comp.traced_cost(toks)
    _, tr = op_trace.trace(comp, toks)
    assert cost.bytes_accessed == op_trace.analyze_trace(tr).bytes_accessed
    assert cost.peak_bytes > 0 and cost.top_bytes(3)
    # the model's arithmetic only: no op touches a pair-sized tensor
    _, tr = op_trace.trace(comp.cost_analysis)
    assert all(op.in_bytes + op.out_bytes < toks.numel() * 4
               for op in tr.ops), tr.ops
    assert set(comp.memory_analysis()) == {"model_peak_bytes",
                                           "warmup_peak_bytes"}


# ---------------------------------------------------------------------------
# The dry-run's collectives
# ---------------------------------------------------------------------------

DRYRUN = """
import json
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Shard
from repro_torch.checkpoint.ckpt import flatten
from repro_torch.distributed import act_sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.roofline import op_trace
from repro_torch.training.grad_accum import derive_grad_combiner

dims, axes = dryrun.MESHES["pod"]
dryrun.fake_world(256)
mesh = make_mesh(dims, axes)
derive_grad_combiner()


def wire(ops):
    c = op_trace.analyze_trace(op_trace.Trace(tuple(ops)))
    return {k: v["bytes"] for k, v in c.collective_ops.items()}


def nbytes(x):
    return x.numel() * x.element_size()


out = {}
for arch, shape in (("llama3-8b", "train_4k"),
                    ("qwen3-moe-30b-a3b", "decode_32k")):
    with FakeTensorMode():
        cell = dryrun.build_cell(arch, shape, mesh)
        mb = cell.get("microbatches", 1)

        def step():
            with op_trace.trips(microbatch=mb):
                return cell["fn"](*cell["args"])

        _, tr = op_trace.trace(step)
        traced = wire(o for o in tr.ops
                      if o.name.startswith("_c10d_functional::"))
        scalars = wire(o for o in tr.ops if o.name.startswith("c10d::"))
        if "microbatches" in cell:  # the sharded step's own count
            hand = cell["fn"].comm
            want = {"all-gather": hand["all_gather"],
                    "reduce-scatter": mb * hand["reduce_scatter"],
                    "all-reduce": mb * hand["all_reduce"]}
        else:  # the serve step's gathers, from the layouts
            params, state, _ = cell["args"]
            gather = 0.0
            for x in flatten(params)[0]:
                k = x.numel() // x.to_local().numel()
                gather += (k - 1) * nbytes(x.to_local())
            for x in flatten(state)[0]:
                if isinstance(x, DTensor):
                    n = x.numel()
                    for d, p in enumerate(x.placements):
                        if isinstance(p, Shard) and p.dim == 1:
                            n //= mesh.size(d)
                    gather += (n - x.to_local().numel()) * x.element_size()
            want = {"all-gather": gather}
    act_sharding.clear()
    out[arch] = {"traced": traced, "want": want, "scalars": scalars,
                 "mb": mb}
print("OUT " + json.dumps(out))
"""


def test_dryrun_traced_collectives_equal_the_steps_count():
    """The two gated cells on the 16 x 16 pod mesh: the trace's collectives
    (DTensor's redistributions) equal the sharded train step's own count
    (each microbatch's reduce over the DP axis, M times) and the serve
    step's gathers counted from the layouts; besides those, the train step
    all-reduces only its scalars (loss, aux, the norm's squares)."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(DRYRUN)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads([ln for ln in res.stdout.splitlines()
                      if ln.startswith("OUT ")][-1][4:])
    train, decode = out["llama3-8b"], out["qwen3-moe-30b-a3b"]
    assert train["mb"] == 16 and decode["mb"] == 1
    for cell in (train, decode):
        assert set(cell["traced"]) == {k for k, v in cell["want"].items()
                                       if v}, cell
        for k, v in cell["traced"].items():
            assert v == pytest.approx(cell["want"][k], rel=1e-12), (k, cell)
    assert 0 < train["scalars"]["all-reduce"] < 1e4
    assert decode["scalars"] == {}

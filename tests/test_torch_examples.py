"""The port's examples (``examples/torch/``) on the CPU, in-process, at
their smallest arguments with ``--device cpu``, against the reference's
examples (``examples/*.py``) on the same inputs:

* quickstart: the word counts equal ``np.bincount`` and the reference's
  run;
* pipeline: the count-of-counts equal the reference ``Pipeline``'s, with
  the same fusion decisions;
* wordcount_cluster on ``LocalMesh(2)``: each flow's result equals the
  port's ``run_local`` bit for bit, over the collectives the reference
  names;
* serve_lm gives the same tokens twice; train_lm gives finite losses for
  two steps.

No file of ``examples/torch/`` imports JAX or the reference package, and
each runs on the card unless ``--device cpu`` is given.
"""

import ast
import importlib.util
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.core as J  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.plan import plan_execution  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples", "torch")
NAMES = ("quickstart", "pipeline_wordcount_topk", "wordcount_cluster",
         "serve_lm", "train_lm")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_examples_import_neither_jax_nor_the_reference():
    for name in NAMES:
        with open(os.path.join(EXAMPLES, f"{name}.py")) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                    name, m)


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        _example("quickstart").main([])


def test_quickstart_counts_match_bincount_and_the_reference():
    ex = _example("quickstart")
    res = ex.main(["--device", "cpu"])
    windows = ex.windows_of(ex.TEXT)
    ids = windows.reshape(-1)
    want = np.bincount(ids[ids < ex.VOCAB], minlength=ex.VOCAB)
    np.testing.assert_array_equal(res.counts.numpy(), want)
    np.testing.assert_array_equal(res.values.numpy(), want)

    class JWordCount(J.MapReduceApp):  # the reference example's app
        key_space = ex.VOCAB
        value_aval = jax.ShapeDtypeStruct((), jnp.int32)
        emit_capacity = 8
        max_values_per_key = 64

        def map(self, window, emit):
            emit(window, jnp.ones_like(window))

        def reduce(self, key, values, count):
            return jnp.sum(values)

    mr = J.MapReduce(JWordCount(), cache=False)
    ref = mr.run(jnp.asarray(windows))
    assert ex.MapReduce(ex.WordCount(), device="cpu").plan.flow == (
        mr.plan.flow)
    np.testing.assert_array_equal(res.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_array_equal(res.values.numpy(), np.asarray(ref.values))


def _decision(line: str) -> str:
    """A fusion report line's decision: its edge and the words before the
    dash (a consumer map line: "consumer map")."""
    edge, what = line.split(": ", 1)
    if what.startswith("consumer map"):
        return f"{edge}: consumer map"
    return f"{edge}: {what.split(' — ')[0]}"


def test_pipeline_matches_the_reference_with_its_fusion_decisions():
    ex = _example("pipeline_wordcount_topk")
    n = 20_000
    fused, pipe = ex.main(["--device", "cpu", "--tokens", str(n)])

    def jmap(vocab):
        def m(item, emit):
            emit.emit(item % vocab, jnp.ones((), jnp.int32))
        return m

    def jhist(item, emit):
        emit.emit(jnp.clip(item[1] // 32, 0, ex.BUCKETS - 1).astype(
            jnp.int32), jnp.ones((), jnp.int32))

    aval = jax.ShapeDtypeStruct((), jnp.int32)
    jwc = J.make_app(map_fn=jmap(ex.VOCAB), reduce_fn=lambda k, v, c:
                     v.sum(), key_space=ex.VOCAB, value_aval=aval)
    jh = J.make_app(map_fn=jhist, reduce_fn=lambda k, v, c: v.sum(),
                    key_space=ex.BUCKETS, value_aval=aval)
    jpipe = J.Pipeline(jwc).then(jh, where=lambda key, count, c: count >= 8)
    ref = jpipe.run(jnp.asarray(ex.tokens(n)))
    np.testing.assert_array_equal(fused.values.numpy(),
                                  np.asarray(ref.values))
    np.testing.assert_array_equal(fused.counts.numpy(),
                                  np.asarray(ref.counts))
    assert [_decision(x) for x in pipe.fusion_report()] == [
        _decision(x) for x in jpipe.fusion_report()]


def test_wordcount_cluster_equals_run_local():
    ex = _example("wordcount_cluster")
    out = ex.main(["--device", "cpu", "--shards", "2"])
    assert sorted(out) == ["reduce", "stream"]
    assert out["stream"][1] == ["all-reduce"]
    assert "all-to-all" in out["reduce"][1]
    items = torch.from_numpy(ex.tokens())
    for flow, local_flow in (("stream", "combine"), ("reduce", "reduce")):
        app = ex.WordCount()
        _, values, counts = teng.run_local(
            app, plan_execution(app, flow=local_flow, device="cpu"), items,
            device="cpu")
        res = out[flow][0]
        assert torch.equal(res.values, values.to(res.values.dtype))
        assert torch.equal(res.counts, counts)


def test_serve_lm_tokens_repeat():
    ex = _example("serve_lm")
    args = ["--device", "cpu", "--max-new", "4"]
    a, b = ex.main(args), ex.main(args)
    assert a.shape == (4, 4) and torch.equal(a, b)


def test_train_lm_two_finite_losses():
    losses = _example("train_lm").main(["--device", "cpu", "--steps", "2"])
    assert sorted(losses) == [0, 1]
    assert all(math.isfinite(v) for v in losses.values())

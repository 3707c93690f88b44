"""The staged path of the port, ``lower() -> optimize() -> compile() ->
call``, against ``run()`` and against ``repro.core``'s staged path, case by
case as ``tests/core/test_stages.py``.

Integer tables and counts must be bitwise equal to the reference's (the
port sums int32 into int64, C.5: values are compared, not dtypes); f32
sums within rtol = atol = 1e-5.  Inside the port, a staged call and
``run()`` must give the same bits, and so must a pow2-bucketed call and
the exact one, in every flow.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import repro.core as J  # noqa: E402
from benchmarks import apps as japps  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch import apps as tapps  # noqa: E402
from repro_torch.core import plan_cache as pc  # noqa: E402

VOCAB = 64
SUM_TOL = dict(rtol=1e-5, atol=1e-5)
FLOWS = ["stream", "sort", "combine", "reduce"]


def wc_app():
    return T.make_app(
        lambda item, emit: emit.emit(item % VOCAB,
                                     torch.ones((), dtype=torch.int32)),
        lambda k, vs, n: vs.sum(), key_space=VOCAB,
        value_spec=T.ValueSpec((), torch.int32))


def jwc_app():
    return J.make_app(
        lambda item, emit: emit.emit(item % VOCAB, jnp.ones((), jnp.int32)),
        lambda k, vs, n: vs.sum(), key_space=VOCAB,
        value_aval=jax.ShapeDtypeStruct((), jnp.int32))


@pytest.fixture(scope="module")
def items():
    rng = np.random.default_rng(7)
    return rng.integers(0, VOCAB, size=3000).astype(np.int32)


def kmeans_items(n, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 100, size=n).astype(np.int32),
            rng.standard_normal((n, 3)).astype(np.float32))


def bits(t):
    t = t.contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_bitwise(a, b):
    assert torch.equal(a.counts, b.counts)
    assert torch.equal(bits(a.values), bits(b.values))


def test_staged_path_matches_run(items):
    mr = T.MapReduce(wc_app(), device="cpu")
    want = mr.run(items)
    low = mr.lower(items)
    assert isinstance(low, T.Lowered)
    opt = low.optimize()
    assert isinstance(opt, T.Optimized)
    comp = opt.compile()
    assert isinstance(comp, T.Compiled)
    got = comp(items)
    assert_bitwise(want, got)
    jgot = J.MapReduce(jwc_app()).lower(jnp.asarray(items)).optimize(
    ).compile()(jnp.asarray(items))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(jgot.values))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(jgot.counts))


@pytest.mark.parametrize("flow", FLOWS)
def test_staged_flows_match_run_and_reference(flow):
    """KMeans (f32 sums over 3 columns) in every flow: the staged call
    equals ``run()`` bit for bit and the reference's staged call within
    the sums' tolerance; counts exactly."""
    cid, pts = kmeans_items(1500)
    tapp = tapps.KMeans()
    mr = T.MapReduce(tapp, flow=flow, device="cpu")
    got = mr.lower((cid, pts)).optimize().compile()((cid, pts))
    assert_bitwise(mr.run((cid, pts)), got)
    jitems = (jnp.asarray(cid), jnp.asarray(pts))
    jgot = J.MapReduce(japps.KMeans(), flow=flow).lower(jitems).optimize(
    ).compile()(jitems)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(jgot.counts))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(jgot.values),
                               **SUM_TOL)


def test_explain_at_every_stage(items):
    mr = T.MapReduce(wc_app(), device="cpu")
    jmr = J.MapReduce(jwc_app())
    assert "flow:" in mr.explain()
    low, jlow = mr.lower(items), jmr.lower(jnp.asarray(items))
    opt, jopt = low.optimize(), jlow.optimize()
    comp, jcomp = opt.compile(), jopt.compile()
    comp(items)
    for line in ("stage: lowered", "items:", "plan-cache:"):
        assert line in low.explain() and line in jlow.explain()
    for line in ("stage: optimized", "mode: local", "items:", "(N=3000 ",
                 "compiled-cache key:"):
        assert line in opt.explain() and line in jopt.explain()
    for line in ("stage: compiled", "mode: local", "plan-cache:",
                 "compiled-cache:"):
        assert line in comp.explain() and line in jcomp.explain()


def test_lowered_compile_shortcut_keeps_introspection(items):
    """The card has no XLA text: ``as_text()`` is the launch plan of the
    bound shape, ``memory_analysis()`` the modelled peak (no warm-up on
    the CPU), ``cost_analysis()`` the modelled bytes and estimate."""
    comp = T.MapReduce(wc_app(), device="cpu").lower(items).compile()
    text = comp.as_text()
    assert "chunk loop:" in text and "N=3000 items" in text
    mem = comp.memory_analysis()
    assert mem["model_peak_bytes"] > 0 and mem["warmup_peak_bytes"] is None
    cost = comp.cost_analysis()
    assert cost["backend"] == "cpu" and cost["flow"] == "stream"
    assert cost["model_bytes"] > 0 and cost["est_s"] > 0


@pytest.mark.parametrize("flow", ["stream", "sort", "combine"])
def test_launch_plan_names_the_kernels(flow):
    """With the kernels on, the launch plan names each kernel and, for the
    keyed folds, its ``ops.fold_plan``."""
    cid, pts = kmeans_items(600)
    comp = T.MapReduce(tapps.KMeans(), flow=flow, device="cpu",
                       use_kernels=True).lower((cid, pts)).compile()
    want = {"stream": "onehot_fold", "sort": "radix_partition",
            "combine": "onehot_combine"}[flow]
    assert want in comp.as_text()
    if flow != "sort":
        assert "n_seg=" in comp.as_text()


def test_execution_options_on_run(items):
    mr = T.MapReduce(wc_app(), device="cpu")
    want = mr.run(items)
    assert_bitwise(want, mr.run(items, options=T.ExecutionOptions()))


@pytest.mark.parametrize("flow", FLOWS)
def test_pow2_items_bucket_bitwise(flow, items):
    """A pow2-bucketed call gives the exact call's bits (the word count
    of the reference's test, and the f32 KMeans sums, in every flow); a
    second N in the bucket prepares nothing; a caller's padded batch with
    ``n_valid`` gives the same bits."""
    pc.clear()
    pow2 = T.ExecutionOptions(items_bucket="pow2")
    mr = T.MapReduce(wc_app(), flow=flow, device="cpu")
    assert_bitwise(mr.run(items), mr.run(items, options=pow2))
    comp1 = mr.lower(items, options=pow2).compile()
    s0 = pc.stats_snapshot()
    comp2 = mr.lower(items[:-5], options=pow2).compile()
    assert pc.stats_snapshot()["compiles"] == s0["compiles"]
    assert comp1.n_bucket == comp2.n_bucket == 4096
    assert comp2.cache_event == "hit"
    assert_bitwise(mr.run(items[:-5]), comp2(items[:-5]))
    cid, pts = kmeans_items(1000 - 13)
    kmr = T.MapReduce(tapps.KMeans(), flow=flow, device="cpu",
                      stream_chunk_pairs=256)
    exact = kmr.run((cid, pts))
    comp = kmr.lower((cid, pts), options=pow2).compile()
    assert comp.n_bucket == 1024
    assert_bitwise(exact, comp((cid, pts)))
    pad = comp.n_bucket - len(cid)
    padded = (np.concatenate([cid, np.zeros(pad, np.int32)]),
              np.concatenate([pts, np.full((pad, 3), 7.0, np.float32)]))
    assert_bitwise(exact, comp(padded))
    assert_bitwise(exact, comp(padded, n_valid=len(cid)))
    assert "bucket=1024" in comp.explain()


def test_padded_and_exact_executables_do_not_collide():
    mr = T.MapReduce(wc_app(), device="cpu")
    rng = np.random.default_rng(13)
    five = rng.integers(0, VOCAB, size=5).astype(np.int32)
    eight = rng.integers(0, VOCAB, size=8).astype(np.int32)
    pow2 = T.ExecutionOptions(items_bucket="pow2")
    comp5 = mr.lower(five, options=pow2).compile()
    comp8_exact = mr.lower(eight).compile()
    comp8_pow2 = mr.lower(eight, options=pow2).compile()
    assert comp5.cache_key != comp8_exact.cache_key
    assert comp5.cache_key != comp8_pow2.cache_key
    assert comp8_exact.cache_key != comp8_pow2.cache_key
    assert_bitwise(mr.run(five), comp5(five))
    assert_bitwise(mr.run(eight), comp8_exact(eight))
    assert_bitwise(mr.run(eight), comp8_pow2(eight))


def test_compiled_binds_its_item_count(items):
    comp = T.MapReduce(wc_app(), device="cpu").lower(items).compile()
    with pytest.raises(ValueError, match="bound to N=3000"):
        comp(items[:-1])


def test_compiled_plan_not_shared_across_cache_hits(items):
    mr = T.MapReduce(wc_app(), device="cpu")
    c1 = mr.lower(items).compile()
    c2 = mr.lower(items).compile()
    assert c1.plan is not c2.plan
    c1.plan.diagnostics += ("polluted",)
    assert "polluted" not in c2.plan.diagnostics
    assert "polluted" not in mr.lower(items).compile().plan.diagnostics


def test_calls_return_fresh_tensors(items):
    """A second call leaves the first call's tensors as they were."""
    comp = T.MapReduce(wc_app(), device="cpu").lower(items).compile()
    first = comp(items)
    kept = first.values.clone(), first.counts.clone()
    second = comp(np.zeros_like(items))
    assert torch.equal(first.values, kept[0])
    assert torch.equal(first.counts, kept[1])
    assert second.values.data_ptr() != first.values.data_ptr()


@pytest.mark.parametrize("mode,item", [("streaming", "A13"),
                                       ("distributed", "A11"),
                                       ("resilient", "A12")])
def test_other_modes_name_their_roadmap_item(mode, item, items):
    """Each mode of the reference lowers (the ROADMAP item that ported it
    in the id): streaming (A13) compiles an ingest, which refuses a batch
    call; distributed (A11) needs a mesh, and with one compiles a
    distributed run; resilient (A12) compiles its driver, uncached, whose
    call equals the local run and carries its recovery log."""
    mr = T.MapReduce(wc_app(), device="cpu")
    if mode == "streaming":
        comp = mr.lower(items, mode=mode).compile()
        assert comp.mode == "streaming"
        with pytest.raises(TypeError, match="MapReduceService"):
            comp(items)
    elif mode == "distributed":
        from repro_torch.distributed import LocalMesh

        with pytest.raises(TypeError, match="requires a mesh"):
            mr.lower(items, mode=mode)
        comp = mr.lower(items, mode=mode, options=T.ExecutionOptions(
            mesh=LocalMesh(2, "cpu"))).compile()
        assert comp.mode == "distributed"
        assert torch.equal(comp(items).counts, mr.run(items).counts)
    else:
        comp = mr.lower(items, mode=mode, options=T.ExecutionOptions(
            num_hosts=2, num_shards=2)).compile()
        assert comp.mode == "resilient" and comp.cache_key is None
        res = comp(items)
        assert torch.equal(res.counts, mr.run(items).counts)
        assert res.recovery.num_shards == 2 and len(res.recovery.computed) == 2
    assert T.core.api.MODE_ITEMS == {}
    with pytest.raises(ValueError, match="unknown execution mode"):
        mr.lower(items, mode="warp")


def test_legacy_kwargs_raise_type_error(items):
    mr = T.MapReduce(wc_app(), device="cpu")
    with pytest.raises(TypeError, match="ExecutionOptions"):
        mr.run(items, chunk_pairs=64)


def test_unknown_kwarg_raises_type_error(items):
    mr = T.MapReduce(wc_app(), device="cpu")
    with pytest.raises(TypeError, match="unexpected keyword"):
        mr.run(items, not_an_option=1)


def test_optimize_hints_override_options(items):
    low = T.MapReduce(wc_app(), device="cpu").lower(items)
    opt = low.optimize(items_bucket="pow2")
    assert opt.options.items_bucket == "pow2"
    assert opt.n_bucket == 4096
    with pytest.raises(TypeError, match="unknown hints"):
        low.optimize(bogus_hint=1)
    pinned = low.optimize(chunk_pairs=64)
    assert pinned.cache_key != low.optimize().cache_key
    assert_bitwise(pinned.compile()(items), low.compile()(items))

"""The cost model behind ``n_pairs_hint`` against the reference's.

``repro_torch.roofline.analysis``'s flow models must return the reference's
numbers exactly; ``cost_model`` on the ``cpu`` profile must give the
reference's estimates, terms and ``describe()`` lines; and
``MapReduce(app, n_pairs_hint=N, device="cpu")`` must plan what
``repro.core.MapReduce(japp, n_pairs_hint=N)`` plans (flow, reason, the
cost lines of ``explain()``) and give its values: counts and integer
tables exactly, float sums within rtol = atol = 1e-5.  The ``cuda``
profile is plain arithmetic, so its rankings are checked here too; its
coefficients are fitted on the card (``chip_smoke.py``).  Mirrors the
reference's cost-model cases in ``tests/core/test_sort_flow.py``.
"""

import itertools
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
from repro.core import collector as JCOL  # noqa: E402
from repro.core import combiner as JC  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.roofline import analysis as jroof  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch import apps as tapps  # noqa: E402
from repro_torch.core import combiner as TC  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.data import datasets  # noqa: E402
from repro_torch.roofline import analysis as troof  # noqa: E402

SUM_TOL = dict(rtol=1e-5, atol=1e-5)
FLOWS = ("stream", "sort", "combine", "reduce")
SCALE = 0.01


# -- roofline flow models ---------------------------------------------------

GRID = dict(n_pairs=(1, 1000, 1 << 20), key_space=(1, 100, 1 << 18),
            value_bytes=(2, 4, 12), holder_bytes=(None, 8),
            chunk_pairs=(256, 1 << 14), key_block=(None, 64))


def _grid(**extra):
    keys = list(GRID) + list(extra)
    for vals in itertools.product(*GRID.values(), *extra.values()):
        yield dict(zip(keys, vals))


@pytest.mark.parametrize("lmax", [None, 7])
@pytest.mark.parametrize("flow", FLOWS)
def test_flow_bytes_equal_the_reference(flow, lmax):
    for kw in _grid(sort_levels=(1, 2, 3)):
        assert troof.mapreduce_flow_bytes(
            flow, max_values_per_key=lmax, **kw) == \
            jroof.mapreduce_flow_bytes(flow, max_values_per_key=lmax, **kw)


@pytest.mark.parametrize("lmax", [None, 7])
@pytest.mark.parametrize("flow", FLOWS)
def test_flow_peak_bytes_equal_the_reference(flow, lmax):
    for kw in _grid():
        assert troof.mapreduce_flow_peak_bytes(
            flow, max_values_per_key=lmax, **kw) == \
            jroof.mapreduce_flow_peak_bytes(flow, max_values_per_key=lmax,
                                            **kw)


@pytest.mark.parametrize("d", [1, 4, 300])
def test_stream_working_set_equals_the_reference(d):
    for chunk, blk, tn, td in itertools.product(
            (1, 100, 1 << 16), (1, 512, 4096), (8, 512), (1, 128)):
        kw = dict(chunk_pairs=chunk, key_block=blk, d=d, tile_n=tn,
                  tile_d=td)
        assert troof.stream_working_set_bytes(**kw) == \
            jroof.stream_working_set_bytes(**kw)


@pytest.mark.parametrize("flow", FLOWS)
def test_default_chunks_are_the_ports(flow):
    """``chunk_pairs=None`` takes the port's chunk on the card, not the
    reference engine's defaults."""
    from repro_torch.core import autotune as at

    kw = dict(n_pairs=1 << 24, key_space=1 << 16)
    chunk = at.CUDA_CHUNK_PAIRS
    assert troof.mapreduce_flow_bytes(flow, **kw) == \
        jroof.mapreduce_flow_bytes(flow, chunk_pairs=chunk, **kw)
    assert troof.mapreduce_flow_peak_bytes(flow, **kw) == \
        jroof.mapreduce_flow_peak_bytes(flow, chunk_pairs=chunk, **kw)


def test_unknown_flow_raises():
    with pytest.raises(ValueError, match="unknown flow"):
        troof.mapreduce_flow_bytes("shuffle", n_pairs=1, key_space=1)


# -- the cpu profile ----------------------------------------------------------

def test_sort_radix_passes_equal_the_reference():
    for n, k in itertools.product(
            (0, 1, 2, 1000, 1 << 14, 1 << 16, 1 << 22, 1 << 30),
            (0, 1, 7, 1 << 10, 1 << 15, 1 << 20, 1 << 25, 1 << 31)):
        assert tcm.sort_radix_passes(n, k) == JCOL.sort_radix_passes(n, k)


def _same_cost(a, b):
    assert (a.flow, a.est_s, a.model_bytes, a.terms) == (
        b.flow, b.est_s, b.model_bytes, b.terms)
    assert a.describe() == b.describe()


@pytest.mark.parametrize("flow", FLOWS)
def test_cpu_estimates_equal_the_reference(flow):
    for n, k, d, chunk, lmax, skew in itertools.product(
            (1, 1024, 1 << 20), (4, 2048, 1 << 20), (1, 3),
            (None, 1 << 14), (None, 16), (1.0, 1.5)):
        kw = dict(n_pairs=n, key_space=k, d=d, value_bytes=4 * d,
                  holder_bytes=4 * d, chunk_pairs=chunk,
                  max_values_per_key=lmax, backend="cpu", skew_factor=skew)
        _same_cost(tcm.estimate_flow_cost(flow, **kw),
                   jcm.estimate_flow_cost(flow, **kw))


@pytest.mark.parametrize("candidates", [("stream", "sort"), ("stream",),
                                        FLOWS])
def test_cpu_choice_and_report_equal_the_reference(candidates):
    for n, k in itertools.product((64, 4096, 1 << 20), (4, 1 << 15, 1 << 20)):
        kw = dict(n_pairs=n, key_space=k, candidates=candidates,
                  backend="cpu")
        t, j = tcm.choose_flow(**kw), jcm.choose_flow(**kw)
        assert (t.chosen, t.n_pairs, t.key_space, t.backend) == (
            j.chosen, j.n_pairs, j.key_space, j.backend)
        for a, b in zip(t.costs, j.costs, strict=True):
            _same_cost(a, b)
        assert t.describe() == j.describe()
        assert t.cost_of("stream").est_s == j.cost_of("stream").est_s
        assert t.cost_of("absent") is None


def test_sort_cost_model_prices_multi_pass():
    """The reference's case: the sort term grows past the packed regime,
    and sort still wins at K = 1M."""
    small = tcm.estimate_flow_cost("sort", n_pairs=4096, key_space=1 << 15)
    big = tcm.estimate_flow_cost("sort", n_pairs=4096, key_space=1 << 20)
    assert dict(big.terms)["sort"] > dict(small.terms)["sort"]
    assert tcm.choose_flow(n_pairs=4096, key_space=1 << 20,
                           backend="cpu").chosen == "sort"


def test_flow_cost_model_bytes_ordering():
    """sort ≤ combine < reduce (one chunk: sort == combine), both
    profiles."""
    for backend in ("cpu", "cuda"):
        kw = dict(n_pairs=1024, key_space=32768, max_values_per_key=8,
                  backend=backend)
        b = {f: tcm.estimate_flow_cost(f, **kw).model_bytes
             for f in ("sort", "combine", "reduce")}
        assert b["sort"] <= b["combine"] < b["reduce"]


# -- profiles, backends, what is not ported -----------------------------------

@pytest.mark.parametrize("device,backend", [
    ("cuda", "cuda"), ("cuda:0", "cuda"), (torch.device("cuda", 1), "cuda"),
    ("cpu", "cpu"), (torch.device("cpu"), "cpu"), ("meta", "cpu")])
def test_default_backend_follows_the_device(device, backend):
    assert tcm.default_backend(device) == backend


def test_unknown_backend_and_missing_coefficient_raise(monkeypatch):
    with pytest.raises(ValueError, match="unknown backend profile 'tpu'"):
        tcm.estimate_flow_cost("stream", n_pairs=8, key_space=8,
                               backend="tpu")
    monkeypatch.delitem(tcm.CUDA_COEFF, "segment")
    with pytest.raises(KeyError, match="segment"):
        tcm.estimate_flow_cost("sort", n_pairs=8, key_space=8,
                               backend="cuda")


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_num_shards_names_the_distribution_item(backend):
    """Since A11 (distribution) ``num_shards > 1`` prices the shuffled
    flows' all-to-all: a ``wire`` term, the roofline's bytes a shard over
    the profile's link rate (the reference's constant on ``cpu``), none
    for the table-merge flows; on ``cpu`` every estimate and term is the
    reference's."""
    for flow in FLOWS:
        for codec in ("raw", "delta", "packed"):
            kw = dict(n_pairs=1 << 16, key_space=1 << 12, num_shards=4,
                      wire=codec, value_bytes=4, value_dtype="float32",
                      skew_factor=1.5)
            got = tcm.estimate_flow_cost(flow, backend=backend, **kw)
            terms = dict(got.terms)
            assert ("wire" in terms) == (flow in ("sort", "reduce"))
            if flow in ("sort", "reduce"):
                assert terms["wire"] == troof.shuffle_wire_bytes(
                    codec, n_pairs=1 << 16, key_space=1 << 12, num_shards=4,
                    value_bytes=4, value_dtype="float32") / \
                    tcm.link_bytes_per_s(backend)
            if backend == "cpu":
                want = jcm.estimate_flow_cost(flow, backend="cpu", **kw)
                assert got.est_s == want.est_s
                assert got.terms == want.terms
    rep = tcm.choose_flow(n_pairs=1 << 16, key_space=1 << 12,
                          backend=backend, num_shards=2, wire="delta")
    assert rep.chosen in ("stream", "sort")
    assert tcm.link_bytes_per_s("cpu") == jroof.LINK_BW


def test_skew_scales_the_shuffled_flows_only():
    for backend in ("cpu", "cuda"):
        for flow in FLOWS:
            kw = dict(n_pairs=1 << 16, key_space=1 << 12, backend=backend)
            even = tcm.estimate_flow_cost(flow, **kw)
            hot = tcm.estimate_flow_cost(flow, skew_factor=2.0, **kw)
            want = 2.0 if flow in ("sort", "reduce") else 1.0
            assert hot.est_s == pytest.approx(even.est_s * want, rel=1e-12)


# -- the cuda profile, as arithmetic ------------------------------------------

def test_cuda_profile_keeps_kmeans_on_the_stream_flow():
    """KMeans (K = 100, 3-float values) on the card: the stream fold takes
    the lane tables, one pass a chunk, and the model keeps it."""
    app = tapps.KMeans()
    spec = T.MapReduce(app, device="cpu").plan.spec
    for n in (1 << 14, 1 << 20, 1 << 24, 1 << 26):
        report = tplan.flow_cost_report(app, spec, n, device="cuda")
        assert report.backend == "cuda" and report.chosen == "stream"
        terms = dict(report.cost_of("stream").terms)
        assert "fold_lane" in terms and "fold_table" not in terms


def test_cuda_work_follows_the_launch_plans():
    """The stream fold takes the route of ``ops.fold_plan``, in place as
    the chunk loop folds: at K = 2^14 the tile route, reading a chunk once
    per key tile x column tile; at K = 2^20, where the tile route would
    read it 64 times (D = 2), the partitioned route: its partition pass
    under ``partition``, its column tiles' reads of the layout under
    ``fold_table``.  The sort flow moves a chunk once per partition pass,
    then through segment_reduce."""
    from repro_torch.kernels import ops

    n, cols = 1 << 22, 2

    def plan_of(k):
        blk = min(ops.auto_key_block(k), k)
        return ops.fold_plan(n, k, cols, "add", blk if blk < k else None,
                             True, True)

    k = 1 << 20
    tile = ops.tile_plan(n, k, cols, "add", ops.auto_key_block(k))
    assert tile.scans == 64 and tile.shape != "lane"
    plan = plan_of(k)
    assert plan.route == "partitioned" and plan.scans == 2
    slots = plan.n_seg * plan.part.slots
    wide = tcm.cuda_work("stream", n_pairs=n, key_space=k)
    assert wide["partition"] == len(plan.part.passes) * (n * 4 + n * 8
                                                         + slots * 8)
    assert wide["fold_table"] == (slots * 4 * (plan.col_tiles + 1)
                                  + 2 * k * cols * 4)
    k = 1 << 14
    plan = plan_of(k)
    assert plan.route == "tile" and plan.shape != "lane"
    partials = 2 * plan.n_seg * k * cols * 4 if plan.n_seg > 1 else 0
    narrow = tcm.cuda_work("stream", n_pairs=n, key_space=k)
    assert set(narrow) == {"chunk", "map", "fold_table"}
    assert narrow["fold_table"] == (plan.scans * n * 4 * (1 + plan.cols)
                                    + partials + 2 * k * cols * 4)
    sort = tcm.cuda_work("sort", n_pairs=4 * n, key_space=1 << 20)
    assert sort["chunk"] == 4 and set(sort) == {"chunk", "map", "partition",
                                                "segment"}
    assert tcm.cuda_work("combine", n_pairs=n, key_space=100)["chunk"] == 1


@pytest.mark.parametrize("flow", FLOWS)
@pytest.mark.parametrize("k", [100, 1 << 12, 1 << 16, 1 << 20])
def test_cuda_estimates_grow_with_n(flow, k):
    ests = [tcm.estimate_flow_cost(flow, n_pairs=1 << b, key_space=k,
                                   backend="cuda").est_s
            for b in range(6, 27)]
    assert all(a <= b for a, b in zip(ests, ests[1:]))


@pytest.mark.parametrize("k", [1 << 15, 1 << 16, 1 << 18, 1 << 20, 1 << 22])
def test_cuda_ranking_turns_once_at_large_k(k):
    """Past a single fold table (K > 2^14 at D = 2) the ranking is monotone
    in N, stream while the host's fixed costs rule.  Where the stream fold
    takes the tile route (K = 2^15, 2^16) sort from some N on; where it
    takes the partitioned route (K >= 2^17) it moves each pair once
    through a partition pass as the sort flow does and skips the sort
    flow's segment pass, so stream at every N."""
    from repro_torch.core import autotune as at
    from repro_torch.kernels import ops

    chosen = [tcm.choose_flow(n_pairs=1 << b, key_space=k,
                              backend="cuda").chosen
              for b in range(6, 29)]
    turn = chosen.index("sort") if "sort" in chosen else len(chosen)
    assert set(chosen[:turn]) == {"stream"}
    assert set(chosen[turn:]) <= {"sort"}
    blk = min(ops.auto_key_block(k), k)
    plan = ops.fold_plan(at.CUDA_CHUNK_PAIRS, k, 2, "add",
                         blk if blk < k else None, True, True)
    assert (chosen[-1] == "sort") == (plan.route == "tile")


# -- the planner against the reference ----------------------------------------

class JBoundingBox(japps.KMeans):
    def reduce(self, key, values, count):
        return jnp.concatenate([jnp.max(values, axis=0),
                                jnp.min(values, axis=0)])


def _apps(name):
    if name == "BB":
        _, jitems = japps.build("KM", np.random.default_rng(0), scale=SCALE)
        japp = JBoundingBox()
    else:
        japp, jitems = japps.build(name, np.random.default_rng(0),
                                   scale=SCALE)
    tapp, titems = tapps.build(name, np.random.default_rng(0), scale=SCALE,
                               device="cpu")
    return japp, jitems, tapp, titems


def _same_plan(tmr, jmr):
    tp, jp = tmr.plan, jmr.plan
    assert (tp.flow, tp.reason) == (jp.flow, jp.reason)
    assert tp.cost is not None and tp.cost.backend == "cpu"
    assert tp.cost.describe() == jp.cost.describe()
    assert tp.cost.describe() in tmr.explain()
    assert jp.cost.describe() in jmr.explain()


def _same_values(res, jres):
    np.testing.assert_array_equal(res.counts.numpy(), np.asarray(jres.counts))
    for t, j in zip(jax.tree.leaves(jax.tree.map(np.asarray, jres.values)),
                    [res.values.numpy()] if isinstance(res.values,
                                                       torch.Tensor)
                    else [v.numpy() for v in res.values], strict=True):
        assert t.shape == j.shape
        if np.issubdtype(t.dtype, np.integer):
            np.testing.assert_array_equal(j, t)
        else:
            np.testing.assert_allclose(j, t, **SUM_TOL)


@pytest.mark.parametrize("name", list(tapps.ALL) + ["BB"])
def test_hinted_plans_and_runs_equal_the_reference(name):
    japp, jitems, tapp, titems = _apps(name)
    for n in (1 << 10, 1 << 16, 1 << 22):
        tmr = T.MapReduce(tapp, n_pairs_hint=n, device="cpu",
                          use_kernels=False)
        jmr = J.MapReduce(japp, n_pairs_hint=n, use_kernels=False,
                          cache=False)
        _same_plan(tmr, jmr)
        # the report the planner made is flow_cost_report's
        again = tplan.flow_cost_report(tapp, tmr.plan.spec, n, device="cpu")
        assert again.describe() == tmr.plan.cost.describe()
        assert again.describe() == jplan.flow_cost_report(
            japp, jmr.plan.spec, n).describe()
    _same_values(tmr.run(titems), jmr.run(jitems))


def _jkeyed(k):
    return J.make_app(
        lambda item, emit: emit(item[0], item[1]),
        lambda kk, v, c: jnp.sum(v, 0), key_space=k,
        value_aval=jax.ShapeDtypeStruct((), jnp.float32), emit_capacity=8,
        max_values_per_key=64)


@pytest.mark.parametrize("k", [4, 1024, 1 << 15, 1 << 20])
def test_keyed_sum_hinted_plans_equal_the_reference(k):
    for n in (1 << 10, 1 << 14, 1 << 18, 1 << 24):
        _same_plan(T.MapReduce(tapps.KeyedSum(k), n_pairs_hint=n,
                               device="cpu"),
                   J.MapReduce(_jkeyed(k), n_pairs_hint=n, cache=False))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_keyed_sum_hinted_run_equals_the_reference(use_kernels):
    k = 3000
    keys, weights = datasets.keyed_sum_data(np.random.default_rng(5),
                                            items=300, key_space=k)
    tmr = T.MapReduce(tapps.KeyedSum(k), n_pairs_hint=keys.size,
                      device="cpu", use_kernels=use_kernels)
    jmr = J.MapReduce(_jkeyed(k), n_pairs_hint=keys.size,
                      use_kernels=use_kernels, cache=False)
    _same_plan(tmr, jmr)
    assert tmr.plan.flow == "sort"
    res = tmr.run((keys, weights))
    jres = jmr.run((jnp.asarray(keys), jnp.asarray(weights)))
    np.testing.assert_array_equal(res.counts.numpy(), np.asarray(jres.counts))
    want = np.bincount(keys.reshape(-1), weights=weights.reshape(-1)
                       .astype(np.float64), minlength=k)
    np.testing.assert_allclose(res.values.numpy(), want, **SUM_TOL)


def _sum_apps(k):
    t = T.make_app(lambda item, emit: emit(item, torch.ones_like(item)),
                   lambda kk, v, c: v.sum(), key_space=k,
                   value_spec=TC.ValueSpec((), torch.int32), emit_capacity=8,
                   max_values_per_key=64)
    j = J.make_app(lambda item, emit: emit(item, jnp.ones_like(item)),
                   lambda kk, v, c: jnp.sum(v), key_space=k,
                   value_aval=jax.ShapeDtypeStruct((), jnp.int32),
                   emit_capacity=8, max_values_per_key=64)
    return t, j


def test_cost_model_picks_sort_at_large_sparse_k():
    t, j = _sum_apps(32768)
    tmr = T.MapReduce(t, n_pairs_hint=1024, device="cpu")
    _same_plan(tmr, J.MapReduce(j, n_pairs_hint=1024, cache=False))
    assert tmr.plan.flow == "sort" and tmr.plan.cost.chosen == "sort"
    sort_c = tmr.plan.cost.cost_of("sort")
    stream_c = tmr.plan.cost.cost_of("stream")
    assert sort_c.est_s < stream_c.est_s
    assert dict(stream_c.terms)["onehot"] > dict(sort_c.terms)["sort"]
    text = tmr.explain()
    assert "flow: sort" in text and "cost model" in text and "est=" in text
    assert "buckets=" in text


def test_cost_model_keeps_stream_at_small_k():
    t, j = _sum_apps(4)
    tmr = T.MapReduce(t, n_pairs_hint=1024, device="cpu")
    _same_plan(tmr, J.MapReduce(j, n_pairs_hint=1024, cache=False))
    assert tmr.plan.flow == "stream"


def test_auto_without_hint_keeps_stream_default():
    t, _ = _sum_apps(32768)
    mr = T.MapReduce(t, device="cpu")
    assert mr.plan.flow == "stream" and mr.plan.cost is None
    assert "cost model" not in mr.explain()


def test_cost_model_not_offered_for_coupled_holders():
    """Coupled holders (logsumexp) fold one pair at a time in the sort
    flow: the model ranks the stream flow alone, as in the reference."""
    t = T.make_app(lambda item, emit: emit(item[0], item[1]),
                   lambda k, v, c: torch.logsumexp(v, 0), key_space=32768,
                   value_spec=TC.ValueSpec((), torch.float32),
                   emit_capacity=1, max_values_per_key=64,
                   manual_combiner=TC.logsumexp_spec())
    j = J.make_app(lambda item, emit: emit(item[0], item[1]),
                   lambda k, v, c: jax.scipy.special.logsumexp(v),
                   key_space=32768,
                   value_aval=jax.ShapeDtypeStruct((), jnp.float32),
                   emit_capacity=1, max_values_per_key=64,
                   manual_combiner=JC.logsumexp_spec())
    for device in ("cpu", "cuda"):
        assert tplan._cost_candidates(t.manual_combiner) == ("stream",)
        plan = tplan.plan_execution(t, n_pairs_hint=1024, device=device)
        assert plan.flow == "stream"
        assert tuple(c.flow for c in plan.cost.costs) == ("stream",)
    tmr = T.MapReduce(t, n_pairs_hint=1024, device="cpu")
    _same_plan(tmr, J.MapReduce(j, n_pairs_hint=1024, cache=False))


def test_forced_flow_and_underivable_reducer_ignore_the_hint():
    """As in the reference: a forced flow plans no ranking, and a reducer
    with no combiner plans the reduce flow."""
    t, j = _sum_apps(32768)
    for flow in ("stream", "sort", "combine", "reduce"):
        tp = T.MapReduce(t, flow=flow, n_pairs_hint=1024, device="cpu").plan
        jp = J.MapReduce(j, flow=flow, n_pairs_hint=1024, cache=False).plan
        assert (tp.flow, tp.reason, tp.cost) == (jp.flow, jp.reason, None)
    t = T.make_app(lambda item, emit: emit(item, item.float()),
                   lambda k, v, c: torch.sort(v).values[1], key_space=16,
                   value_spec=TC.ValueSpec((), torch.float32),
                   emit_capacity=1, max_values_per_key=8)
    plan = T.MapReduce(t, n_pairs_hint=1 << 20, device="cpu").plan
    assert plan.flow == "reduce" and plan.cost is None
    assert plan.reason.startswith("not combinable")


def test_the_card_plans_with_the_cuda_profile():
    """``device`` picks the profile: planning is arithmetic, so the card's
    plan can be made without one; KeyedSum at K = 2^20 and 2^24 pairs
    takes the stream flow there, whose fold takes the partitioned route
    (on an H100 its wall beat the sort flow's at this shape)."""
    plan = tplan.plan_execution(tapps.KeyedSum(1 << 20),
                                n_pairs_hint=1 << 24, device="cuda")
    assert plan.flow == "stream" and plan.cost.backend == "cuda"
    assert plan.reason.endswith("cost model [cuda] at N=16777216")
    assert ("cost model [cuda] N=16777216 K=1048576 -> stream"
            in plan.explain())


def test_model_holder_bytes_count_int_tables_at_the_references_width():
    """C.5's int64 tables are priced as the reference's int32 ones."""
    t, j = _sum_apps(64)
    tspec = T.MapReduce(t, device="cpu").plan.spec
    jspec = J.MapReduce(j, cache=False).plan.spec
    assert tspec.holder_width(t.value_spec)[1] == 8
    assert tplan._model_holder_bytes(tspec, t.value_spec) == \
        jspec.holder_width(j.value_aval)[1] == 4

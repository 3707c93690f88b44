"""The combine flow: the port's ``combine_flow`` and ``MapReduce(app,
flow="combine")`` against the reference's, on the same numpy inputs.

* ``collector.combine_flow`` with every lowering forced (``onehot``,
  ``scatter``, ``first``, ``segment``) and with ``impl="auto"``, the
  kernels off and on (the reference's Pallas kernels in interpret mode,
  the port's through their plain versions on CPU tensors);
* the ``auto`` rule: the same lowering as the reference's at K <= 2048, at
  K > 2048 with and without a one-hot kernel, and at N <= 2048 pairs, with
  the fallback warning exactly where the reference warns;
* the seven Phoenix apps and the bounding-box app under ``flow="combine"``,
  and the plan-time diagnostics past the one-hot cutoff.

Counts, integer tables and max/min/first tables must be equal (the port's
integer results may be int64 where the reference's are int32, ROADMAP C.5:
values are compared, not dtypes); float sums agree within rtol=atol=1e-5.
"""

import os
import sys
import warnings
from functools import cache

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
from repro.core.optimizer import derive_combiner as jderive  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch import apps as tapps  # noqa: E402
from repro_torch.core import collector as TCOL  # noqa: E402
from repro_torch.core import combiner as TC  # noqa: E402
from repro_torch.core.optimizer import KEY_SPEC  # noqa: E402
from repro_torch.core.optimizer import derive_combiner as tderive  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

SUM_TOL = dict(rtol=1e-5, atol=1e-5)
SCALE = 0.01

# name: (torch reduce, jax reduce, value shape, dtype); None: a manual spec
REDUCERS = {
    "int_sum": (lambda k, v, c: v.sum(), lambda k, v, c: jnp.sum(v), (),
                "int32"),
    "centroid": (lambda k, v, c: v.sum(0) / c.clamp(min=1).to(torch.float32),
                 lambda k, v, c: jnp.sum(v, 0) / jnp.maximum(c, 1), (3,),
                 "float32"),
    "bbox": (lambda k, v, c: torch.cat([v.amax(0), v.amin(0)]),
             lambda k, v, c: jnp.concatenate([jnp.max(v, 0), jnp.min(v, 0)]),
             (2,), "float32"),
    "int_max": (lambda k, v, c: v.amax(0), lambda k, v, c: jnp.max(v, 0),
                (2,), "int32"),
    "first": (lambda k, v, c: v[0] * 2.0, lambda k, v, c: v[0] * 2.0, (2,),
              "float32"),
    "size": (lambda k, v, c: c * 3, lambda k, v, c: c * 3, (), "float32"),
    "logsumexp": (None, None, (), "float32"),
}
EXACT = ("bbox", "int_max", "first", "int_sum", "size")


@cache
def _specs(name):
    tfn, jfn, shape, dt = REDUCERS[name]
    jv = jax.ShapeDtypeStruct(shape, getattr(jnp, dt))
    tv = TC.ValueSpec(shape, getattr(torch, dt))
    if tfn is None:  # coupled holders: no monoid, the segment fold
        return JC.logsumexp_spec(), TC.logsumexp_spec(), shape, dt
    js = jderive(jfn, jax.ShapeDtypeStruct((), jnp.int32), jv).spec
    ts = tderive(tfn, KEY_SPEC, tv).spec
    assert js is not None and ts is not None
    return js, ts, shape, dt


def _streams(name, n, k, seed=0):
    _, _, shape, dt = _specs(name)
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, k + 1, size=n).astype(np.int32)  # k: sentinel
    if dt == "int32":
        vals = rng.integers(-50, 50, size=(n,) + shape).astype(np.int32)
    else:
        vals = rng.standard_normal((n,) + shape).astype(np.float32)
        vals.reshape(-1)[::7] = -0.0
        vals.reshape(-1)[3::11] = 0.0
    return (JCOL.PairStream(jnp.asarray(keys), jnp.asarray(vals), k),
            TCOL.PairStream(torch.from_numpy(keys), torch.from_numpy(vals),
                            k))


def _assert_same(exact, jvals, tvals):
    for j, t in zip(jax.tree.leaves(jvals), jax.tree.leaves(tvals)):
        j, t = np.asarray(j), t.numpy()
        assert j.shape == t.shape
        if exact and np.issubdtype(j.dtype, np.floating):
            np.testing.assert_array_equal(t.view(np.uint32),
                                          j.view(np.uint32))
        elif exact:
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, **SUM_TOL)


def _kernels(on):
    if not on:
        return {}, {}
    return ({"onehot_fn": lambda k, m, K: jops.onehot_combine(
                k, m, K, interpret=True)},
            {"onehot_fn": tops.onehot_combine,
             "scatter_fn": tops.combine_scatter})


# (reducer, forced impl) pairs each lowering takes
FORCED = [("int_sum", "onehot"), ("centroid", "onehot"),
          ("int_sum", "scatter"), ("centroid", "scatter"), ("bbox", "scatter"), ("int_max", "scatter"),
          ("first", "first"), ("size", "scatter"),
          ("logsumexp", "segment"), ("bbox", "segment")]


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("name,impl", FORCED + [(r, "auto")
                                                for r in REDUCERS])
def test_combine_flow_matches_reference(name, impl, kernels):
    js, ts, _, _ = _specs(name)
    jstream, tstream = _streams(name, 300, 37)
    jkw, tkw = _kernels(kernels)
    jg = JCOL.combine_flow(js, jstream, impl=impl, **jkw)
    tg = TCOL.combine_flow(ts, tstream, impl=impl, **tkw)
    np.testing.assert_array_equal(tg.counts.numpy(), np.asarray(jg.counts))
    assert tg.counts.dtype == torch.int32
    _assert_same(name in EXACT, jg.values, tg.values)


def _record(monkeypatch, module, seen):
    for impl in ("onehot", "scatter", "first", "segment"):
        fn = getattr(module, f"combine_{impl}")

        def rec(*a, _fn=fn, _impl=impl, **k):
            seen.append(_impl)
            return _fn(*a, **k)
        monkeypatch.setattr(module, f"combine_{impl}", rec)


# (reducer, K, N, kernels): the auto rule's branches
AUTO = [("centroid", 37, 300, False), ("centroid", 37, 300, True),
        ("centroid", 4096, 1000, False),  # K > 2048, N <= 2048: one-hot
        ("centroid", 4096, 1000, True),  # ... but not with a kernel
        ("centroid", 4096, 3000, False), ("centroid", 4096, 3000, True),
        ("int_sum", 4096, 3000, True), ("bbox", 4096, 3000, True),
        ("first", 4096, 3000, False), ("size", 4096, 3000, True),
        ("logsumexp", 40, 200, True)]


@pytest.mark.parametrize("name,k,n,kernels", AUTO)
def test_auto_picks_the_reference_lowering_and_warns_alike(monkeypatch, name,
                                                           k, n, kernels):
    js, ts, _, _ = _specs(name)
    jstream, tstream = _streams(name, n, k, seed=k + n)
    jkw, tkw = _kernels(kernels)
    jseen, tseen = [], []
    _record(monkeypatch, JCOL, jseen)
    _record(monkeypatch, TCOL, tseen)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jg = JCOL.combine_flow(js, jstream, **jkw)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tg = TCOL.combine_flow(ts, tstream, **tkw)
    jfall = [w for w in jw if issubclass(w.category,
                                         JCOL.LoweringFallbackWarning)]
    tfall = [w for w in tw if issubclass(w.category,
                                         TCOL.LoweringFallbackWarning)]
    assert tseen == jseen
    assert len(tfall) == len(jfall) <= 1
    want, reason = TCOL.choose_combine_impl(ts, k, n, onehot_kernel=kernels)
    assert tseen == ([] if name == "size" else [want])  # size: counts only
    assert bool(tfall) == (reason is not None)
    if tfall:
        assert "scatter fallback" in str(tfall[0].message)
        assert "VMEM" not in str(tfall[0].message)
    np.testing.assert_array_equal(tg.counts.numpy(), np.asarray(jg.counts))
    _assert_same(name in EXACT, jg.values, tg.values)


class JBoundingBox(japps.KMeans):
    def reduce(self, key, values, count):
        return jnp.concatenate([jnp.max(values, axis=0),
                                jnp.min(values, axis=0)])


@cache
def _reference(name, use_kernels, impl):
    if name == "BB":
        _, items = japps.build("KM", np.random.default_rng(0), scale=SCALE)
        japp = JBoundingBox()
    else:
        japp, items = japps.build(name, np.random.default_rng(0), scale=SCALE)
    mr = J.MapReduce(japp, flow="combine", combine_impl=impl,
                     use_kernels=use_kernels, cache=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", JCOL.LoweringFallbackWarning)
        res = mr.run(items)
    return (mr.plan.flow, mr.plan.derivation.strategy, mr.plan.diagnostics,
            np.asarray(res.counts), jax.tree.map(np.asarray, res.values))


def _port(name, use_kernels, impl="auto"):
    tname = "KM" if name == "BB" else name
    tapp, titems = tapps.build(tname, np.random.default_rng(0), scale=SCALE,
                               device="cpu")
    if name == "BB":
        tapp = tapps.BoundingBox()
    mr = T.MapReduce(tapp, flow="combine", combine_impl=impl, device="cpu",
                     use_kernels=use_kernels)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", TCOL.LoweringFallbackWarning)
        return mr, mr.run(titems)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("name", list(tapps.ALL) + ["BB"])
def test_phoenix_apps_match_reference(name, use_kernels):
    flow, strategy, diags, jcounts, jvals = _reference(name, use_kernels,
                                                       "auto")
    mr, res = _port(name, use_kernels)
    assert (mr.plan.flow, mr.plan.derivation.strategy) == (flow, strategy)
    assert mr.plan.optimized and mr.tiling is None
    assert len(mr.plan.diagnostics) == len(diags)
    np.testing.assert_array_equal(res.counts.numpy(), jcounts)
    tvals = res.values.numpy()
    assert tvals.shape == jvals.shape
    exact = name == "BB" or np.issubdtype(jvals.dtype, np.integer)
    _assert_same(exact, jvals, res.values)


@pytest.mark.parametrize("impl", ["onehot", "scatter"])
def test_combine_impl_option_matches_reference(impl):
    *_, jcounts, jvals = _reference("KM", False, impl)
    _, res = _port("KM", False, impl)
    np.testing.assert_array_equal(res.counts.numpy(), jcounts)
    np.testing.assert_allclose(res.values.numpy(), jvals, **SUM_TOL)
    mr, _ = _port("KM", False)  # the run-time option overrides it
    other = mr.run(tapps.build("KM", np.random.default_rng(0), scale=SCALE,
                               device="cpu")[1],
                   options=T.ExecutionOptions(combine_impl=impl))
    np.testing.assert_allclose(other.values.numpy(), jvals, **SUM_TOL)


def _sum_app(k, torch_side=True):
    if torch_side:
        return T.make_app(lambda x, emit: emit(x, torch.ones_like(x)),
                          lambda key, v, c: v.sum(), key_space=k,
                          value_spec=TC.ValueSpec((), torch.float32),
                          emit_capacity=1)
    return J.make_app(lambda x, emit: emit(x, jnp.ones_like(x, jnp.float32)),
                      lambda key, v, c: jnp.sum(v), key_space=k,
                      value_aval=jax.ShapeDtypeStruct((), jnp.float32),
                      emit_capacity=1)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_past_the_cutoff_diagnostics_warn_once_and_explain(use_kernels):
    k = 4096
    mr = T.MapReduce(_sum_app(k), flow="combine", device="cpu",
                     use_kernels=use_kernels)
    jmr = J.MapReduce(_sum_app(k, False), flow="combine",
                      use_kernels=use_kernels, cache=False)
    assert len(mr.plan.diagnostics) == len(jmr.plan.diagnostics) == 1
    assert "scatter fallback" in mr.plan.diagnostics[0]
    assert "VMEM" not in mr.plan.diagnostics[0]
    text = mr.explain()
    assert "flow: combine" in text and "tiling: none" in text
    assert "diagnostic: combine flow" in text
    items = (np.arange(3000) % k).astype(np.int32)
    with pytest.warns(TCOL.LoweringFallbackWarning) as rec:
        res = mr.run(items)
        mr.run(items)
    assert sum(issubclass(w.category, TCOL.LoweringFallbackWarning)
               for w in rec) == 1  # once per plan
    assert len(mr.plan.diagnostics) == 2  # plus the run-time message
    want = np.bincount(items, minlength=k)
    np.testing.assert_array_equal(res.counts.numpy(), want)
    np.testing.assert_array_equal(res.values.numpy(), want.astype(np.float32))


def test_forced_optimized_flows_need_a_combiner():
    app = T.make_app(lambda item, emit: emit(item, item.float()),
                     lambda k, v, c: v[0] + v[1], key_space=8,
                     value_spec=TC.ValueSpec((), torch.float32),
                     emit_capacity=1)
    for flow in ("combine", "stream", "sort"):
        with pytest.raises(ValueError, match="derivation failed"):
            T.MapReduce(app, flow=flow, device="cpu")


# -- the scatter lowering's route past SCATTER_SORT_MIN_KEYS (ROADMAP C.17)


def _route_pairs(seed, n, k, d):
    """Keys in [0, K) with the sentinel K, keys past it and negative keys
    mixed in; f32 values with signed zeros and NaN."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, k, size=n).astype(np.int32)
    bad = rng.random(n) < 0.15
    keys[bad] = rng.choice(np.array([k, k + 1, k + 1000, -1, -9], np.int32),
                           size=int(bad.sum()))
    vals = rng.standard_normal((n, d)).astype(np.float32)
    flat = vals.reshape(-1)
    pick = rng.random(flat.size)
    flat[pick < 0.1] = 0.0
    flat[(pick >= 0.1) & (pick < 0.2)] = -0.0
    flat[(pick >= 0.2) & (pick < 0.21)] = np.nan
    return torch.from_numpy(keys), torch.from_numpy(vals)


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("k,d", [(256, 1), (5000, 3), (1 << 16, 2)])
def test_sort_route_drops_keys_as_combine_scatter(op, k, d):
    """sort_segment_fold from the identity table gives combine_scatter's
    table: sentinel, past-K and negative keys dropped, max/min bit for bit
    (NaN and signed zeros included), sums within 1e-5."""
    keys, vals = _route_pairs(k + d, 3000, k, d)
    want = tops.combine_scatter(keys, vals, k, op)
    ident = {"add": 0.0, "max": float("-inf"), "min": float("inf")}[op]
    got = tops.sort_segment_fold(keys, vals, torch.full((k, d), ident), op)
    if op == "add":
        np.testing.assert_allclose(got.numpy(), want.numpy(), **SUM_TOL)
    else:
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.numpy().view(np.uint32))


def _bbox_app(k, torch_side=True):
    if torch_side:
        return T.make_app(lambda x, emit: emit(x[0].to(torch.int32), x[1:]),
                          lambda key, v, c: torch.cat([v.amax(0),
                                                       v.amin(0)]),
                          key_space=k,
                          value_spec=TC.ValueSpec((2,), torch.float32),
                          emit_capacity=1)
    return J.make_app(lambda x, emit: emit(x[0].astype(jnp.int32), x[1:]),
                      lambda key, v, c: jnp.concatenate([jnp.max(v, 0),
                                                         jnp.min(v, 0)]),
                      key_space=k,
                      value_aval=jax.ShapeDtypeStruct((2,), jnp.float32),
                      emit_capacity=1)


@pytest.mark.parametrize("app_name,k", [("sum", 4096), ("bbox", 100),
                                        ("bbox", 255), ("bbox", 256),
                                        ("bbox", 3000), ("sum", 100),
                                        ("sum", 255), ("sum", 256)])
def test_scatter_lowering_routes_by_key_count(monkeypatch, app_name, k):
    """With the kernels, each f32 leaf of the scatter lowering (forced for
    the sums) takes combine_scatter below its monoid's
    SCATTER_SORT_MIN_KEYS and sort_segment_fold from it on; after the run
    explain() names the route each leaf took; the tables equal the run
    without kernels and the reference's."""
    seen = []
    for name in ("combine_scatter", "sort_segment_fold"):
        real = getattr(tops, name)
        monkeypatch.setattr(tops, name, lambda *a, _r=real, _n=name, **kw:
                            seen.append(_n) or _r(*a, **kw))
    rng = np.random.default_rng(k)
    n = 3000
    if app_name == "sum":
        tapp, japp = _sum_app(k), _sum_app(k, False)
        items = rng.integers(0, k, size=n).astype(np.int32)
    else:
        tapp, japp = _bbox_app(k), _bbox_app(k, False)
        items = np.concatenate([rng.integers(0, k, size=(n, 1)),
                                rng.standard_normal((n, 2))],
                               axis=1).astype(np.float32)
    leaves = ["add"] if app_name == "sum" else ["max", "min"]
    routes = ["sort_segment_fold" if k >= TCOL.SCATTER_SORT_MIN_KEYS[op]
              else "combine_scatter" for op in leaves]
    mr = T.MapReduce(tapp, flow="combine", device="cpu", use_kernels=True,
                     combine_impl="scatter")
    assert "lowering:" not in mr.explain()  # the collector decides, per run
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", TCOL.LoweringFallbackWarning)
        warnings.simplefilter("ignore", JCOL.LoweringFallbackWarning)
        got = mr.run(torch.from_numpy(items))
        plain = T.MapReduce(tapp, flow="combine", device="cpu",
                            use_kernels=False).run(torch.from_numpy(items))
        jres = J.MapReduce(japp, flow="combine", cache=False).run(
            jnp.asarray(items))
    assert seen == routes
    assert (f"lowering: scatter (K={k}: "
            + ", ".join(f"{op} {r}" for op, r in zip(leaves, routes)) + ")"
            in mr.explain())
    np.testing.assert_array_equal(got.counts.numpy(), plain.counts.numpy())
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(jres.counts))
    for other in (plain.values.numpy(), np.asarray(jres.values)):
        if app_name == "sum":
            np.testing.assert_allclose(got.values.numpy(), other, **SUM_TOL)
        else:
            np.testing.assert_array_equal(got.values.numpy(), other)


@pytest.mark.parametrize("use_kernels,n,opts,want", [
    (False, 100, {}, "onehot (plain contraction)"),  # few pairs: one-hot
    (False, 3000, {}, "scatter (K=4096: add exact scatter)"),
    (True, 100, {}, "scatter (K=4096: add sort_segment_fold)"),
    (True, 3000, {"use_kernels": False},
     "scatter (K=4096: add exact scatter)"),
    (True, 3000, {"combine_impl": "onehot"}, "onehot (onehot_combine)"),
])
def test_explain_names_the_lowering_the_run_took(use_kernels, n, opts, want):
    """The ``lowering:`` line is the collector's record of the last run:
    small runs sent to the one-hot contraction, run-time options and the
    constructor's use_kernels all show in it."""
    k = 4096
    mr = T.MapReduce(_sum_app(k), flow="combine", device="cpu",
                     use_kernels=use_kernels)
    items = (np.arange(n) % k).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", TCOL.LoweringFallbackWarning)
        res = mr.run(items, options=T.ExecutionOptions(**opts))
    assert f"lowering: {want}" in mr.explain().splitlines()
    np.testing.assert_allclose(res.values.numpy(),
                               np.bincount(items, minlength=k), **SUM_TOL)


def test_scatter_route_without_kernels_or_a_feasible_plan(monkeypatch):
    assert TCOL.scatter_route(1 << 20, 1, "add",
                              kernels=False) == "exact scatter"
    add_min = TCOL.SCATTER_SORT_MIN_KEYS["add"]
    assert TCOL.scatter_route(add_min - 1, 1, "add",
                              kernels=True) == "combine_scatter"
    assert TCOL.scatter_route(add_min, 1, "add",
                              kernels=True) == "sort_segment_fold"
    for op in ("max", "min"):  # the sort route at every key count
        assert TCOL.scatter_route(1, 3, op, kernels=True) == \
            "sort_segment_fold"
    monkeypatch.setattr(tops, "MAX_RADIX_LEVELS", 1)  # no feasible plan
    assert TCOL.scatter_route(1 << 20, 1, "add",
                              kernels=True) == "combine_scatter"

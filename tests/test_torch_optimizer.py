"""Combiner derivation of the port against the reference optimizer.

For the seven Phoenix apps, a max/min app (per-cluster bounding box) and
the paper's two idioms, ``repro_torch``'s optimizer (aten graph via
``make_fx``) must derive the same strategy and the same monoids as
``repro.core.optimizer.derive_combiner`` on the JAX version of the reducer.
Also: the Monoid identities per dtype, the built-in specs, and the
reducers the port refuses (naming the scan-fold strategy it lacks).
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks import apps as japps  # noqa: E402
from repro.core import combiner as JC  # noqa: E402
from repro.core.optimizer import derive_combiner as jderive  # noqa: E402
from repro_torch import apps as tapps  # noqa: E402
from repro_torch.core import combiner as TC  # noqa: E402
from repro_torch.core.optimizer import KEY_SPEC  # noqa: E402
from repro_torch.core.optimizer import derive_combiner as tderive  # noqa: E402
from repro_torch.core.semantics import ExtractionFailure, analyze  # noqa: E402


class JBoundingBox(japps.KMeans):
    def reduce(self, key, values, count):
        return jnp.concatenate([jnp.max(values, axis=0),
                                jnp.min(values, axis=0)])


def _pair(name):
    rng = np.random.default_rng(0)
    if name == "BB":
        return JBoundingBox(), tapps.build("BB", rng, scale=0.01,
                                                device="cpu")[0]
    return (japps.build(name, np.random.default_rng(0), scale=0.01)[0],
            tapps.build(name, rng, scale=0.01, device="cpu")[0])


def _monoid_names(spec):
    return None if spec.monoids is None else [m.name for m in spec.monoids]


@pytest.mark.parametrize("name", list(tapps.ALL) + ["BB"])
def test_phoenix_and_bbox_derive_like_the_reference(name):
    japp, tapp = _pair(name)
    jd = jderive(japp.reduce, jax.ShapeDtypeStruct((), jnp.int32),
                 japp.value_aval)
    td = tderive(tapp.reduce, KEY_SPEC, tapp.value_spec)
    assert td.strategy == jd.strategy == "monoid"
    assert _monoid_names(td.spec) == _monoid_names(jd.spec)
    assert td.validated and jd.validated
    assert td.recommended_flow == jd.recommended_flow == "stream"
    # the holders have the reference's shapes
    jh = [tuple(l.shape) for l in jax.tree.leaves(
        jd.spec.holder_avals(japp.value_aval))]
    th = [s.shape for s in jax.tree.leaves(
        td.spec.holder_specs(tapp.value_spec),
        is_leaf=lambda x: isinstance(x, TC.ValueSpec))]
    assert th == jh
    # holder elements per key (the width the tiling sizes against); bytes
    # differ where torch sums int32 into int64
    assert (td.spec.holder_width(tapp.value_spec)[0]
            == jd.spec.holder_width(japp.value_aval)[0])


# (torch reduce, jax reduce, value shape, dtype): idioms and premaps
IDIOMS = {
    "first": (lambda k, v, c: v[0] * 2.0, lambda k, v, c: v[0] * 2.0,
              (3,), "float32"),
    "size": (lambda k, v, c: c * 2 + k, lambda k, v, c: c * 2 + k, (),
             "float32"),
    "premap_sum": (lambda k, v, c: (v * 2.0 + 1.0).exp().sum(0).log(),
                   lambda k, v, c: jnp.log(jnp.sum(jnp.exp(v * 2.0 + 1.0),
                                                   axis=0)), (3,), "float32"),
    "max_scalar": (lambda k, v, c: v.max(), lambda k, v, c: jnp.max(v), (),
                   "float32"),
    # the reference cannot derive this one (its premap reduces the extra
    # axis with a traced identity); the port's fold is still checked below
    "sum_all": (lambda k, v, c: v.sum(), None, (4,), "float32"),
    "int_max": (lambda k, v, c: v.amax(0), lambda k, v, c: jnp.max(v, 0),
                (2,), "int32"),
    "mean": (lambda k, v, c: v.sum(0) / c.clamp(min=1).to(torch.float32),
             lambda k, v, c: jnp.sum(v, 0) / jnp.maximum(c, 1), (2,),
             "float32"),
    "any": (lambda k, v, c: (v > 0).any(0), lambda k, v, c: jnp.any(v > 0, 0),
            (3,), "float32"),
    "prod": (lambda k, v, c: v.prod(0), lambda k, v, c: jnp.prod(v, 0), (2,),
             "float32"),
    "trailing_slice": (lambda k, v, c: v[:, 1:].sum(0),
                       lambda k, v, c: jnp.sum(v[:, 1:], 0), (3,), "float32"),
}


@pytest.mark.parametrize("name", sorted(n for n in IDIOMS if IDIOMS[n][1]))
def test_idioms_and_premaps_derive_like_the_reference(name):
    tfn, jfn, shape, dt = IDIOMS[name]
    jd = jderive(jfn, jax.ShapeDtypeStruct((), jnp.int32),
                 jax.ShapeDtypeStruct(shape, getattr(jnp, dt)))
    td = tderive(tfn, KEY_SPEC, TC.ValueSpec(shape, getattr(torch, dt)))
    assert td.strategy == jd.strategy
    assert (td.spec is None) == (jd.spec is None)
    if td.spec is not None:
        assert _monoid_names(td.spec) == _monoid_names(jd.spec)


@pytest.mark.parametrize("name", sorted(IDIOMS))
def test_derived_spec_folds_to_the_reduce(name):
    """finalize(fold(values)) reproduces the torch reduce on fresh data."""
    tfn, _, shape, dt = IDIOMS[name]
    spec = TC.ValueSpec(shape, getattr(torch, dt))
    td = tderive(tfn, KEY_SPEC, spec, trust_semantics=True)
    vals = TC.rand_values(np.random.default_rng(5), spec, 11)
    key = torch.tensor(3, dtype=torch.int32)
    got = TC.finalize_fold(td.spec, vals, key)
    want = tfn(key, vals, torch.tensor(11, dtype=torch.int32))
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-5)


@pytest.mark.parametrize("fn,msg", [
    (lambda k, v, c: v[0] + v[1], "scan-fold"),
    (lambda k, v, c: v.cumsum(0)[-1], "scan-fold"),
    (lambda k, v, c: (v * c).sum(), "count flows"),
    (lambda k, v, c: (v + k).sum(), "key flows"),
    (lambda k, v, c: v, "escape"),
    (lambda k, v, c: (v * torch.arange(8.0)).sum(), "untainted operand"),
])
def test_refused_reducers_name_the_reason(fn, msg):
    with pytest.raises(ExtractionFailure, match=msg):
        analyze(fn, KEY_SPEC, TC.ValueSpec((), torch.float32))
    assert not tderive(fn, KEY_SPEC,
                       TC.ValueSpec((), torch.float32)).combinable


def test_mean_over_values_fails_like_an_unknown_op():
    d = tderive(lambda k, v, c: v.mean(0), KEY_SPEC,
                TC.ValueSpec((2,), torch.float32))
    assert d.spec is None and "mean" in d.failure


@pytest.mark.parametrize("name,dtype", [
    (m, dt) for m in ("add", "mul", "max", "min")
    for dt in ("float32", "float16", "int32", "int8", "bool")
] + [("and", "bool"), ("or", "bool")])
def test_monoid_identities_match_the_reference(name, dtype):
    jm, tm = JC.MONOIDS[name], TC.MONOIDS[name]
    want = np.asarray(jm.identity_like(
        jax.ShapeDtypeStruct((2,), getattr(jnp, dtype))))
    got = tm.identity_like((2,), getattr(torch, dtype),
                           device="cpu").numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("maker", ["sum_spec", "max_spec", "min_spec",
                                   "mean_spec", "count_spec",
                                   "logsumexp_spec"])
def test_builtin_specs_fold_like_the_reference(maker):
    rng = np.random.default_rng(2)
    vals = rng.standard_normal((9, 3)).astype(np.float32)
    jspec, tspec = getattr(JC, maker)(), getattr(TC, maker)()
    want = JC.finalize_fold(jspec, jnp.asarray(vals))
    got = TC.finalize_fold(tspec, torch.from_numpy(vals),
                           torch.tensor(0, dtype=torch.int32))
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-5)
    assert tspec.strategy == jspec.strategy
    assert _monoid_names(tspec) == _monoid_names(jspec)


def test_product_spec_and_validate_combiner():
    spec = TC.product_spec(
        [TC.sum_spec(), TC.max_spec()],
        finalize=lambda key, h, count: torch.cat([h[0], h[1]]))
    assert _monoid_names(spec) == ["add", "max"]
    vs = TC.ValueSpec((2,), torch.float32)
    assert TC.validate_combiner(
        spec, lambda k, v, c: torch.cat([v.sum(0), v.amax(0)]), vs)
    assert not TC.validate_combiner(
        spec, lambda k, v, c: torch.cat([v.sum(0), v.amin(0)]), vs)


# -- C.27: half-precision sums and products hold f32 ---------------------------

#: value dtype: (torch, jax, unit roundoff of one rounding to it)
HALF = {"bfloat16": (torch.bfloat16, jnp.bfloat16, 2.0**-8),
        "float16": (torch.float16, jnp.float16, 2.0**-11)}
HALF_REDUCERS = {
    "sum": (lambda k, v, c: v.sum(0), lambda k, v, c: jnp.sum(v, axis=0)),
    "prod": (lambda k, v, c: v.prod(0), lambda k, v, c: jnp.prod(v, axis=0)),
    "max": (lambda k, v, c: v.amax(0), lambda k, v, c: jnp.max(v, axis=0)),
    "min": (lambda k, v, c: v.amin(0), lambda k, v, c: jnp.min(v, axis=0)),
}
HALF_K = 8


def _half_apps(dtype, op, shape):
    import repro.core as J
    import repro_torch as T

    tdt, jdt, _ = HALF[dtype]
    tfn, jfn = HALF_REDUCERS[op]
    tapp = T.make_app(lambda item, emit: emit(item[0], item[1]), tfn,
                      key_space=HALF_K, value_spec=TC.ValueSpec(shape, tdt),
                      emit_capacity=1, max_values_per_key=64)
    japp = J.make_app(lambda item, emit: emit(item[0], item[1]), jfn,
                      key_space=HALF_K,
                      value_aval=jax.ShapeDtypeStruct(shape, jdt),
                      emit_capacity=1, max_values_per_key=64)
    return tapp, japp


@pytest.mark.parametrize("shape", [(), (3,)])
@pytest.mark.parametrize("op", list(HALF_REDUCERS))
@pytest.mark.parametrize("dtype", list(HALF))
def test_half_precision_derives_like_the_reference(dtype, op, shape):
    """C.27: a bf16/f16 sum or product derives a validated monoid with f32
    holders, max and min hold the value dtype, and the plans (auto, and
    auto with a workload hint) are the reference's."""
    import repro.core as J
    import repro_torch as T

    tdt, jdt, _ = HALF[dtype]
    tfn, jfn = HALF_REDUCERS[op]
    jv, tv = jax.ShapeDtypeStruct(shape, jdt), TC.ValueSpec(shape, tdt)
    jd = jderive(jfn, jax.ShapeDtypeStruct((), jnp.int32), jv)
    td = tderive(tfn, KEY_SPEC, tv)
    assert td.strategy == jd.strategy == "monoid"
    assert _monoid_names(td.spec) == _monoid_names(jd.spec)
    assert td.validated and jd.validated
    assert td.recommended_flow == jd.recommended_flow == "stream"
    jh = [str(l.dtype) for l in jax.tree.leaves(jd.spec.holder_avals(jv))]
    th = [str(s.dtype).removeprefix("torch.") for s in jax.tree.leaves(
        td.spec.holder_specs(tv), is_leaf=lambda x: isinstance(x, TC.ValueSpec))]
    assert th == jh == ["float32" if op in ("sum", "prod") else dtype]
    tapp, japp = _half_apps(dtype, op, shape)
    tmr = T.MapReduce(tapp, device="cpu")
    jmr = J.MapReduce(japp, cache=False)
    assert (tmr.plan.flow, tmr.plan.reason) == (jmr.plan.flow,
                                                jmr.plan.reason)
    assert tmr.plan.flow == "stream"
    tmr = T.MapReduce(tapp, device="cpu", n_pairs_hint=1 << 16)
    jmr = J.MapReduce(japp, n_pairs_hint=1 << 16, cache=False)
    assert (tmr.plan.flow, tmr.plan.reason) == (jmr.plan.flow,
                                                jmr.plan.reason)
    assert tmr.plan.cost.describe() == jmr.plan.cost.describe()


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("shape", [(), (3,)])
@pytest.mark.parametrize("op", list(HALF_REDUCERS))
@pytest.mark.parametrize("dtype", list(HALF))
def test_half_precision_values_match_the_reference(dtype, op, shape,
                                                   use_kernels):
    """C.27: the stream flow's results in the value dtype.  Max and min
    bit for bit with the reference; a sum or product is one rounding of
    its f32 accumulation, so within the dtype's unit roundoff u of the
    float64 result (plus 1e-6 for the f32 sum's own error) and within 2u
    of the reference's."""
    import repro.core as J
    import repro_torch as T

    tdt, jdt, u = HALF[dtype]
    rng = np.random.default_rng(11)
    n = 256
    keys = rng.integers(0, HALF_K, size=n).astype(np.int32)
    vals = rng.standard_normal((n,) + shape)
    if op == "prod":  # factors near 1: no overflow in a 32-factor product
        vals = 1.0 + 0.25 * vals
    half = torch.from_numpy(vals.astype(np.float32)).to(tdt)
    tapp, japp = _half_apps(dtype, op, shape)
    tmr = T.MapReduce(tapp, device="cpu", use_kernels=use_kernels)
    res = tmr.run((torch.from_numpy(keys), half))
    jres = J.MapReduce(japp, use_kernels=use_kernels, cache=False).run(
        (jnp.asarray(keys), jnp.asarray(half.float().numpy()).astype(jdt)))
    assert tmr.tiling.mode == ("additive" if op == "sum" else "dense")
    assert res.values.dtype == tdt
    np.testing.assert_array_equal(res.counts.numpy(), np.asarray(jres.counts))
    got = res.values.float().numpy().astype(np.float64)
    jgot = np.asarray(jres.values).astype(np.float64)
    if op in ("max", "min"):
        np.testing.assert_array_equal(got, jgot)
        return
    exact = half.double().numpy()
    want = np.stack([getattr(np, op)(exact[keys == k], axis=0)
                     for k in range(HALF_K)])
    np.testing.assert_allclose(got, want, rtol=u, atol=1e-6)
    np.testing.assert_allclose(got, jgot, rtol=2 * u, atol=2e-6)

"""The sort flow of the port against the reference's.

``repro_torch``'s ``SortCombiner`` and ``MapReduce(app, flow="sort",
device="cpu")`` against ``repro``'s on the same numpy inputs, with the
radix kernels off (one stable sort per chunk) and on (the reference's
Pallas pipeline in interpret mode, the port's kernels through their plain
versions).  All four modes (monoid, first, size, sequential); counts,
integer tables and max/min/first tables bit for bit, float sums within
rtol = atol = 1e-5.  Also: several chunks equal one, ``explain()`` shows
the buckets and levels, a forced sort flow on a reducer that cannot be
combined raises, a key space past the radix level budget raises when the
kernels are asked for (the reference falls back; the port does not), and
the sort collector's three state layouts cross between the packages in
both directions.
"""

import os
import sys
from functools import cache, partial

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
from repro_torch import interop  # noqa: E402
from repro_torch.core import collector as TCOL  # noqa: E402
from repro_torch.core import combiner as TC  # noqa: E402
from repro_torch.core.optimizer import KEY_SPEC  # noqa: E402
from repro_torch.core.optimizer import derive_combiner as tderive  # noqa: E402
from repro_torch.data import datasets  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

K = 37
SUM_TOL = dict(rtol=1e-5, atol=1e-5)

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
    "any": (lambda k, v, c: (v > 0).any(0), lambda k, v, c: jnp.any(v > 0, 0),
            (2,), "float32"),
    "first": (lambda k, v, c: v[0] * 2.0, lambda k, v, c: v[0] * 2.0, (2,),
              "float32"),
    "size": (lambda k, v, c: c * 3, lambda k, v, c: c * 3, (), "float32"),
}
EXACT = ("int_sum", "bbox", "int_max", "any", "first", "size")
MODES = {"int_sum": "monoid", "centroid": "monoid", "bbox": "monoid",
         "int_max": "monoid", "any": "monoid", "first": "first",
         "size": "size"}


@cache
def _specs(name):
    tfn, jfn, shape, dt = REDUCERS[name]
    jv = jax.ShapeDtypeStruct(shape, getattr(jnp, dt))
    tv = TC.ValueSpec(shape, getattr(torch, dt))
    return (jderive(jfn, jax.ShapeDtypeStruct((), jnp.int32), jv).spec, jv,
            tderive(tfn, KEY_SPEC, tv).spec, tv)


def _chunks(seed, n_chunks, n, shape, dt):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_chunks):
        keys = rng.integers(0, K + 1, size=n).astype(np.int32)  # K: sentinel
        if dt == "int32":
            vals = rng.integers(-50, 50, size=(n,) + shape).astype(np.int32)
        else:
            vals = rng.standard_normal((n,) + shape).astype(np.float32)
            vals.reshape(-1)[::7] = -0.0
            vals.reshape(-1)[3::11] = 0.0
        out.append((keys, vals))
    return out


# kernel pipelines: none, planned (one bucket at K = 37), and 8-key buckets
# at pad_align 16 (several regions and pad tiles)
KERNELS = {
    None: (None, None),
    "planned": (partial(jops.sort_segment_fold, interpret=True),
                tops.sort_segment_fold),
    "buckets": (partial(jops.sort_segment_fold, bucket_size=8, pad_align=16,
                        interpret=True),
                partial(tops.sort_segment_fold, bucket_size=8, pad_align=16)),
}


def _combiners(name, kernels, jspec=None, tspec=None, jv=None, tv=None):
    if jspec is None:
        jspec, jv, tspec, tv = _specs(name)
    jfold, tfold = KERNELS[kernels]
    return (JCOL.SortCombiner(jspec, K, jv, sort_fold_fn=jfold),
            TCOL.SortCombiner(tspec, K, tv, device="cpu",
                              sort_fold_fn=tfold))


def _fold(comb, state, keys, vals, jax_side):
    if jax_side:
        return comb.fold_chunk(state, JCOL.PairStream(jnp.asarray(keys),
                                                      jnp.asarray(vals), K))
    return comb.fold_chunk(state, TCOL.PairStream(torch.from_numpy(keys),
                                                  torch.from_numpy(vals), K))


def _assert_leaves(exact, jleaves, tleaves):
    for j, t in zip(jleaves, tleaves):
        j, t = np.asarray(j), t.numpy()
        assert j.shape == t.shape
        if exact and np.issubdtype(j.dtype, np.floating):
            np.testing.assert_array_equal(
                t.view(np.uint32), j.astype(np.float32).view(np.uint32))
        elif exact or not np.issubdtype(j.dtype, np.floating):
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, **SUM_TOL)


def _no_signed_zero(leaves):
    return [np.where(np.asarray(x) == 0, np.zeros_like(np.asarray(x)),
                     np.asarray(x)) for x in leaves]


@pytest.mark.parametrize("n_chunks", [1, 3])
@pytest.mark.parametrize("kernels", [None, "planned", "buckets"])
@pytest.mark.parametrize("name", list(REDUCERS))
def test_sort_combiner_matches_reference(name, kernels, n_chunks):
    jc, tc = _combiners(name, kernels)
    assert jc.mode == tc.mode == MODES[name]
    assert jc._fused_acc == tc.fused_acc
    assert jc._use_kernel == tc.use_kernel
    tv_shape, dt = REDUCERS[name][2], REDUCERS[name][3]
    chunks = _chunks(sum(map(ord, name)) + n_chunks, n_chunks, 60, tv_shape,
                     dt)
    js, ts = jc.init_state(), tc.init_state()
    for keys, vals in chunks:
        js = _fold(jc, js, keys, vals, True)
        ts = _fold(tc, ts, keys, vals, False)
    jt, jcounts = jc.tables_counts(js)
    tt, tcounts = tc.tables_counts(ts)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    tleaves = torch.utils._pytree.tree_leaves(tt)
    if name == "bbox" and kernels is None:
        # The reference's plain sort fold scans max/min runs with
        # lax.associative_scan, whose interleave turns every -0 into +0
        # (ROADMAP C.13).  The port keeps JAX's max/min rule; it must equal
        # the reference's stream collector bit for bit, and the reference's
        # sort collector up to the sign of zero.
        jstream = JCOL.StreamCombiner(_specs(name)[0], K, _specs(name)[1])
        ss = jstream.init_state()
        for keys, vals in chunks:
            ss = jstream.fold_chunk(ss, JCOL.PairStream(
                jnp.asarray(keys), jnp.asarray(vals), K))
        _assert_leaves(True, jax.tree.leaves(jstream.tables_counts(ss)[0]),
                       tleaves)
        _assert_leaves(True, _no_signed_zero(jax.tree.leaves(jt)),
                       [torch.from_numpy(x) for x in _no_signed_zero(
                           [t.numpy() for t in tleaves])])
    else:
        _assert_leaves(name in EXACT, jax.tree.leaves(jt), tleaves)
    jg, tg = jc.finalize(js), tc.finalize(ts)
    for j, t in zip(jax.tree.leaves(jg.values),
                    torch.utils._pytree.tree_leaves(tg.values)):
        np.testing.assert_allclose(t.numpy().astype(np.float64),
                                   np.asarray(j).astype(np.float64),
                                   **SUM_TOL)


def test_sequential_mode_matches_reference():
    """Coupled holders (logsumexp): the sorted pairs one at a time."""
    jspec, tspec = JC.logsumexp_spec(), TC.logsumexp_spec()
    jv = jax.ShapeDtypeStruct((), jnp.float32)
    tv = TC.ValueSpec((), torch.float32)
    jc, tc = _combiners(None, None, jspec, tspec, jv, tv)
    assert jc.mode == tc.mode == "sequential"
    js, ts = jc.init_state(), tc.init_state()
    for keys, vals in _chunks(4, 2, 40, (), "float32"):
        js = _fold(jc, js, keys, vals, True)
        ts = _fold(tc, ts, keys, vals, False)
    (jm, jl), jcounts = js
    (tm, tl), tcounts = ts
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)


def test_single_shot_sort_flow_and_the_fused_accumulator():
    """``sort_flow``: one chunk, keys with the sentinel; float sums take
    the fused accumulator off the kernel path, integer sums do not."""
    spec_f, spec_i = TC.sum_spec(), TC.sum_spec()
    f32 = TC.ValueSpec((), torch.float32)
    assert TCOL.SortCombiner(spec_f, 64, f32, device="cpu").fused_acc
    assert not TCOL.SortCombiner(spec_i, 64, TC.ValueSpec((), torch.int32),
                                 device="cpu").fused_acc
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 65, 200).astype(np.int32)
    vals = rng.standard_normal(200).astype(np.float32)
    got = TCOL.sort_flow(spec_f, TCOL.PairStream(
        torch.from_numpy(keys), torch.from_numpy(vals), 64))
    want = JCOL.sort_flow(JC.sum_spec(), JCOL.PairStream(
        jnp.asarray(keys), jnp.asarray(vals), 64))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               **SUM_TOL)


# -- MapReduce(app, flow="sort") -----------------------------------------------


@cache
def _reference(name, use_kernels):
    japp, jitems = japps.build(name, np.random.default_rng(0), scale=0.01)
    mr = J.MapReduce(japp, flow="sort", use_kernels=use_kernels, cache=False)
    res = mr.run(jitems)
    return (mr.plan.derivation.strategy, np.asarray(res.counts),
            jax.tree.map(np.asarray, res.values))


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("name", list(tapps.ALL))
def test_phoenix_apps_match_reference(name, use_kernels):
    strategy, jcounts, jvals = _reference(name, use_kernels)
    tapp, titems = tapps.build(name, np.random.default_rng(0), scale=0.01,
                               device="cpu")
    mr = T.MapReduce(tapp, flow="sort", device="cpu", use_kernels=use_kernels)
    res = mr.run(titems)
    assert (mr.plan.flow, mr.plan.derivation.strategy) == ("sort", strategy)
    np.testing.assert_array_equal(res.counts.numpy(), jcounts)
    tvals = res.values.numpy()
    assert tvals.shape == jvals.shape
    if np.issubdtype(jvals.dtype, np.integer):
        np.testing.assert_array_equal(tvals, jvals)
    else:
        np.testing.assert_allclose(tvals, jvals, **SUM_TOL)


def _keyed_sum(seed, items, key_space):
    return datasets.keyed_sum_data(np.random.default_rng(seed), items=items,
                                   key_space=key_space)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_keyed_sum_matches_reference_and_numpy(use_kernels):
    k = 3000
    keys, weights = _keyed_sum(1, 300, k)
    jres = J.MapReduce(J.make_app(
        lambda item, emit: emit(item[0], item[1]),
        lambda kk, v, c: jnp.sum(v, 0), key_space=k,
        value_aval=jax.ShapeDtypeStruct((), jnp.float32), emit_capacity=8,
        max_values_per_key=64), flow="sort", use_kernels=use_kernels,
        stream_chunk_pairs=1024, cache=False).run(
        (jnp.asarray(keys), jnp.asarray(weights)))
    mr = T.MapReduce(tapps.KeyedSum(k), flow="sort", device="cpu",
                     use_kernels=use_kernels, stream_chunk_pairs=1024)
    res = mr.run((keys, weights))
    want = np.bincount(keys.reshape(-1), weights=weights.reshape(-1)
                       .astype(np.float64), minlength=k)
    np.testing.assert_array_equal(res.counts.numpy(), np.asarray(jres.counts))
    np.testing.assert_allclose(res.values.numpy(), want, **SUM_TOL)
    # The reference's plain path sums a run as the difference of an f32
    # running sum over the chunk, so its error grows with the chunk's
    # prefix: up to 2^-23 x 1024 weights below 1 (the port differences in
    # float64).  Its kernel path sums each key's pairs directly.
    atol = SUM_TOL["atol"] + (0 if use_kernels else 2.0**-23 * 1024)
    np.testing.assert_allclose(res.values.numpy(), np.asarray(jres.values),
                               rtol=SUM_TOL["rtol"], atol=atol)
    assert mr.tiling.use_kernel == use_kernels


@pytest.mark.parametrize("use_kernels", [False, True])
def test_several_chunks_equal_one(use_kernels):
    k = 4096
    keys, weights = _keyed_sum(2, 512, k)
    app = tapps.KeyedSum(k)
    one = T.MapReduce(app, flow="sort", device="cpu",
                      use_kernels=use_kernels).run((keys, weights))
    many = T.MapReduce(app, flow="sort", device="cpu",
                       use_kernels=use_kernels,
                       stream_chunk_pairs=300).run((keys, weights))
    np.testing.assert_array_equal(many.counts.numpy(), one.counts.numpy())
    np.testing.assert_allclose(many.values.numpy(), one.values.numpy(),
                               **SUM_TOL)
    ints = T.make_app(lambda win, emit: emit(win, torch.ones_like(win)),
                      lambda kk, v, c: v.sum(), key_space=k,
                      value_spec=TC.ValueSpec((), torch.int32),
                      emit_capacity=8)
    a = T.MapReduce(ints, flow="sort", device="cpu").run(keys)
    b = T.MapReduce(ints, flow="sort", device="cpu",
                    stream_chunk_pairs=100).run(keys)
    np.testing.assert_array_equal(a.values.numpy(), b.values.numpy())
    np.testing.assert_array_equal(
        a.values.numpy(), np.bincount(keys.reshape(-1), minlength=k))


def test_int_tables_exact_beyond_f32():
    app = T.make_app(lambda item, emit: emit(torch.zeros_like(item), item),
                     lambda k, v, c: v.sum(), key_space=2,
                     value_spec=TC.ValueSpec((), torch.int32),
                     emit_capacity=1)
    vals = np.full(1024, (1 << 20) + 7, np.int32)
    for use_kernels in (False, True):
        res = T.MapReduce(app, flow="sort", device="cpu",
                          use_kernels=use_kernels,
                          stream_chunk_pairs=64).run(vals)
        assert int(res.values[0]) == int(vals.astype(np.int64).sum())


def test_masked_emission_and_first_idiom():
    masked = T.make_app(
        lambda item, emit: emit(item, torch.ones_like(item), valid=item != 3),
        lambda k, v, c: v.sum(), key_space=8,
        value_spec=TC.ValueSpec((), torch.int32), emit_capacity=8)
    toks = np.array([[0, 3, 3, 1, 2, 3, 0, 1]] * 40, np.int32)
    res = T.MapReduce(masked, flow="sort", device="cpu",
                      stream_chunk_pairs=64).run(toks)
    assert int(res.counts[3]) == 0 and int(res.values[0]) == 80
    first = T.make_app(lambda item, emit: emit(item[0], item[1]),
                       lambda k, v, c: v[0], key_space=4,
                       value_spec=TC.ValueSpec((), torch.float32),
                       emit_capacity=1)
    keys = np.array([2, 0, 2, 1, 0, 1, 3, 2] * 16, np.int32)
    vals = np.arange(len(keys), dtype=np.float32)
    mr = T.MapReduce(first, flow="sort", device="cpu", stream_chunk_pairs=16)
    assert mr.tiling.sort_mode == "first"
    got = mr.run((keys, vals)).values.numpy()
    for k in range(4):
        assert got[k] == vals[np.argmax(keys == k)]


def test_explain_shows_buckets_and_levels():
    one = T.MapReduce(tapps.KeyedSum(1 << 18), flow="sort", device="cpu",
                      use_kernels=True)
    assert "buckets=32×8192keys levels=1(32)" in one.explain()
    assert "radix kernels" in one.explain()
    two = T.MapReduce(tapps.KeyedSum(1 << 20), flow="sort", device="cpu",
                      use_kernels=True)
    text = two.explain()
    assert "buckets=64×16384keys levels=2(8·8)" in text
    assert "flow: sort" in text
    assert two.tiling.level_fanouts == (8, 8) and two.tiling.levels == 2
    plain = T.MapReduce(tapps.KeyedSum(1 << 20), flow="sort", device="cpu",
                        use_kernels=False)
    assert "sorted runs" in plain.explain()


def test_auto_keeps_the_stream_flow():
    assert T.MapReduce(tapps.KeyedSum(1 << 20), device="cpu").plan.flow == (
        "stream")


def test_forced_sort_on_noncombinable_raises():
    app = T.make_app(lambda item, emit: emit(item, item.float()),
                     lambda k, v, c: v[0] + v[1], key_space=8,
                     value_spec=TC.ValueSpec((), torch.float32),
                     emit_capacity=1)
    with pytest.raises(ValueError, match="derivation failed"):
        T.MapReduce(app, flow="sort", device="cpu")


def test_level_budget_raises_with_kernels_and_not_without(monkeypatch):
    """The reference warns and falls back to its plain fold past the level
    budget; the port, asked for the kernels, raises with the plan's reason
    (the same wrappers launch the kernels on CUDA tensors)."""
    monkeypatch.setattr(tops, "MAX_RADIX_LEVELS", 1)
    monkeypatch.setattr(tops, "LEAF_BUCKET_CAP", 256)
    monkeypatch.setattr(tops, "MAX_RADIX_FANOUT", 4)
    k = 4096
    keys, weights = _keyed_sum(3, 64, k)
    mr = T.MapReduce(tapps.KeyedSum(k), flow="sort", device="cpu",
                     use_kernels=True)
    assert any("LEVEL BUDGET" in n for n in mr.tiling.notes)
    with pytest.raises(ValueError, match="radix levels"):
        mr.run((keys, weights))
    res = mr.run((keys, weights), options=T.ExecutionOptions(
        use_kernels=False))
    np.testing.assert_array_equal(res.counts.numpy(),
                                  np.bincount(keys.reshape(-1), minlength=k))


def test_options_pin_the_radix_plan():
    k = 1000
    keys, weights = _keyed_sum(4, 200, k)
    mr = T.MapReduce(tapps.KeyedSum(k), flow="sort", device="cpu",
                     use_kernels=True)
    base = mr.run((keys, weights))
    for opts in (T.ExecutionOptions(bucket_size=16, level_fanouts=(8, 8)),
                 T.ExecutionOptions(bucket_size=64)):
        res = mr.run((keys, weights), options=opts)
        np.testing.assert_array_equal(res.counts.numpy(),
                                      base.counts.numpy())
        np.testing.assert_allclose(res.values.numpy(), base.values.numpy(),
                                   **SUM_TOL)


# -- carried state across the packages -----------------------------------------


@pytest.mark.parametrize("name,jkern,tkern", [
    ("size", None, None),              # [K] counts
    ("centroid", None, None),          # fused [K, ΣD+1] on both sides
    ("centroid", None, "buckets"),     # fused -> (tables, counts)
    ("centroid", "planned", None),     # (tables, counts) -> fused
    ("bbox", "buckets", "buckets"),    # (tables, counts)
    ("int_sum", None, "planned"),      # integer tables
])
def test_sort_state_crosses_and_continues_exactly(name, jkern, tkern):
    jspec, jv, tspec, tv = _specs(name)
    jc = JCOL.SortCombiner(jspec, K, jv, sort_fold_fn=KERNELS[jkern][0])
    tc = TCOL.SortCombiner(tspec, K, tv, device="cpu",
                           sort_fold_fn=KERNELS[tkern][1])
    shape, dt = REDUCERS[name][2], REDUCERS[name][3]
    (ka, va), (kb, vb) = _chunks(len(name), 2, 60, shape, dt)
    after_a = _fold(jc, jc.init_state(), ka, va, True)
    want = _fold(jc, after_a, kb, vb, True)
    seeded = interop.state_from_repro(tc, jax.tree.map(np.asarray, after_a))
    got = _fold(tc, seeded, kb, vb, False)
    back = interop.state_to_repro(tc, got, fused=jc._fused_acc)
    if jc.mode == "size":
        np.testing.assert_array_equal(back, np.asarray(want))
        return
    if jc._fused_acc:
        np.testing.assert_allclose(back, np.asarray(want), **SUM_TOL)
        return
    (jt, jcounts), (bt, bcounts) = want, back
    np.testing.assert_array_equal(bcounts, np.asarray(jcounts))
    for j, b in zip(jax.tree.leaves(jt), jax.tree.leaves(bt)):
        if name in EXACT:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(j))
        else:
            np.testing.assert_allclose(np.asarray(b), np.asarray(j),
                                       **SUM_TOL)

"""The port's StreamCombiner against the reference's, mode by mode.

The same numpy pair chunks go through ``repro.core.collector.StreamCombiner``
and ``repro_torch.core.collector.StreamCombiner`` built on equivalent
combiners, in every fold mode (fused/per-leaf additive, dense with and
without the fold kernel, scatter, first, size, sequential), unchunked and
over several chunks, with and without key blocks.  Counts, integer tables
and max/min/first tables must be bitwise equal; float sums agree within
rtol=atol=1e-5 (another summation order).
"""

from functools import cache, partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import collector as JCOL  # noqa: E402
from repro.core import combiner as JC  # noqa: E402
from repro.core.optimizer import derive_combiner as jderive  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import collector as TCOL  # noqa: E402
from repro_torch.core import combiner as TC  # noqa: E402
from repro_torch.core.optimizer import KEY_SPEC  # noqa: E402
from repro_torch.core.optimizer import derive_combiner as tderive  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

K = 37

# name: (torch reduce, jax reduce, value shape, dtype) — derived specs
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

# (reducer, forced mode or None, kernels on, expected mode)
CASES = [
    ("int_sum", None, False, "additive"),
    ("int_sum", None, True, "additive"),
    ("centroid", None, False, "additive"),
    ("centroid", None, True, "additive"),  # fused accumulator
    ("bbox", None, False, "dense"),
    ("bbox", None, True, "dense"),  # chunk_monoid_fold
    ("int_max", None, True, "dense"),  # kernel does not take int tables
    ("any", None, False, "dense"),
    ("bbox", "scatter", False, "scatter"),
    ("int_sum", "scatter", False, "scatter"),
    ("first", None, False, "first"),
    ("size", None, False, "size"),
]


@cache  # one derivation per reducer for the whole module
def _specs(name):
    tfn, jfn, shape, dt = REDUCERS[name]
    jv = jax.ShapeDtypeStruct(shape, getattr(jnp, dt))
    tv = TC.ValueSpec(shape, getattr(torch, dt))
    js = jderive(jfn, jax.ShapeDtypeStruct((), jnp.int32), jv).spec
    ts = tderive(tfn, KEY_SPEC, tv).spec
    assert js is not None and ts is not None
    return js, jv, ts, tv


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


def _combiners(name, mode, kernels, key_block, chunk):
    js, jv, ts, tv = _specs(name)
    jfold = jmono = tfold = tmono = None
    if kernels:
        jfold = partial(jops.onehot_fold, block_k=key_block, interpret=True)
        jmono = partial(jops.chunk_monoid_fold, block_k=key_block,
                        interpret=True)
        tfold = partial(tops.onehot_fold, block_k=key_block)
        tmono = partial(tops.chunk_monoid_fold, block_k=key_block)
    jc = JCOL.StreamCombiner(js, K, jv, fold_fn=jfold, monoid_fold_fn=jmono,
                             chunk_pairs=chunk, key_block=key_block,
                             mode=mode)
    tc = TCOL.StreamCombiner(ts, K, tv, device="cpu", fold_fn=tfold,
                             monoid_fold_fn=tmono, chunk_pairs=chunk,
                             key_block=key_block, mode=mode)
    return jc, tc


def _assert_tables(name, jt, tt):
    for j, t in zip(jax.tree.leaves(jt), jax.tree.leaves(tt)):
        j, t = np.asarray(j), t.numpy()
        assert j.shape == t.shape
        exact = (name in ("bbox", "first", "any") or not np.issubdtype(
            j.dtype, np.floating))
        if exact and np.issubdtype(j.dtype, np.floating):
            np.testing.assert_array_equal(t.view(np.uint32),
                                          j.astype(np.float32).view(np.uint32))
        elif exact:
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_chunks,key_block", [(1, None), (3, None),
                                                (3, 8), (1, 10)])
@pytest.mark.parametrize("name,mode,kernels,want_mode", CASES)
def test_stream_combiner_matches_reference(name, mode, kernels, want_mode,
                                           n_chunks, key_block):
    tv_shape, dt = REDUCERS[name][2], REDUCERS[name][3]
    chunks = _chunks(sum(map(ord, name)) + n_chunks, n_chunks, 50, tv_shape,
                     dt)
    jc, tc = _combiners(name, mode, kernels, key_block, chunk=50)
    assert jc.mode == tc.mode == want_mode
    assert jc._fused_acc == tc.fused_acc
    js, ts = jc.init_state(), tc.init_state()
    for keys, vals in chunks:
        js = jc.fold_chunk(js, JCOL.PairStream(jnp.asarray(keys),
                                               jnp.asarray(vals), K))
        ts = tc.fold_chunk(ts, TCOL.PairStream(torch.from_numpy(keys),
                                               torch.from_numpy(vals), K))
    jt, jcounts = jc.tables_counts(js)
    tt, tcounts = tc.tables_counts(ts)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    _assert_tables(name, jt, tt)
    jg, tg = jc.finalize(js), tc.finalize(ts)
    np.testing.assert_array_equal(tg.keys.numpy(), np.asarray(jg.keys))
    for j, t in zip(jax.tree.leaves(jg.values), jax.tree.leaves(tg.values)):
        np.testing.assert_allclose(t.numpy().astype(np.float64),
                                   np.asarray(j).astype(np.float64),
                                   rtol=1e-5, atol=1e-5)


def test_sequential_mode_matches_reference():
    """Coupled holders (logsumexp) fold one pair at a time in both."""
    chunks = _chunks(4, 2, 40, (), "float32")
    jspec, tspec = JC.logsumexp_spec(), TC.logsumexp_spec()
    jv = jax.ShapeDtypeStruct((), jnp.float32)
    tv = TC.ValueSpec((), torch.float32)
    jc = JCOL.StreamCombiner(jspec, K, jv)
    tc = TCOL.StreamCombiner(tspec, K, tv, device="cpu")
    assert jc.mode == tc.mode == "sequential"
    js, ts = jc.init_state(), tc.init_state()
    for keys, vals in chunks:
        js = jc.fold_chunk(js, JCOL.PairStream(jnp.asarray(keys),
                                               jnp.asarray(vals), K))
        ts = tc.fold_chunk(ts, TCOL.PairStream(torch.from_numpy(keys),
                                               torch.from_numpy(vals), K))
    (jm, jl), jcounts = js
    (tm, tl), tcounts = ts
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)


def test_scatter_budget_warns_and_matches_mode():
    _, _, ts, tv = _specs("centroid")
    with pytest.warns(TCOL.LoweringFallbackWarning):
        tc = TCOL.StreamCombiner(ts, K, tv, device="cpu",
                                 chunk_pairs=1 << 24)
    assert tc.mode == "scatter"


@pytest.mark.parametrize("key_space,chunk", [(100, None), (100, 1 << 20),
                                             (1 << 20, 4096), (7, 1 << 30)])
def test_dense_key_block_rule_matches_reference(key_space, chunk):
    assert (TCOL.choose_dense_key_block(key_space, chunk)
            == JCOL.choose_dense_key_block(key_space, chunk))

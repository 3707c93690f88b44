"""Carried stream state across the two packages (``repro_torch.interop``).

A fold seeded from a ``repro`` stream state must continue exactly as the
reference's next fold: the reference folds chunk A, its state crosses into
the port, the port folds chunk B, and the result must equal the
reference's fold of A then B (and the state must cross back).
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import collector as JCOL  # noqa: E402
from repro.core.optimizer import derive_combiner as jderive  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import collector as TCOL  # noqa: E402
from repro_torch.core import combiner as TC  # noqa: E402
from repro_torch.core.optimizer import KEY_SPEC  # noqa: E402
from repro_torch.core.optimizer import derive_combiner as tderive  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

K = 29
REDUCERS = {
    "centroid": (lambda k, v, c: v.sum(0) / c.clamp(min=1).to(torch.float32),
                 lambda k, v, c: jnp.sum(v, 0) / jnp.maximum(c, 1), (3,),
                 "float32"),
    "int_sum": (lambda k, v, c: v.sum(), lambda k, v, c: jnp.sum(v), (),
                "int32"),
    "bbox": (lambda k, v, c: torch.cat([v.amax(0), v.amin(0)]),
             lambda k, v, c: jnp.concatenate([jnp.max(v, 0), jnp.min(v, 0)]),
             (2,), "float32"),
    "size": (lambda k, v, c: c + 1, lambda k, v, c: c + 1, (), "float32"),
}


def _chunk(rng, shape, dt, n=60):
    keys = rng.integers(0, K + 1, size=n).astype(np.int32)
    if dt == "int32":
        vals = rng.integers(-9, 9, size=(n,) + shape).astype(np.int32)
    else:
        vals = rng.standard_normal((n,) + shape).astype(np.float32)
    return keys, vals


# (reducer, reference kernels on, port kernels on): the layouts may differ
@pytest.mark.parametrize("name,jkern,tkern", [
    ("centroid", True, True), ("centroid", True, False),
    ("centroid", False, True), ("centroid", False, False),
    ("int_sum", True, True), ("bbox", True, True), ("bbox", False, True),
    ("size", False, False)])
def test_fold_seeded_from_reference_state_continues_exactly(name, jkern,
                                                            tkern):
    tfn, jfn, shape, dt = REDUCERS[name]
    jv = jax.ShapeDtypeStruct(shape, getattr(jnp, dt))
    tv = TC.ValueSpec(shape, getattr(torch, dt))
    jspec = jderive(jfn, jax.ShapeDtypeStruct((), jnp.int32), jv).spec
    tspec = tderive(tfn, KEY_SPEC, tv).spec
    jc = JCOL.StreamCombiner(
        jspec, K, jv,
        fold_fn=partial(jops.onehot_fold, interpret=True) if jkern else None,
        monoid_fold_fn=(partial(jops.chunk_monoid_fold, interpret=True)
                        if jkern else None))
    tc = TCOL.StreamCombiner(
        tspec, K, tv, device="cpu",
        fold_fn=tops.onehot_fold if tkern else None,
        monoid_fold_fn=tops.chunk_monoid_fold if tkern else None)
    rng = np.random.default_rng(len(name))
    (ka, va), (kb, vb) = _chunk(rng, shape, dt), _chunk(rng, shape, dt)

    def jfold(state, k, v):
        return jc.fold_chunk(state, JCOL.PairStream(jnp.asarray(k),
                                                    jnp.asarray(v), K))

    after_a = jfold(jc.init_state(), ka, va)
    want = jfold(after_a, kb, vb)
    seeded = interop.state_from_repro(tc, jax.tree.map(np.asarray, after_a))
    got = tc.fold_chunk(seeded, TCOL.PairStream(torch.from_numpy(kb),
                                                torch.from_numpy(vb), K))

    wt, wc = jc.tables_counts(want)
    gt, gc = tc.tables_counts(got)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    for w, g in zip(jax.tree.leaves(wt), jax.tree.leaves(gt)):
        w, g = np.asarray(w), g.numpy()
        if name == "centroid":  # f32 sums: another summation order
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(g, w)

    back = interop.state_to_repro(tc, got, fused=jc._fused_acc)
    for w, b in zip(jax.tree.leaves(want), jax.tree.leaves(back)):
        assert np.asarray(w).shape == np.asarray(b).shape
        np.testing.assert_allclose(np.asarray(b, np.float64),
                                   np.asarray(w, np.float64),
                                   rtol=1e-5, atol=1e-5)

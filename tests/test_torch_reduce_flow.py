"""The reduce flow (the paper's baseline): the port's ``reduce_flow`` and
``MapReduce(app, flow="reduce")`` against the reference's, on the same
numpy inputs.

* ``collector.reduce_flow`` with keys holding more values than the window
  (``count > Lmax``: counts unclipped, the first Lmax values in emission
  order), a non-zero ``pad_value``, sentinel keys and order-dependent
  reducers, which see the same window only if the sort is stable;
* ``MapReduce(...).run`` with ``n_valid``;
* the seven Phoenix apps and the bounding-box app under ``flow="reduce"``
  (the bounding box sees the zero padding, as in the reference);
* the slice as a whole: ``flow="auto"`` sends a reducer the optimizer
  cannot turn into a combiner to the reduce flow, as the reference does.

Counts and integer results must be equal (values, not dtypes: the port's
integer sums may be int64, ROADMAP C.5); max/min bit for bit; float sums
within rtol=atol=1e-5.
"""

import os
import sys
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
from repro.core import engine as JENG  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch import apps as tapps  # noqa: E402
from repro_torch.core import collector as TCOL  # noqa: E402
from repro_torch.core import combiner as TC  # noqa: E402

SUM_TOL = dict(rtol=1e-5, atol=1e-5)
SCALE = 0.01


def _weights(n, like):
    return torch.arange(1, n + 1, dtype=like.dtype, device=like.device)


# name: (torch reduce, jax reduce, value shape, dtype, exact)
REDUCERS = {
    # position-weighted: only a stable sort gives the same window
    "weighted": (lambda k, v, c: (v * _weights(v.shape[0], v)).sum() + k,
                 lambda k, v, c: jnp.sum(v * jnp.arange(1, v.shape[0] + 1,
                                                        dtype=v.dtype)) + k,
                 (), "int32", True),
    "last_kept": (lambda k, v, c: v[(c - 1).clamp(min=0)],
                  lambda k, v, c: v[jnp.maximum(c - 1, 0)], (2,), "float32",
                  True),
    "bbox": (lambda k, v, c: torch.cat([v.amax(0), v.amin(0)]),
             lambda k, v, c: jnp.concatenate([jnp.max(v, 0), jnp.min(v, 0)]),
             (2,), "float32", True),
    "mean": (lambda k, v, c: v.sum(0) / c.clamp(min=1).to(v.dtype),
             lambda k, v, c: jnp.sum(v, 0) / jnp.maximum(c, 1), (3,),
             "float32", False),
}


def _stream(n, k, shape, dt, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, k + 1, size=n).astype(np.int32)  # k: sentinel
    keys[: n // 4] = 1  # a hot key, far past Lmax
    rng.shuffle(keys)
    if dt == "int32":
        vals = rng.integers(-9, 10, size=(n,) + shape).astype(np.int32)
    else:
        vals = rng.standard_normal((n,) + shape).astype(np.float32) + 2
    return keys, vals


def _assert_same(exact, jvals, tvals):
    j, t = np.asarray(jvals), tvals.numpy()
    assert j.shape == t.shape
    if exact and np.issubdtype(j.dtype, np.floating):
        np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))
    elif exact:
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j, **SUM_TOL)


@pytest.mark.parametrize("pad_value", [0, 5, -3])
@pytest.mark.parametrize("lmax", [1, 4, 32])
@pytest.mark.parametrize("name", list(REDUCERS))
def test_reduce_flow_matches_reference(name, lmax, pad_value):
    tfn, jfn, shape, dt, exact = REDUCERS[name]
    k = 13
    keys, vals = _stream(400, k, shape, dt, seed=lmax + 7 * len(name))
    jg = JCOL.reduce_flow(jfn, JCOL.PairStream(jnp.asarray(keys),
                                               jnp.asarray(vals), k),
                          max_values_per_key=lmax, pad_value=pad_value)
    tg = TCOL.reduce_flow(tfn, TCOL.PairStream(torch.from_numpy(keys),
                                               torch.from_numpy(vals), k),
                          max_values_per_key=lmax, pad_value=pad_value)
    counts = tg.counts.numpy()
    np.testing.assert_array_equal(counts, np.asarray(jg.counts))
    np.testing.assert_array_equal(counts, np.bincount(keys, minlength=k + 1)
                                  [:k])  # unclipped
    assert counts.max() > lmax
    np.testing.assert_array_equal(tg.keys.numpy(), np.arange(k))
    _assert_same(exact, jg.values, tg.values)


def test_windows_hold_the_first_values_in_emission_order():
    """A hot key's window is its first Lmax values as emitted; the padding
    fills the rest of a short key's window."""
    keys = np.array([2, 0, 2, 2, 1, 2, 0, 3], np.int32)  # 3: sentinel
    vals = np.arange(10, 18, dtype=np.int32)

    def grab(k, v, c):
        return v * 1  # the window itself, [Lmax]

    g = TCOL.reduce_flow(grab, TCOL.PairStream(torch.from_numpy(keys),
                                               torch.from_numpy(vals), 3),
                         max_values_per_key=3, pad_value=-1)
    seen = g.values.numpy()
    np.testing.assert_array_equal(seen, [[11, 16, -1], [14, -1, -1],
                                         [10, 12, 13]])
    np.testing.assert_array_equal(g.counts.numpy(), [2, 1, 4])


def test_window_blocks_do_not_change_the_result(monkeypatch):
    keys, vals = _stream(500, 40, (3,), "float32", seed=3)
    tfn = REDUCERS["bbox"][0]
    stream = TCOL.PairStream(torch.from_numpy(keys), torch.from_numpy(vals),
                             40)
    whole = TCOL.reduce_flow(tfn, stream, max_values_per_key=16, pad_value=0)
    monkeypatch.setattr(TCOL, "REDUCE_WINDOW_ELEMS", 16 * 7)  # 7 keys a block
    blocked = TCOL.reduce_flow(tfn, stream, max_values_per_key=16,
                               pad_value=0)
    np.testing.assert_array_equal(blocked.values.numpy().view(np.uint32),
                                  whole.values.numpy().view(np.uint32))


def _windows_app(torch_side, k=16):
    """Items of 4 keys, some invalid; reduce = position-weighted sum."""
    tfn, jfn, *_ = REDUCERS["weighted"]
    if torch_side:
        return T.make_app(
            lambda win, emit: emit(win, win * 3, valid=win != 5),
            tfn, key_space=k, value_spec=TC.ValueSpec((), torch.int32),
            emit_capacity=4, max_values_per_key=8, pad_value=2)
    return J.make_app(
        lambda win, emit: emit(win, win * 3, valid=win != 5),
        jfn, key_space=k, value_aval=jax.ShapeDtypeStruct((), jnp.int32),
        emit_capacity=4, max_values_per_key=8, pad_value=2)


@pytest.mark.parametrize("n_valid", [None, 0, 37, 120])
def test_run_with_n_valid_matches_reference(n_valid):
    items = np.random.default_rng(4).integers(-2, 20, size=(120, 4)).astype(
        np.int32)
    jmr = J.MapReduce(_windows_app(False), flow="reduce", cache=False)
    # the reference's engine takes n_valid (its public run does not)
    _, jvals, jcounts = JENG.run_local(jmr.app, jmr.plan, jnp.asarray(items),
                                       n_valid=n_valid)
    mr = T.MapReduce(_windows_app(True), flow="reduce", device="cpu")
    res = mr.run(items, n_valid=n_valid)
    assert mr.plan.flow == "reduce" and not mr.plan.optimized
    assert mr.plan.reason == "forced by user" and mr.tiling is None
    np.testing.assert_array_equal(res.counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(res.values.numpy(), np.asarray(jvals))
    head = items[: 120 if n_valid is None else n_valid].reshape(-1)
    want = np.bincount(head[(head >= 0) & (head < 16) & (head != 5)],
                       minlength=16)
    np.testing.assert_array_equal(res.counts.numpy(), want)


class JBoundingBox(japps.KMeans):
    def reduce(self, key, values, count):
        return jnp.concatenate([jnp.max(values, axis=0),
                                jnp.min(values, axis=0)])


@cache
def _reference(name):
    if name == "BB":
        _, items = japps.build("KM", np.random.default_rng(0), scale=SCALE)
        japp = JBoundingBox()
    else:
        japp, items = japps.build(name, np.random.default_rng(0), scale=SCALE)
    res = J.MapReduce(japp, flow="reduce", cache=False).run(items)
    return np.asarray(res.counts), jax.tree.map(np.asarray, res.values)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("name", list(tapps.ALL) + ["BB"])
def test_phoenix_apps_match_reference(name, use_kernels):
    """The reduce flow runs no kernel: ``use_kernels`` changes nothing."""
    jcounts, jvals = _reference(name)
    tapp, titems = tapps.build("KM" if name == "BB" else name,
                               np.random.default_rng(0), scale=SCALE,
                               device="cpu")
    if name == "BB":
        tapp = tapps.BoundingBox()
    res = T.MapReduce(tapp, flow="reduce", device="cpu",
                      use_kernels=use_kernels).run(titems)
    np.testing.assert_array_equal(res.counts.numpy(), jcounts)
    exact = name == "BB" or np.issubdtype(jvals.dtype, np.integer)
    _assert_same(exact, jvals, res.values)


def test_bounding_box_sees_the_padding():
    """Keys with fewer values than Lmax reduce windows padded with 0: a
    box of negative points gets max 0 under the reduce flow (the
    reference's semantics, kept), its true max under the combine flow."""
    pts = -1.0 - np.random.default_rng(5).random((6, 3)).astype(np.float32)
    items = (np.array([0, 0, 1, 1, 1, 2], np.int32), pts)
    red = T.MapReduce(tapps.BoundingBox(), flow="reduce",
                      device="cpu").run(items).values.numpy()
    comb = T.MapReduce(tapps.BoundingBox(), flow="combine",
                       device="cpu").run(items).values.numpy()
    jred = np.asarray(J.MapReduce(JBoundingBox(), flow="reduce",
                                  cache=False).run(items).values)
    np.testing.assert_array_equal(red.view(np.uint32), jred.view(np.uint32))
    assert (red[:3, :3] == 0).all() and (comb[:3, :3] < -1).all()
    np.testing.assert_array_equal(red[:3, 3:], comb[:3, 3:])


def test_underivable_reducer_runs_the_reduce_flow_under_auto():
    """``v[0] + v[1]`` is neither a monoid nor an idiom: under ``auto`` the
    port, like the reference, plans the reduce flow and runs the user's
    reduce over the windows."""
    def treduce(k, v, c):
        return v[0] + v[1]

    def jreduce(k, v, c):
        return v[0] + v[1]

    tapp = T.make_app(lambda item, emit: emit(item % 8, item.float()),
                      treduce, key_space=8,
                      value_spec=TC.ValueSpec((), torch.float32),
                      emit_capacity=1, max_values_per_key=4, pad_value=0.5)
    japp = J.make_app(lambda item, emit: emit(item % 8,
                                              item.astype(jnp.float32)),
                      jreduce, key_space=8,
                      value_aval=jax.ShapeDtypeStruct((), jnp.float32),
                      emit_capacity=1, max_values_per_key=4, pad_value=0.5)
    items = np.array([3, 11, 4, 19, 7, 8, 0, 27, 35], np.int32)
    mr = T.MapReduce(tapp, device="cpu")
    jmr = J.MapReduce(japp, cache=False)
    assert mr.plan.flow == jmr.plan.flow == "reduce"
    assert mr.plan.reason.startswith("not combinable")
    assert mr.plan.spec is None and not mr.plan.optimized
    assert "flow: reduce (not combinable" in mr.explain()
    res, jres = mr.run(items), jmr.run(items)
    np.testing.assert_array_equal(res.counts.numpy(), np.asarray(jres.counts))
    np.testing.assert_array_equal(res.values.numpy(), np.asarray(jres.values))
    assert res.to_dict()[3] == 3.0 + 11.0  # first two values of key 3


def test_user_max_over_signed_zeros_agrees_up_to_the_sign_of_zero():
    """ROADMAP C.15: the reduce flow runs the user's own torch reduce, and
    ``torch.amax``/``amin`` keep whichever zero they meet first where
    ``jnp.max``/``jnp.min`` prefer +0/-0.  The port does not rewrite user
    code, so over windows of ±0 (the zero padding included) the two agree
    up to the sign of zero, and bit for bit everywhere else."""
    pts = np.random.default_rng(6).standard_normal((40, 3)).astype(
        np.float32)
    pts.reshape(-1)[::4] = -0.0
    pts.reshape(-1)[1::5] = 0.0
    items = ((np.arange(40) % 7).astype(np.int32), pts)
    app = tapps.BoundingBox()
    app.max_values_per_key = 8  # short keys see the +0 padding
    red = T.MapReduce(app, flow="reduce", device="cpu").run(items)
    japp = JBoundingBox()
    japp.max_values_per_key = 8
    jred = J.MapReduce(japp, flow="reduce", cache=False).run(items)
    got, want = red.values.numpy(), np.asarray(jred.values)
    np.testing.assert_array_equal(got, want)  # == treats -0 and +0 alike
    nonzero = want != 0
    np.testing.assert_array_equal(got[nonzero].view(np.uint32),
                                  want[nonzero].view(np.uint32))

"""NaN payloads under max and min: the port's plain versions against the
JAX package, bit for bit (CPU).

A NaN keeps its sign and payload through a max or min fold.  Between two
NaNs the JAX package keeps the one an index-order fold of ``jnp.maximum``
/ ``jnp.minimum`` keeps (``repro_torch.numerics`` states the rule); its
Pallas kernels (interpret mode), its ``.at[]`` scatters and ``jnp.max``
all agree on it.  Each case runs one function of the JAX package and its
counterpart in the port on the same numpy inputs, with non-canonical NaNs:
one per key, two per key of the same sign and of both signs, and NaNs in
the carried table.  The CUDA kernels are held against the same plain
versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import combiner as jcomb  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import numerics  # noqa: E402
from repro_torch.core import combiner as tcomb  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

K, D = 6, 2
#: non-canonical NaNs: two positive, two negative payloads
NANS = np.array([0x7FC00123, 0x7FC00789, 0xFFC00456, 0xFFC00ABC],
                np.uint32).view(np.float32)
P1, P2, N1, N2 = NANS

#: per case, (key, row of the pair among the key's pairs, NaN) planted in
#: column 0, and (key, NaN) planted in the carried table's column 0
CASES = {
    "one_per_key": ([(0, 0, P1), (1, 1, N1), (2, 2, P2), (3, 0, N2)], []),
    "two_same_sign": ([(0, 0, P1), (0, 2, P2), (1, 1, N1), (1, 2, N2),
                       (2, 0, P2), (2, 1, P1)], []),
    "two_both_signs": ([(0, 0, P1), (0, 1, N1), (1, 0, N2), (1, 2, P2),
                        (2, 1, P1), (2, 2, N2), (2, 3, P2)], []),
    "in_acc": ([(0, 0, P1), (1, 1, N1), (2, 0, P2), (2, 2, N2)],
               [(0, P2), (1, N2), (2, N1), (3, P1), (4, N1)]),
}
FUNCTIONS = ("chunk_monoid_fold", "combine_scatter", "segment_reduce",
             "combiner_scatter", "combiner_dense", "combiner_op")


def _case(name, seed=0):
    """keys [N] (4 pairs a key, shuffled, with out-of-range keys mixed in),
    values [N, D] and acc [K, D] with the case's NaNs planted."""
    rng = np.random.default_rng(seed)
    keys = np.repeat(np.arange(K, dtype=np.int32), 4)
    keys = np.concatenate([keys, np.array([K, -1, K + 2], np.int32)])
    keys = keys[rng.permutation(keys.size)]
    vals = rng.standard_normal((keys.size, D)).astype(np.float32)
    acc = rng.standard_normal((K, D)).astype(np.float32)
    pairs, in_acc = CASES[name]
    for key, nth, nan in pairs:
        vals[np.flatnonzero(keys == key)[nth], 0] = nan
    for key, nan in in_acc:
        acc[key, 0] = nan
    return keys, vals, acc


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


def _jax_and_port(fn, op, keys, vals, acc):
    t = [torch.from_numpy(a) for a in (keys, vals, acc)]
    if fn == "chunk_monoid_fold":
        return (jops.chunk_monoid_fold(keys, vals, acc, op, tile_n=8),
                ops.chunk_monoid_fold(*t, op))
    if fn == "combine_scatter":
        return (jops.combine_scatter(keys, vals, K, op, tile_n=8),
                ops.combine_scatter(t[0], t[1], K, op))
    if fn == "segment_reduce":  # a key-sorted stream, stable (pairs of a
        # key keep their order), with the sentinel K and no negative key
        order = np.argsort(keys, kind="stable")
        order = order[keys[order] >= 0]
        sk, sv = keys[order], vals[order]
        return (jops.segment_reduce(sk, sv, K, op, tile_n=8),
                ops.segment_reduce(torch.from_numpy(sk),
                                   torch.from_numpy(sv), K, op, tile_n=8))
    jm, tm = (jcomb.MAX, tcomb.MAX) if op == "max" else (jcomb.MIN,
                                                         tcomb.MIN)
    if fn == "combiner_scatter":
        return (getattr(jnp.asarray(acc).at[keys], op)(vals, mode="drop"),
                tm.scatter(t[2], t[0], t[1]))
    if fn == "combiner_dense":  # the identity-masked [N, K, D] expansion
        ident = np.float32(-np.inf if op == "max" else np.inf)
        hit = keys[:, None] == np.arange(K)[None, :]
        masked = np.where(hit[:, :, None], vals[:, None, :], ident)
        return (jm.dense_reduce(jnp.asarray(masked), axis=0),
                tm.dense_reduce(torch.from_numpy(masked), 0))
    # combiner_op: the pairwise op over every row pair of acc and values
    a = np.repeat(acc, 4, axis=0)
    b = vals[:a.shape[0]]
    return (jm.op(jnp.asarray(a), jnp.asarray(b)),
            tm.op(torch.from_numpy(a), torch.from_numpy(b)))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fn", FUNCTIONS)
@pytest.mark.parametrize("op", ["max", "min"])
def test_nan_payloads_match_jax_bit_for_bit(op, fn, case):
    keys, vals, acc = _case(case)
    want, got = _jax_and_port(fn, op, keys, vals, acc)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("op", ["max", "min"])
def test_the_pairwise_rule_on_two_nans_matches_jax(op):
    """Every ordered pair of the four payloads, and each against a
    number: the port's maximum/minimum select JAX's operand."""
    a, b = np.meshgrid(np.append(NANS, 1.5), np.append(NANS, 1.5))
    a, b = a.ravel(), b.ravel()
    jf, tf = ((jnp.maximum, numerics.maximum) if op == "max"
              else (jnp.minimum, numerics.minimum))
    np.testing.assert_array_equal(
        _bits(tf(torch.from_numpy(a), torch.from_numpy(b)).numpy()),
        _bits(jf(a, b)))


@pytest.mark.parametrize("op", ["max", "min"])
def test_reductions_over_several_axes_keep_the_fold_order(op):
    """``amax``/``amin`` over a tuple of axes fold them in row-major
    order, as ``jnp.max``/``jnp.min`` do."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 4, 5)).astype(np.float32)
    flat = x.reshape(-1)
    flat[rng.choice(flat.size, 12, replace=False)] = np.resize(NANS, 12)
    jf, tf = ((jnp.max, numerics.amax) if op == "max"
              else (jnp.min, numerics.amin))
    for axes in ((0, 2), (1, 2), (0, 1, 2), 1):
        np.testing.assert_array_equal(
            _bits(tf(torch.from_numpy(x), axes).numpy()),
            _bits(jf(x, axis=axes)))

"""The port's fold kernels, through their plain PyTorch versions (CPU).

``repro_torch.kernels.ops.onehot_fold`` / ``chunk_monoid_fold`` on CPU
tensors take the plain version of each kernel; these tests hold it against
the Pallas kernels of ``repro`` (interpret mode) and against
``repro.kernels.ref``.  Max/min must agree bit for bit, NaN and signed
zeros included; sums within rtol=atol=1e-5 (another summation order).  The
CUDA kernels themselves are held against the same plain versions on the
card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import numerics  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SUM_TOL = dict(rtol=1e-5, atol=1e-5)


def _pairs(seed, n, d, k, *, specials=False):
    """keys in [0, K) plus sentinel (K) and out-of-range (> K, < 0) keys."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, k, size=n).astype(np.int32)
    bad = rng.random(n) < 0.2
    keys[bad] = rng.choice(np.array([k, k + 1, k + 7, -1], np.int32),
                           size=int(bad.sum()))
    vals = rng.standard_normal((n, d)).astype(np.float32)
    acc = rng.standard_normal((k, d)).astype(np.float32)
    if specials:
        flat = vals.reshape(-1)
        pick = rng.random(flat.size)
        flat[pick < 0.15] = 0.0
        flat[(pick >= 0.15) & (pick < 0.3)] = -0.0
        flat[(pick >= 0.3) & (pick < 0.33)] = np.nan
        fa = acc.reshape(-1)
        pa = rng.random(fa.size)
        fa[pa < 0.3] = -0.0
        fa[(pa >= 0.3) & (pa < 0.6)] = 0.0
        fa[(pa >= 0.6) & (pa < 0.65)] = np.nan
    return keys, vals, acc


def _t(*arrays):
    return tuple(torch.from_numpy(a.copy()) for a in arrays)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


# (n, d, k, block_k): block_k unset, smaller than K and not dividing K,
# N not a multiple of any tile
SHAPES = [(1, 1, 1, None), (37, 3, 10, None), (300, 4, 100, 32),
          (513, 5, 70, 24), (1000, 2, 33, 7), (257, 9, 129, 128)]


@pytest.mark.parametrize("n,d,k,block_k", SHAPES)
def test_onehot_fold_plain_matches_pallas_and_ref(n, d, k, block_k):
    keys, vals, acc = _pairs(n + k, n, d, k)
    got = ops.onehot_fold(*_t(keys, vals, acc), block_k=block_k).numpy()
    jkeys = np.where((keys < 0) | (keys > k), k, keys)  # Emitter's sentinel
    pallas = np.asarray(jops.onehot_fold(jkeys, vals, acc, block_k=block_k,
                                         interpret=True))
    oracle = np.asarray(jref.onehot_fold(jkeys, vals, acc, block_k=block_k))
    np.testing.assert_allclose(got, pallas, **SUM_TOL)
    np.testing.assert_allclose(got, oracle, **SUM_TOL)


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("n,d,k,block_k", SHAPES)
def test_chunk_monoid_fold_plain_matches_pallas_and_ref(op, n, d, k, block_k):
    keys, vals, acc = _pairs(3 * n + k, n, d, k, specials=op != "add")
    got = ops.chunk_monoid_fold(*_t(keys, vals, acc), op,
                                block_k=block_k).numpy()
    jkeys = np.where((keys < 0) | (keys > k), k, keys)
    pallas = np.asarray(jops.chunk_monoid_fold(jkeys, vals, acc, op,
                                               block_k=block_k,
                                               interpret=True))
    oracle = np.asarray(jref.chunk_monoid_fold(jkeys, vals, acc, op,
                                               block_k=block_k))
    if op == "add":
        np.testing.assert_allclose(got, pallas, **SUM_TOL)
        np.testing.assert_allclose(got, oracle, **SUM_TOL)
    else:  # bitwise, NaN and signed zeros included
        np.testing.assert_array_equal(_bits(got), _bits(pallas))
        np.testing.assert_array_equal(_bits(got), _bits(oracle))


def test_absent_keys_pass_through_bitwise():
    """Rows of keys absent from the chunk keep acc's bits under max/min."""
    k, d = 16, 3
    acc = np.full((k, d), -0.0, np.float32)
    acc[3] = np.nan
    acc[5] = 0.0
    keys = np.array([1, 1, 7, k], np.int32)
    vals = np.ones((4, d), np.float32)
    for op in ("max", "min"):
        got = ops.chunk_monoid_fold(*_t(keys, vals, acc), op).numpy()
        absent = np.setdiff1d(np.arange(k), [1, 7])
        np.testing.assert_array_equal(_bits(got[absent]), _bits(acc[absent]))


@pytest.mark.parametrize("a,b", [(-0.0, 0.0), (0.0, -0.0), (np.nan, 1.0),
                                 (1.0, np.nan), (-0.0, -0.0), (2.0, -3.0)])
def test_signed_zero_and_nan_rule_matches_jax_both_orders(a, b):
    ta = torch.tensor([a], dtype=torch.float32)
    tb = torch.tensor([b], dtype=torch.float32)
    np.testing.assert_array_equal(
        _bits(numerics.maximum(ta, tb).numpy()),
        _bits(jnp.maximum(jnp.float32(a), jnp.float32(b))))
    np.testing.assert_array_equal(
        _bits(numerics.minimum(ta, tb).numpy()),
        _bits(jnp.minimum(jnp.float32(a), jnp.float32(b))))
    pair = np.array([a, b], np.float32)
    np.testing.assert_array_equal(
        _bits(numerics.amax(torch.from_numpy(pair), 0).numpy()),
        _bits(jnp.max(pair)))
    np.testing.assert_array_equal(
        _bits(numerics.amin(torch.from_numpy(pair), 0).numpy()),
        _bits(jnp.min(pair)))


def test_one_key_of_zeros_in_both_orders_is_bitwise():
    """One key receiving -0 then +0 (and +0 then -0): max is +0, min -0."""
    for order in ([-0.0, 0.0], [0.0, -0.0]):
        keys = np.zeros(2, np.int32)
        vals = np.array(order, np.float32)[:, None]
        acc = np.full((1, 1), np.inf, np.float32)
        for op, want in (("max", 0.0), ("min", -0.0)):
            start = -acc if op == "max" else acc
            got = ops.chunk_monoid_fold(*_t(keys, vals, start), op).numpy()
            assert _bits(got)[0, 0] == _bits(np.float32(want))


def test_empty_chunk_returns_acc():
    acc = torch.randn(5, 2)
    keys = torch.zeros(0, dtype=torch.int32)
    vals = torch.zeros(0, 2)
    assert torch.equal(ops.onehot_fold(keys, vals, acc), acc)
    assert torch.equal(ops.chunk_monoid_fold(keys, vals, acc, "max"), acc)


def test_shape_and_op_checks():
    keys = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.onehot_fold(keys, torch.zeros(4), torch.zeros(3, 1))
    with pytest.raises(ValueError):
        ops.onehot_fold(keys, torch.zeros(4, 2), torch.zeros(3, 1))
    with pytest.raises(ValueError):
        ops.chunk_monoid_fold(keys, torch.zeros(4, 1), torch.zeros(3, 1),
                              "mul")
    with pytest.raises(ValueError):
        ops.onehot_fold(keys, torch.zeros(4, 1), torch.zeros(3, 1),
                        block_k=0)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launch_counts()
    keys, vals, acc = _t(*_pairs(0, 64, 2, 8))
    ops.onehot_fold(keys, vals, acc)
    ops.chunk_monoid_fold(keys, vals, acc, "max")
    assert ops.launch_counts() == {"onehot_fold": 0, "chunk_monoid_fold": 0}


@pytest.mark.parametrize("n,k,d", [(1, 1, 1), (100, 100, 4), (1 << 22, 100, 4),
                                   (1 << 20, 5000, 97), (3000, 300, 3)])
def test_launch_plan_fits_the_card(n, k, d):
    """Segments cover the pairs, tiles fit the shared-memory slice, and a
    block is a whole number of warps of at most FOLD_MAX_BLOCK_KEYS keys."""
    blk = ops.auto_key_block(k)
    assert blk % 32 == 0 and blk <= ops.FOLD_MAX_BLOCK_KEYS
    seg_len, n_seg = ops.fold_segments(n, k, d, blk)
    assert seg_len * n_seg >= n > seg_len * (n_seg - 1)
    assert n_seg * k * d <= max(ops.FOLD_PARTIAL_ELEMS, k * d)
    tile = ops.fold_tile_n(d)
    staged = tile * (4 + 4 * min(d, ops.FOLD_MAX_COLS))
    assert staged * ops.FOLD_BLOCKS_PER_SM <= ops.SMEM_PER_BLOCK

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
    counts = ops.launch_counts()
    assert {"onehot_fold", "chunk_monoid_fold"} <= set(counts)
    assert set(counts.values()) == {0}, counts


def _check_fold_plan(plan, n, k, d):
    """A plan the kernels can launch: its tables fit the shared memory and
    cover K x D, its segments cover the pairs, its partials fit."""
    assert plan.warps in (1, ops.FOLD_BUCKET_WARPS)
    assert plan.stage % 32 == 0 and 32 <= plan.stage <= (
        ops.FOLD_BALLOT_STAGE if plan.warps == 1 else ops.FOLD_MAX_STAGE)
    assert plan.smem == ops.fold_smem_bytes(plan.block_k, plan.cols,
                                            plan.stage, plan.warps)
    assert plan.smem <= ops.FOLD_SMEM < ops.SMEM_PER_BLOCK
    assert 1 <= plan.block_k <= k and 1 <= plan.cols <= min(
        d, ops.FOLD_MAX_COLS)
    assert plan.block_k * plan.cols <= ops.FOLD_TABLE_FLOATS
    assert plan.key_tiles * plan.block_k >= k > (plan.key_tiles - 1) * \
        plan.block_k
    assert plan.col_tiles * plan.cols >= d > (plan.col_tiles - 1) * plan.cols
    assert plan.seg_len * plan.n_seg >= n > plan.seg_len * (plan.n_seg - 1)
    assert plan.n_seg == 1 or plan.n_seg * k * d <= ops.FOLD_PARTIAL_ELEMS


@pytest.mark.parametrize("n,k,d", [(1, 1, 1), (100, 100, 4), (1 << 22, 100, 4),
                                   (1 << 20, 5000, 97), (3000, 300, 3)])
def test_launch_plan_fits_the_card(n, k, d):
    """The fold kernels' plan at the stream flow's shapes: it fits, covers
    the table and the pairs, and a table of all K x D reads the pairs once
    with enough segments to fill the card."""
    plan = ops.fold_plan(n, k, d)
    _check_fold_plan(plan, n, k, d)
    if k * d <= ops.FOLD_TABLE_FLOATS:
        assert (plan.key_tiles, plan.col_tiles) == (1, 1)
    if n >= 1 << 22:
        assert plan.n_seg >= ops.SM_COUNT


@pytest.mark.parametrize("d", [1, 3, 4, 128])
@pytest.mark.parametrize("k", [1, 100, 2048, 2049, 1 << 16])
@pytest.mark.parametrize("n", [1, 5_001, 1 << 22, 1 << 24])
def test_fold_plan_covers_the_table_and_fits(n, k, d):
    """The plan over (n, K, D): shared memory within a block's share,
    key tiles x column tiles covering K x D, segments covering N, partials
    within FOLD_PARTIAL_ELEMS; a cap on the key tile is kept."""
    plan = ops.fold_plan(n, k, d)
    _check_fold_plan(plan, n, k, d)
    # the fewest tiles: a key tile takes every key its table holds
    assert plan.block_k == min(k, ops.FOLD_TABLE_FLOATS // plan.cols)
    capped = ops.fold_plan(n, k, d, block_k=7)
    _check_fold_plan(capped, n, k, d)
    assert capped.block_k == min(7, k)

"""The sort flow's radix partitions, through their plain versions (CPU).

``repro_torch.kernels.ops.radix_partition`` on CPU tensors takes the plain
version of ``radix_partition`` (one level) or ``radix_partition_multi``
(``fanouts`` of two or more levels).  These tests hold both against the
Pallas kernels of ``repro`` (interpret mode) and ``repro.kernels.ref``:
``pkeys`` and ``starts`` bit for bit, values bit for bit at the slots that
hold real pairs (pad and trash slots are sentinel-keyed in both).  The
hierarchy's leaf layout must equal the one-level layout, the radix plans
must equal the reference's at the sort flow's main-path key spaces, and the
reference's C.1 case (a hierarchy at pad_align 8) must fold.  The CUDA
kernels are held against the same plain versions on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import radix_partition as rp  # noqa: E402


def _pairs(seed, n, k, d, extra=3):
    """Keys in [0, K] (the sentinel K included) and a few past it."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, k + 1 + extra, size=n).astype(np.int32)
    vals = rng.standard_normal((n, d)).astype(np.float32)
    return keys, vals


def _same_layout(got, want, k):
    gk, gv, gs = (np.asarray(x) for x in got)
    wk, wv, ws = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gk, wk)
    real = wk < k
    np.testing.assert_array_equal(gv[real].view(np.uint32),
                                  wv[real].astype(np.float32).view(np.uint32))


def _port(keys, vals, k, **kw):
    return tuple(t.numpy() for t in ops.radix_partition(
        torch.from_numpy(keys), torch.from_numpy(vals), k, **kw))


ONE_LEVEL = [(64, 64, 16, 8), (200, 128, 32, 16), (300, 100, 32, 16),
             (50, 256, 256, 16), (512, 1000, 64, 16), (7, 40, 8, 256)]


@pytest.mark.parametrize("n,k,bs,pa", ONE_LEVEL)
def test_radix_partition_plain_matches_pallas_and_ref(n, k, bs, pa):
    keys, vals = _pairs(n + k, n, k, 4)
    got = _port(keys, vals, k, bucket_size=bs, pad_align=pa)
    pallas = jops.radix_partition(jnp.asarray(keys), jnp.asarray(vals), k,
                                  bucket_size=bs, pad_align=pa, tile_n=pa,
                                  interpret=True)
    _same_layout(got, pallas, k)
    jkeys = np.minimum(keys, k)  # the oracle takes keys in [0, K]
    _same_layout(got, jref.radix_partition(jnp.asarray(jkeys),
                                           jnp.asarray(vals), k,
                                           bucket_size=bs, pad_align=pa), k)


MULTI = [(200, 256, 16, (4, 4), 16), (300, 100, 8, (4, 4), 16),
         (500, 1000, 16, (4, 4, 4), 32), (64, 64, 4, (4, 4), 8),
         (333, 2000, 64, (8, 4), 16)]


@pytest.mark.parametrize("n,k,bs,fanouts,pa", MULTI)
def test_radix_partition_multi_plain_matches_pallas_and_one_level(
        n, k, bs, fanouts, pa):
    keys, vals = _pairs(3 * n + k, n, k, 3)
    got = _port(keys, vals, k, bucket_size=bs, fanouts=fanouts, pad_align=pa)
    pallas = jops.radix_partition(jnp.asarray(keys), jnp.asarray(vals), k,
                                  bucket_size=bs, fanouts=fanouts,
                                  pad_align=pa, tile_n=pa, interpret=True)
    _same_layout(got, pallas, k)
    # the hierarchy's leaf layout is the one-level layout at bucket_size
    _same_layout(got, _port(keys, vals, k, bucket_size=bs, pad_align=pa), k)
    assert got[2].shape == (-(-k // bs),)


def test_layout_invariants():
    """Every real key lies in its bucket's range, regions start at
    multiples of pad_align, nothing is lost, dropped slots read K with zero
    values, and negative keys are dropped."""
    n, k, bs, pa = 400, 512, 16, 16
    keys, vals = _pairs(5, n, k, 2)
    keys[::17] = -3
    for fanouts in (None, (8, 4)):
        pk, pv, starts = _port(keys, vals, k, bucket_size=bs,
                               fanouts=fanouts, pad_align=pa)
        assert (starts % pa == 0).all() and (pk <= k).all()
        assert pk.shape[0] % pa == 0
        for b in range(k // bs):
            hi = starts[b + 1] if b + 1 < len(starts) else len(pk)
            seg = pk[starts[b]:hi]
            real = seg[seg < k]
            assert ((real >= b * bs) & (real < (b + 1) * bs)).all()
        valid = (keys >= 0) & (keys < k)
        np.testing.assert_array_equal(np.sort(pk[pk < k]),
                                      np.sort(keys[valid]))
        assert not pv[pk == k].any()


@pytest.mark.parametrize("k,d", [(1 << 18, 2), (1 << 20, 2), (1 << 20, 1),
                                 (4096, 2), (32768, 2), (1 << 17, 1),
                                 (512, 2), (100, 4), (3 << 20, 2)])
def test_plan_matches_reference(k, d):
    """The leaf and the level fan-outs equal the reference's wherever the
    [leaf, D] table fits both budgets: one level of 32 leaves of 8192 keys
    at K = 2^18, fan-outs (8, 8) of 16384-key leaves at K = 2^20."""
    want = jops.plan_radix_levels(k, d=d)
    got = ops.plan_radix_levels(k, d=d)
    assert (got.bucket_size, got.fanouts, got.feasible) == (
        want.bucket_size, want.fanouts, want.feasible)
    assert got.describe() == want.describe()
    want_blk = jops.auto_bucket_size(k, d=d)
    got_blk = ops.auto_bucket_size(k, d=d)
    if want_blk * d * 4 <= ops.SEGMENT_TABLE_BYTES or want_blk == k:
        assert got_blk == want_blk
    else:  # the reference's bucket outgrows the kernel's table: halved
        assert got_blk * d * 4 <= ops.SEGMENT_TABLE_BYTES < 2 * got_blk * d * 4
    if k == 1 << 18 and d == 2:
        assert (got.bucket_size, got.fanouts) == (8192, (32,))
    if k == 1 << 20 and d == 2:
        assert (got.bucket_size, got.fanouts) == (16384, (8, 8))


@pytest.mark.parametrize("k", [4096, 1 << 16])
def test_plan_under_shrunk_budgets_matches_reference(monkeypatch, k):
    """The reference's hierarchy test shrinks the leaf cap and fan-out so
    that several levels engage at small K; so does the level budget."""
    for mod in (ops, jops):
        monkeypatch.setattr(mod, "LEAF_BUCKET_CAP", 256)
        monkeypatch.setattr(mod, "MAX_RADIX_FANOUT", 4)
    for levels in (1, 3):
        for mod in (ops, jops):
            monkeypatch.setattr(mod, "MAX_RADIX_LEVELS", levels)
        got = ops.plan_radix_levels(k, d=2)
        want = jops.plan_radix_levels(k, d=2)
        assert (got.bucket_size, got.fanouts, got.feasible, got.reason) == (
            want.bucket_size, want.fanouts, want.feasible, want.reason)


def test_wide_tables_shrink_the_leaf_to_the_card_budget():
    """The leaf's [leaf, D] f32 table must fit the segment_reduce kernel's
    shared memory; the reference sized it for VMEM instead."""
    plan = ops.plan_radix_levels(1 << 20, d=8)
    assert plan.bucket_size * 8 * 4 <= ops.SEGMENT_TABLE_BYTES
    assert plan.feasible and plan.num_leaves * plan.bucket_size >= 1 << 20


@pytest.mark.parametrize("k_off", [0, 1, 2, 3])
def test_c1_hierarchy_at_pad_align_8_folds(k_off):
    """The reference's sort_segment_fold cannot run a hierarchy at any
    pad_align but 256 (its fault C.1: the partition's tile_n is not
    passed); the port's runs at the case the reference's property test
    falls on (bucket_pow=2, fan_pows=[1, 1], n=1, seed=0)."""
    bs, fanouts, pa, n = 4, (2, 2), 8, 1
    k = max(bs * 4 - k_off, bs + 1)
    rng = np.random.default_rng(0)
    keys = rng.integers(0, k + 1, size=n).astype(np.int32)
    vals = rng.standard_normal((n, 1)).astype(np.float32)
    acc = np.zeros((k, 1), np.float32)
    got = ops.sort_segment_fold(torch.from_numpy(keys),
                                torch.from_numpy(vals), torch.from_numpy(acc),
                                "add", bucket_size=bs, fanouts=fanouts,
                                pad_align=pa).numpy()
    want = np.asarray(jref.sort_segment_fold(jnp.asarray(keys),
                                             jnp.asarray(vals),
                                             jnp.asarray(acc), "add"))
    np.testing.assert_array_equal(got, want)
    multi = _port(keys, vals, k, bucket_size=bs, fanouts=fanouts, pad_align=pa)
    _same_layout(multi, _port(keys, vals, k, bucket_size=bs, pad_align=pa), k)


@pytest.mark.parametrize("seed", range(6))
def test_random_hierarchies_equal_one_level_and_fold_like_the_oracle(seed):
    """Random level splits, K not a multiple of bucket·ΠB, pad_align 8: the
    hierarchical layout equals the one-level layout and the fold equals
    the argsort oracle (the reference's property test, on the port)."""
    rng = np.random.default_rng(100 + seed)
    bs = 1 << int(rng.integers(2, 5))
    fanouts = tuple(1 << int(p) for p in rng.integers(1, 3, size=int(
        rng.integers(2, 4))))
    cover = bs * int(np.prod(fanouts))
    k = max(cover - int(rng.integers(0, 4)), bs + 1)
    n = int(rng.integers(1, 121))
    keys = rng.integers(0, k + 1, size=n).astype(np.int32)
    vals = rng.standard_normal((n, 1)).astype(np.float32)
    multi = _port(keys, vals, k, bucket_size=bs, fanouts=fanouts, pad_align=8)
    _same_layout(multi, _port(keys, vals, k, bucket_size=bs, pad_align=8), k)
    acc = np.zeros((k, 1), np.float32)
    got = ops.sort_segment_fold(torch.from_numpy(keys),
                                torch.from_numpy(vals), torch.from_numpy(acc),
                                "add", bucket_size=bs, fanouts=fanouts,
                                pad_align=8).numpy()
    want = np.zeros((k, 1), np.float64)
    np.add.at(want, keys[keys < k], vals[keys < k].astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_empty_chunk_and_checks():
    keys = torch.zeros(0, dtype=torch.int32)
    pk, pv, starts = ops.radix_partition(keys, torch.zeros(0, 2), 100,
                                         bucket_size=16, pad_align=8)
    assert pk.shape == (rp.partition_slots(0, 7, 8),) and (pk == 100).all()
    assert pv.shape == (pk.shape[0], 2) and not pv.any()
    assert starts.tolist() == [0] * 7
    with pytest.raises(ValueError, match="cover"):
        ops.radix_partition(torch.zeros(4, dtype=torch.int32),
                            torch.zeros(4, 1), 1000, bucket_size=4,
                            fanouts=(2, 2))
    with pytest.raises(ValueError):
        ops.radix_partition(torch.zeros(4, dtype=torch.int32),
                            torch.zeros(4), 10, bucket_size=4)

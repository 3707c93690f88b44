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


# -- the kernels' pass plan and tile plan ------------------------------------


@pytest.mark.parametrize("seed", range(16))
def test_partition_passes_group_random_hierarchies(seed):
    """Over random hierarchies: each pass's fan-out and the first pass's
    bucket count stay within max_buckets, the passes' ranges nest down to
    bucket_size, the passes cover the hierarchy's leaves, and no plan within
    max_buckets has fewer passes."""
    rng = np.random.default_rng(200 + seed)
    fanouts = tuple(int(f) for f in rng.integers(
        2, 40, size=int(rng.integers(2, 5))))
    max_buckets = 1 << int(rng.integers(1, 10))
    bs = int(rng.integers(1, 40))
    k = bs * int(np.prod(fanouts)) - int(rng.integers(0, bs))
    nb = -(-k // bs)
    passes = rp.partition_passes(k, bs, max_buckets)
    assert all(p.fanout <= max_buckets for p in passes)
    assert -(-k // passes[0].range_) <= max_buckets
    assert passes[-1].range_ == bs
    for outer, inner in zip(passes, passes[1:]):
        assert outer.range_ == inner.range_ * inner.fanout
    assert passes[0].range_ * -(-k // passes[0].range_) >= nb * bs
    fewest = next(p for p in range(1, 64) if max_buckets ** p >= nb)
    assert len(passes) == fewest


@pytest.mark.parametrize("max_buckets,want", [
    (64, ((16384, 64),)), (1024, ((16384, 64),)),
    (63, ((131072, 8), (16384, 8))), (8, ((131072, 8), (16384, 8)))])
def test_partition_passes_main_path(max_buckets, want):
    """The sort flow's K = 2^20 plan (8, 8) is one pass of 64 buckets
    wherever the limit allows it, and two of 8 below."""
    plan = ops.plan_radix_levels(1 << 20, d=2)
    assert plan.fanouts == (8, 8)
    got = rp.partition_passes(1 << 20, plan.bucket_size, max_buckets)
    assert tuple((p.range_, p.fanout) for p in got) == want


def test_partition_passes_past_the_limit():
    """More leaves than the limit run in passes of power-of-two fan-outs
    that split the leaf count's bits evenly: 2048 leaves (K = 2^25, plan
    (16, 16, 8)), a one-level partition, and hierarchies with a level wider
    than the limit (fan-outs (2, 512) and (4, 2048, 8))."""
    lim = ops.KERNEL_MAX_LEVEL_BUCKETS
    assert ops.plan_radix_levels(1 << 25, d=2).fanouts == (16, 16, 8)

    def ranges(k, bs, cap=lim):
        return [(p.range_, p.fanout)
                for p in rp.partition_passes(k, bs, cap)]

    assert ranges(1 << 25, 16384) == [(1 << 19, 64), (16384, 32)]
    assert ranges(1 << 18, 8192) == [(8192, 32)]
    assert ranges(2049 * 16, 16, 2048) == [(16 * 64, 64), (16, 64)]
    assert ranges(1000 * 4, 4, 256) == [(4 * 32, 32), (4, 32)]
    assert ranges(1024 * 16, 16) == [(16 * 32, 32), (16, 32)]
    assert ranges(1 << 20, 16, 1024) == [(16 * 256, 256), (16, 256)]


PASSES = [  # (n, k, bs, fanouts, pa, max_buckets)
    (400, 1000, 4, (), 16, 16),  # one level of 250 buckets in two passes
    (200, 256, 16, (4, 4), 16, 4),  # two passes
    (300, 100, 8, (4, 4), 16, 4),  # cover > K, two passes
    (500, 1000, 16, (4, 4, 4), 32, 16),  # two passes of 8
    (500, 1000, 16, (4, 4, 4), 32, 4),  # three passes
    (64, 64, 4, (4, 4), 8, 16),  # one pass
    (333, 2000, 64, (8, 4), 16, 8),  # two passes
    (1, 13, 4, (2, 2), 8, 2),  # the reference's C.1 case, two passes
    (1, 13, 4, (2, 2), 8, 4),  # C.1, one pass
    (300, 1024, 1, (2, 512), 8, 256),  # a level past the limit: 32, 32
    (257, 3000, 4, (3, 250), 16, 16),  # uneven fan-outs, 750 leaves: 3 passes
    (600, 4096, 2, (16, 128), 16, 64),  # 2048 leaves: 64 and 32
]


@pytest.mark.parametrize("n,k,bs,fanouts,pa,max_buckets", PASSES)
def test_passes_plain_matches_pallas_multi_and_one_level(
        n, k, bs, fanouts, pa, max_buckets):
    """The partition pass by pass, as the kernel plans it, gives the Pallas
    hierarchy's layout (interpret mode), the level-by-level plain version's
    and the one-level partition's."""
    keys, vals = _pairs(7 * n + k, n, k, 3)
    passes = rp.partition_passes(k, bs, max_buckets)
    got = tuple(t.numpy() for t in rp.radix_partition_passes_plain(
        torch.from_numpy(keys), torch.from_numpy(vals), k, passes=passes,
        pad_align=pa))
    if fanouts:
        pallas = jops.radix_partition(jnp.asarray(keys), jnp.asarray(vals), k,
                                      bucket_size=bs, fanouts=fanouts,
                                      pad_align=pa, tile_n=pa, interpret=True)
        _same_layout(got, pallas, k)
    _same_layout(got, _port(keys, vals, k, bucket_size=bs, fanouts=fanouts,
                            pad_align=pa), k)
    _same_layout(got, _port(keys, vals, k, bucket_size=bs, pad_align=pa), k)


@pytest.mark.parametrize("n,k,bs,max_buckets,tile", [
    (5000, 1000, 16, 4, 256), (3000, 1 << 12, 16, 16, 512),
    (1, 13, 4, 2, 256), (4096, 256, 4, 8, 256)])
def test_tile_plan_of_an_inner_pass(n, k, bs, max_buckets, tile):
    """An inner pass's tiles lie inside one parent region each, cover every
    slot of the previous pass's compact layout once, and number at most the
    grid the plan launches (ceil(n / tile) + parents)."""
    keys, vals = _pairs(n + k, n, k, 1)
    passes = rp.partition_passes(k, bs, max_buckets)
    assert len(passes) >= 2
    top = passes[0].range_
    nb = -(-k // top)
    pk, _, starts = rp._partition_level(  # the first pass's compact layout
        torch.from_numpy(keys), torch.from_numpy(vals), range_=top,
        num_buckets=nb, pad_align=1, n_slots=n, fill_key=-1,
        clamp_key=2**31 - 1)
    pk, starts = pk.numpy(), starts.numpy().astype(np.int64)
    totals = np.diff(np.append(starts, (pk >= 0).sum()))
    assert (np.concatenate([np.full(c, p) for p, c in enumerate(totals)])
            == pk[:totals.sum()] // top).all()
    tiles = rp.pass_tiles(starts, totals, tile)
    assert len(tiles) <= -(-n // tile) + nb
    seen = np.zeros(n, np.int64)
    for p, lo, hi in tiles:
        assert starts[p] <= lo < hi <= starts[p] + totals[p]
        assert hi - lo <= tile
        seen[lo:hi] += 1
    assert (seen[:totals.sum()] == 1).all() and not seen[totals.sum():].any()


@pytest.mark.parametrize("d", [0, 1, 2, 3, 8, 64, 300, 4096])
@pytest.mark.parametrize("digits", [1, 32, 64, 256])
def test_tile_shared_memory_fits_a_block(d, digits):
    """A scatter block's shared memory fits the 227 KB a block may use at
    every D, and four blocks share an SM; tiles are whole blocks of
    threads; the values are staged at the sort flow's narrow D and stay in
    device memory at wide D."""
    tile, staged = rp.pass_tile(d, digits)
    smem = rp.scatter_smem_bytes(tile, digits, d, staged)
    assert tile % rp.PASS_THREADS == 0 and rp.PASS_THREADS <= tile
    assert tile <= rp.MAX_TILE
    assert smem <= rp.SMEM_PER_BLOCK <= ops.SMEM_PER_BLOCK - 256
    assert rp.SCATTER_BLOCKS * (smem + rp.SMEM_RESERVE + 256) \
        <= rp.SMEM_PER_SM
    assert staged == (d <= 8)


def test_pass_tile_leaves_wide_values_in_device_memory():
    """Values too wide to stage a tile of a block's threads four ways an SM
    are not staged, and the tile is sized on the keys; narrower ones are."""
    assert rp.pass_tile(1024, 32) == (4096, False)
    assert not rp.pass_tile(300, 256)[1]
    assert rp.pass_tile(32, 32)[1]
    assert rp.scatter_smem_bytes(4096, 32, 1024, False) \
        == rp.scatter_smem_bytes(4096, 32, 1, False)


@pytest.mark.parametrize("n,k,bs,fanouts,d", [
    (1 << 22, 1 << 18, 8192, (), 2), (1 << 22, 1 << 20, 16384, (8, 8), 2),
    (1 << 22, 1 << 25, 16384, (16, 16, 8), 2), (1, 13, 4, (2, 2), 2),
    (777, 300, 300, (), 2), (1 << 20, 1 << 16, 16384, (), 300),
    (1 << 20, 1024 * 64, 64, (2, 512), 2)])
def test_partition_plan_launch_fields(n, k, bs, fanouts, d):
    """The launch's passes follow the rules the kernels check
    (csrc/radix_level.cuh read_passes): the first pass splits its one
    parent into all its buckets over ceil(n / tile) tiles, an inner pass
    splits each bucket of the one before by its fan-out over a grid of
    ceil(n / tile) + parents, no pass passes the kernels' buckets."""
    plan = rp.partition_plan(n, d, k, bs, 256)
    first, *inner = plan.passes
    assert (first.parents, first.digits) == (1, first.buckets)
    assert first.grid == -(-n // first.tile)
    for prev, p in zip(plan.passes, inner):
        assert p.parents == prev.buckets
        assert p.range_ * p.digits == prev.range_
        assert p.grid == -(-n // p.tile) + p.parents
    for p in plan.passes:
        assert p.buckets == -(-k // p.range_)
        assert p.digits <= ops.KERNEL_MAX_LEVEL_BUCKETS
        assert p.smem == rp.scatter_smem_bytes(p.tile, p.digits, d, p.staged)
        assert p.staged == (d <= 8)
    assert plan.passes[-1].range_ == bs
    assert plan.slots == rp.partition_slots(n, -(-k // bs), 256)
    assert list(plan.c_fields) == plan.launch_fields()
    assert len(plan.launch_fields()) == 7 * len(plan.passes)
    if fanouts == (8, 8):
        assert [(p.range_, p.digits) for p in plan.passes] == [(16384, 64)]
    if fanouts == (2, 512):
        assert [(p.range_, p.digits) for p in plan.passes] == [
            (64 * 32, 32), (64, 32)]

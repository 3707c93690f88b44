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
from repro_torch.kernels import _build, ops  # noqa: E402

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


def test_launches_counted_by_key_and_reset_together():
    """A launch counted with a key (flash_decode's KV positions) adds to
    the kernel's count and to its key's; a launch with no key only to the
    count; a reset clears both."""
    ops.reset_launch_counts()
    for key in (33, 1500, 33, None):
        _build.count_launch("flash_decode", key=key)
    assert ops.launch_counts()["flash_decode"] == 4
    assert ops.launch_counts_by_key("flash_decode") == {33: 2, 1500: 1}
    assert ops.launch_counts_by_key("segment_reduce") == {}
    ops.reset_launch_counts()
    assert ops.launch_counts()["flash_decode"] == 0
    assert ops.launch_counts_by_key("flash_decode") == {}


def _check_fold_plan(plan, n, k, d, counts=False, block_k=None,
                     inplace=False):
    """A plan the kernels can launch: its tables fit the shared memory and
    cover K x D, its segments (the partitioned route: its sub-chunks)
    cover the pairs, its partials fit (the partitioned route: its
    scratch, within what the tile plan would have allocated)."""
    assert plan.shape in ops.FOLD_SHAPES and plan.route in ops.FOLD_ROUTES
    if plan.route == "partitioned":
        _check_route_plan(plan, n, k, d, counts, block_k, inplace)
    if plan.shape == "lane":  # one warp a column, 32 copies of the table
        assert plan.warps == plan.cols <= ops.FOLD_LANE_MAX_WARPS
        assert plan.stage == ops.FOLD_LANE_STAGE
        assert plan.per_sm * plan.warps <= ops.FOLD_LANE_SM_WARPS
        assert plan.smem >= plan.block_k * plan.cols * 32 * 4
    else:
        assert plan.warps == (1 if plan.shape == "ballot"
                              else ops.FOLD_BUCKET_WARPS)
        assert plan.stage % 32 == 0 and 32 <= plan.stage <= (
            ops.FOLD_BALLOT_STAGE if plan.warps == 1 else ops.FOLD_MAX_STAGE)
    assert plan.smem == ops.fold_smem_bytes(plan.shape, plan.block_k,
                                            plan.cols, plan.stage)
    assert plan.smem <= ops.FOLD_SMEM < ops.SMEM_PER_BLOCK
    assert plan.per_sm >= 1 and plan.per_sm * (
        plan.smem + ops.SMEM_BLOCK_RESERVE) <= ops.SMEM_PER_SM
    assert 1 <= plan.block_k <= k and 1 <= plan.cols <= min(
        d, ops.FOLD_MAX_COLS)
    assert plan.block_k * plan.cols <= ops.FOLD_TABLE_FLOATS
    assert plan.key_tiles * plan.block_k >= k > (plan.key_tiles - 1) * \
        plan.block_k
    assert plan.col_tiles * plan.cols >= d > (plan.col_tiles - 1) * plan.cols
    if plan.shape == "lane":  # every n_seg-th run of a stage's pairs
        assert plan.seg_len == plan.stage
        assert 1 <= plan.n_seg and plan.seg_len * (plan.n_seg - 1) < n
    else:
        assert plan.seg_len * plan.n_seg >= n > plan.seg_len * (
            plan.n_seg - 1)
    assert (plan.n_seg == 1 or plan.route == "partitioned"
            or plan.n_seg * k * d <= ops.FOLD_PARTIAL_ELEMS)


def _check_route_plan(plan, n, k, d, counts, block_k, inplace):
    """The partitioned route: bucket blocks; a partition whose last pass
    splits into the key tiles; sub-chunks of at least FOLD_PART_MIN_PAIRS
    pairs (or the whole chunk); scratch as the kernel carves it, within the route's budget;
    one pass over the pairs for each partition pass and column tile."""
    from repro_torch.kernels import radix_partition as rp

    vd = d - int(counts)
    assert plan.shape == "bucket" and plan.warps == ops.FOLD_BUCKET_WARPS
    last = plan.part.passes[-1]
    assert last.range_ == plan.block_k and last.buckets == plan.key_tiles
    assert plan.part == rp.plan_passes(
        plan.seg_len, vd, k,
        rp.partition_passes(k, plan.block_k, rp.MAX_PASS_BUCKETS),
        ops.FOLD_REGION_PAD)
    assert plan.seg_len >= min(n, ops.FOLD_PART_MIN_PAIRS)
    assert plan.n_seg == -(-n // plan.seg_len)
    tickets = -(-plan.key_tiles * plan.col_tiles * 4 // 256) * 256
    partials = -(-2 * plan.extra * plan.block_k * d * 4 // 256) * 256
    assert plan.scratch == tickets + partials + ops.route_scratch_bytes(
        plan.part, plan.seg_len, vd)
    assert (plan.region_seg > 0) == (plan.extra > 0)
    tile = ops.table_plan(n, k, d, block_k)
    assert plan.scratch <= ops.route_budget(tile, k, d, inplace)
    assert tile.key_tiles > 1 and tile.scans > ops.FOLD_PART_SCANS
    assert plan.scans == len(plan.part.passes) + plan.col_tiles


@pytest.mark.parametrize("n,k,d", [(1, 1, 1), (100, 100, 4), (1 << 22, 100, 4),
                                   (1 << 20, 5000, 97), (3000, 300, 3)])
def test_launch_plan_fits_the_card(n, k, d):
    """The fold kernels' plan at the stream flow's shapes: it fits, covers
    the table and the pairs, and a table of all K x D reads the pairs once
    with enough segments to fill the card."""
    plan = ops.fold_plan(n, k, d, "add")
    _check_fold_plan(plan, n, k, d)
    if k * d <= ops.FOLD_TABLE_FLOATS:  # the lane shape: a warp a column
        assert plan.key_tiles == 1
        assert plan.col_tiles == 1 or plan.shape == "lane"
    if n >= 1 << 22:
        assert plan.n_seg >= ops.SM_COUNT


@pytest.mark.parametrize("d", [1, 3, 4, 128])
@pytest.mark.parametrize("k", [1, 100, 2048, 2049, 1 << 16])
@pytest.mark.parametrize("n", [1, 5_001, 1 << 22, 1 << 24])
def test_fold_plan_covers_the_table_and_fits(n, k, d):
    """The plan over (n, K, D): shared memory within a block's share,
    key tiles x column tiles covering K x D, segments covering N, partials
    within FOLD_PARTIAL_ELEMS; a cap on the key tile is kept."""
    plan = ops.fold_plan(n, k, d, "add")
    _check_fold_plan(plan, n, k, d)
    if plan.route == "tile":
        # the fewest tiles: a key tile takes every key its table holds
        assert plan.block_k == min(k, ops.FOLD_TABLE_FLOATS // plan.cols)
    else:  # as many key tiles as one partition pass splits into
        assert plan.key_tiles == ops.KERNEL_MAX_LEVEL_BUCKETS
        assert plan.cols == min(d, ops.FOLD_MAX_COLS)
    capped = ops.fold_plan(n, k, d, "add", block_k=7)
    _check_fold_plan(capped, n, k, d, block_k=7)
    assert capped.block_k == min(7, k)
    # in place (the chunk loop's folds), the route's budget holds acc too
    _check_fold_plan(ops.fold_plan(n, k, d, "add", inplace=True), n, k, d,
                     inplace=True)


# -- the lane-table shape of a sum (csrc/lane_fold.cuh) ----------------------

#: today's index-order plans, (n, K, D) -> (shape, block_k, cols, warps,
#: stage, smem, seg_len, n_seg, key_tiles, col_tiles); max and min keep them
TABLE_PLANS = {
    (1 << 22, 100, 3): ("ballot", 100, 3, 1, 256, 13488, 1986, 2112, 1, 1),
    (1 << 22, 100, 4): ("ballot", 100, 4, 1, 256, 16960, 2648, 1584, 1, 1),
    (1 << 24, 100, 3): ("ballot", 100, 3, 1, 256, 13488, 7944, 2112, 1, 1),
    (5001, 1000, 13): ("bucket", 1000, 13, 8, 352, 115088, 334, 15, 1, 1),
    (1 << 22, 1 << 16, 1): ("bucket", 32768, 1, 8, 1024, 196736, 63551, 66,
                            2, 1),
    (200003, 100, 128): ("bucket", 100, 64, 8, 96, 101488, 1516, 132, 1, 2),
    (3, 50, 2): ("ballot", 50, 2, 1, 256, 9616, 3, 1, 1, 1),
}


def _fields(plan):
    return (plan.shape, plan.block_k, plan.cols, plan.warps, plan.stage,
            plan.smem, plan.seg_len, plan.n_seg, plan.key_tiles,
            plan.col_tiles)


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("shape", sorted(TABLE_PLANS))
def test_max_min_keep_the_index_order_plan(shape, op):
    """Max and min never take lane tables (their NaN rule needs index
    order): their plan is the index-order one, unchanged."""
    n, k, d = shape
    plan = ops.fold_plan(n, k, d, op)
    _check_fold_plan(plan, n, k, d)
    assert plan == ops.table_plan(n, k, d)
    assert _fields(plan) == TABLE_PLANS[shape]


@pytest.mark.parametrize("n,k,d,cols,per_sm", [
    (1 << 22, 100, 4, 4, 3),  # B1: KMeans' fused [100, 3+1] accumulator
    (1 << 24, 100, 3, 3, 4),  # B6, B7: the KMeans combine's values
    (1 << 24, 100, 1, 1, 11),  # B6: the KMeans combine's counts
])
def test_main_shapes_take_lane_tables(n, k, d, cols, per_sm):
    """The sums of the main paths take lane tables: one warp a column, the
    whole key space in one tile, at least FOLD_LANE_MIN_WARPS warps an SM
    and one wave of segments."""
    plan = ops.fold_plan(n, k, d, "add")
    _check_fold_plan(plan, n, k, d)
    assert plan.shape == "lane"
    assert (plan.cols, plan.per_sm, plan.key_tiles) == (cols, per_sm, 1)
    assert plan.per_sm * plan.warps >= ops.FOLD_LANE_MIN_WARPS
    assert plan.n_seg == -(-plan.per_sm * ops.SM_COUNT // plan.col_tiles)
    assert plan.smem == k * cols * 32 * 4 + ops.FOLD_RING * 256 * (
        1 + cols) * 4


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 8, 128])
def test_lane_tables_up_to_the_crossover(d):
    """A sum takes lane tables from K = 1 up to a crossover (at most
    FOLD_LANE_MAX_KEYS): whole rows wherever a block fits, column tiles
    where they leave FOLD_LANE_MIN_WARPS warps an SM; the index-order plan
    past it."""
    top_k = ops.FOLD_LANE_MAX_KEYS + 50
    shapes = [ops.fold_plan(1 << 22, k, d, "add") for k in range(1, top_k)]
    lane = [p.shape == "lane" for p in shapes]
    top = lane.index(False)  # keys of the crossover
    assert top > 100 and not any(lane[top:])
    assert top <= ops.FOLD_LANE_MAX_KEYS
    for k, plan in enumerate(shapes[:top], start=1):
        _check_fold_plan(plan, 1 << 22, k, d)
        assert plan.col_tiles == 1 or (
            plan.per_sm * plan.warps >= ops.FOLD_LANE_MIN_WARPS)
        assert plan.col_tiles == 1 or d > ops.FOLD_LANE_MAX_WARPS
    past = ops.lane_plan(1 << 22, top + 1, d)
    assert (top + 1 > ops.FOLD_LANE_MAX_KEYS or past is None
            or (past.col_tiles > 1
                and past.per_sm * past.warps < ops.FOLD_LANE_MIN_WARPS))


@pytest.mark.parametrize("k", [16, 64, 100, 128, 256, 512, 1024])
@pytest.mark.parametrize("d", [1, 3, 4])
def test_lane_plan_runs_past_the_crossover(k, d):
    """lane_plan (the sweep behind the crossover times it) plans any of
    the sweep's shapes, with fewer warps an SM as K grows; a cap on the
    key tile is kept."""
    plan = ops.lane_plan(1 << 22, k, d)
    _check_fold_plan(plan, 1 << 22, k, d)
    assert plan.shape == "lane" and plan.key_tiles == 1
    # whole rows, one warp a column, wherever a block of them fits
    assert (plan.cols == d) == (k * d * 128 + 3 * 256 * (1 + d) * 4
                                <= ops.FOLD_SMEM)
    capped = ops.lane_plan(1 << 22, k, d, block_k=7)
    _check_fold_plan(capped, 1 << 22, k, d)
    assert capped.block_k == 7


def test_fold_plan_checks_its_op():
    with pytest.raises(ValueError):
        ops.fold_plan(10, 10, 1, "mul")


def test_card_tensors_pass_the_lane_plan_to_the_fold_kernels(monkeypatch):
    """On a tensor off the CPU, onehot_fold and chunk_monoid_fold's add
    launch with the lane-table plan, its max with the index-order plan;
    no plain version runs.  Meta tensors stand in for CUDA tensors and
    recorders for the bindings."""
    from repro_torch.kernels import onehot_combine as toc
    from repro_torch.kernels import segment_reduce as tsr
    calls = []

    def plain(*a, **k):
        raise AssertionError("a plain version ran on a card tensor")

    def fold(keys, values, acc, plan):
        calls.append(("onehot_fold", plan))
        return torch.empty_like(acc)

    def monoid(keys, values, acc, op, plan):
        calls.append((op, plan))
        return torch.empty_like(acc)

    monkeypatch.setattr(toc, "onehot_fold_plain", plain)
    monkeypatch.setattr(tsr, "chunk_monoid_fold_plain", plain)
    monkeypatch.setattr(toc, "onehot_fold_cuda", fold)
    monkeypatch.setattr(tsr, "chunk_monoid_fold_cuda", monoid)
    n, k, d = 1 << 22, 100, 4
    keys = torch.empty(n, dtype=torch.int32, device="meta")
    vals = torch.empty((n, d), device="meta")
    acc = torch.empty((k, d), device="meta")
    ops.onehot_fold(keys, vals, acc)
    ops.chunk_monoid_fold(keys, vals, acc, "add")
    ops.chunk_monoid_fold(keys, vals, acc, "max")
    lane = ops.lane_plan(n, k, d)
    assert calls == [("onehot_fold", lane), ("add", lane),
                     ("max", ops.table_plan(n, k, d))]

"""The keyed fold's partitioned route on the CPU: the plan that takes it,
the sub-chunks that keep its scratch within the memory it no longer
allocates (a fold out of place keeps the tile route where it would
allocate more), its counters, the ``lowering:`` line that names it, and
the chunk loop that folds its own carry in place and never a state it was
given.  ``tests/test_torch_fold_route_card.py`` runs the route itself."""

import pytest

torch = pytest.importorskip("torch")

from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch import apps, spans  # noqa: E402
from repro_torch.core import MapReduce  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import onehot_combine as oc  # noqa: E402
from repro_torch.kernels import radix_partition as rp  # noqa: E402

CELL_K = 2_500_000  # the uv.sourceip cell's groups
SWEEP_K = (1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 20, CELL_K)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("k", SWEEP_K)
def test_the_route_past_the_threshold_and_the_tile_plan_below(k, d):
    """Past one key tile, where the tile plan reads each pair more than
    FOLD_PART_SCANS times, a fold in place takes the partitioned route (its
    scratch within the tile plan's table or partials); else the tile
    plan, unchanged."""
    n = 1 << 22
    tile = ops.tile_plan(n, k, d, "add")
    plan = ops.fold_plan(n, k, d, "add", None, True, True)
    if tile.key_tiles > 1 and tile.scans > ops.FOLD_PART_SCANS:
        budget = ops.route_budget(tile, k, d, True)
        assert plan.route == "partitioned"
        assert plan.scans < tile.scans
        assert plan.scratch <= budget
        assert plan == ops.partitioned_plan(n, k, d, counts=True,
                                            budget=budget)
    else:
        assert plan == tile and plan.route == "tile"


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("n,d", [(1 << 22, 4), (1 << 24, 3), (1 << 24, 1),
                                 (1 << 22, 3), (200_003, 128)])
def test_k100_plans_are_the_tile_plans(n, d, op):
    """Every K = 100 fold (the KMeans, BoundingBox and combine paths)
    keeps its tile plan: one key tile never takes the route."""
    for counts in ((False, True) if op == "add" else (False,)):
        for inplace in (False, True):
            plan = ops.fold_plan(n, 100, d, op, None, counts, inplace)
            assert (plan == ops.tile_plan(n, 100, d, op)
                    and plan.route == "tile")


def test_the_cells_fold_reads_each_pair_twice():
    """uv.sourceip's chunk: 2^22 pairs into [2.5M, 1 + counts] with the
    tiling's key block, 77 x 2 tile reads against 2 on the route: one
    partition pass into 256 key tiles of 9766 keys, both columns in one
    table, two sub-chunks of 2^21 pairs whose scratch fits the table."""
    n = 1 << 22
    tile = ops.tile_plan(n, CELL_K, 2, "add", 32768)
    assert (tile.key_tiles, tile.col_tiles, tile.scans) == (77, 2, 154)
    plan = ops.fold_plan(n, CELL_K, 2, "add", 32768, True, True)
    assert plan.route == "partitioned" and plan.scans == 2
    assert (plan.key_tiles, plan.block_k, plan.cols) == (256, 9766, 2)
    assert (plan.n_seg, plan.seg_len) == (2, 1 << 21)
    assert len(plan.part.passes) == 1
    assert plan.part.slots == rp.partition_slots(1 << 21, 256,
                                                 ops.FOLD_REGION_PAD)
    assert plan.scratch <= CELL_K * 2 * 4
    # uniform keys cut no region: 8192 slots a region, segments past that
    assert plan.region_seg > 8 * (plan.part.slots // 256) and plan.extra > 1
    # the layout alone of a whole chunk would not fit
    whole = rp.plan_passes(n, 1, CELL_K, rp.partition_passes(
        CELL_K, 9766, rp.MAX_PASS_BUCKETS), ops.FOLD_REGION_PAD)
    assert ops.route_scratch_bytes(whole, n, 1) > CELL_K * 2 * 4


@pytest.mark.parametrize("d,counts", [(1, False), (2, False), (2, True),
                                      (4, False), (4, True), (70, True)])
@pytest.mark.parametrize("k", [1 << 17, 1 << 20, CELL_K, 1 << 24])
@pytest.mark.parametrize("n", [1 << 16, 3_000_017, 1 << 22, 1 << 24])
def test_sub_chunks_keep_the_scratch_within_the_table(n, k, d, counts):
    """The route's sub-chunks are the fewest equal ones whose scratch
    (layout and partition counts) fits K x D x 4 bytes, none shorter than
    FOLD_PART_MIN_PAIRS; where none fits there is no route."""
    plan = ops.partitioned_plan(n, k, d, counts=counts, budget=k * d * 4)
    if plan is None:
        return
    vd = d - counts
    tickets = -(-plan.key_tiles * plan.col_tiles * 4 // 256) * 256
    table = plan.block_k * d * 4
    layout = ops.route_scratch_bytes(plan.part, plan.seg_len, vd)
    assert plan.scratch == (tickets + layout
                            + -(-2 * plan.extra * table // 256) * 256)
    assert plan.scratch <= k * d * 4
    assert plan.seg_len >= min(n, ops.FOLD_PART_MIN_PAIRS)
    assert plan.seg_len * plan.n_seg >= n > plan.seg_len * (plan.n_seg - 1)
    if plan.n_seg > 1:  # one sub-chunk fewer would not fit
        m = -(-n // (plan.n_seg - 1))
        part = rp.plan_passes(m, vd, k, rp.partition_passes(
            k, plan.block_k, rp.MAX_PASS_BUCKETS), ops.FOLD_REGION_PAD)
        assert tickets + ops.route_scratch_bytes(part, m, vd) > k * d * 4
    # the leftover holds the partials of the cut regions, or nothing cuts
    if plan.extra:
        slots = plan.part.slots
        assert plan.region_seg == -(-slots // plan.extra)
        assert plan.region_seg >= max(2 * -(-slots // plan.key_tiles),
                                      ops.FOLD_REGION_MIN_SEG)
        assert plan.extra <= plan.per_sm * ops.SM_COUNT
    else:
        assert plan.region_seg == 0
    assert plan.block_k * plan.cols <= ops.FOLD_TABLE_FLOATS
    assert plan.key_tiles * plan.block_k >= k


def test_no_route_where_the_sub_chunks_would_be_too_short():
    """A table too small to hold the layout of FOLD_PART_MIN_PAIRS pairs
    keeps the tile route."""
    assert ops.partitioned_plan(1 << 22, 1 << 16, 1, counts=False,
                                budget=(1 << 16) * 4) is None
    assert ops.fold_plan(1 << 22, 1 << 16, 1, "max").route == "tile"


@pytest.mark.parametrize("op", ["add", "max"])
@pytest.mark.parametrize("n,k,d", [(1 << 22, CELL_K, 2), (1 << 20, CELL_K, 2),
                                   (1 << 22, 1 << 20, 3),
                                   (10_000, 1 << 16, 3)])
def test_a_fold_out_of_place_allocates_no_more_than_the_tile_route(n, k, d,
                                                                   op):
    """Out of place (B6 and B7 build a fresh table; a fold called without
    ``inplace``) the route may only take the tile plan's segment
    partials: where the tile plan has none it keeps the tile plan, whose
    fresh table it allocates either way."""
    tile = ops.tile_plan(n, k, d, op)
    table = k * d * 4
    partials = tile.n_seg * table if tile.n_seg > 1 else 0
    assert ops.route_budget(tile, k, d, False) == partials
    assert ops.route_budget(tile, k, d, True) == max(table, partials)
    plan = ops.fold_plan(n, k, d, op)
    if partials == 0:
        assert plan == tile
    else:
        assert plan.route == "tile" or plan.scratch <= partials
    assert ops.fold_plan(n, k, d, op, inplace=True).route == "partitioned"


def test_fold_counters_count_reads_and_routes():
    """fold_scans counts n x plan.scans (1 a partition pass plus the
    column tiles on the route; key tiles x column tiles on the tile
    route), fold_partitioned one a fold on the route."""
    n = 1 << 22
    route = ops.fold_plan(n, CELL_K, 4, "add", None, True, True)
    tile = ops.tile_plan(n, CELL_K, 4, "add")
    assert route.route == "partitioned" and route.col_tiles == 2
    with spans.recording() as rec:
        oc.count_fold(n, route)
        oc.count_fold(n, tile)
    assert rec.counters["fold_pairs"] == 2 * n
    assert rec.counters["fold_scans"] == n * (1 + 2) + n * 77 * 4
    assert rec.counters["fold_partitioned"] == 1


def test_a_fold_in_place_writes_acc_and_gives_the_same_bits():
    """``inplace`` writes the result into acc and returns it, with the
    bits of a fresh table; it takes a contiguous f32 acc only."""
    g = torch.Generator().manual_seed(0)
    keys = torch.randint(-2, 40, (500,), generator=g, dtype=torch.int32)
    vals = torch.rand((500, 3), generator=g)
    acc = torch.rand((37, 4), generator=g)
    want = ops.onehot_fold(keys, vals, acc, counts=True)
    mine = acc.clone()
    got = ops.onehot_fold(keys, vals, mine, counts=True, inplace=True)
    assert got is mine and torch.equal(got, want)
    acc3 = acc[:, :3].contiguous()
    want = ops.chunk_monoid_fold(keys, vals, acc3, "max")
    got = ops.chunk_monoid_fold(keys, vals, acc3, "max", inplace=True)
    assert got is acc3 and torch.equal(got, want)
    with pytest.raises(ValueError):  # a view across rows: not in place
        ops.onehot_fold(keys, vals, acc.t().contiguous().t(), inplace=True,
                        counts=True)


def _keyed_sum_run(k, chunk_pairs):
    app = apps.KeyedSum(k)
    spec = MapReduce(app, flow="stream", device="cpu").plan.spec
    return app, eng.LocalRun(app, "stream", spec, device="cpu",
                             use_kernels=True, chunk_pairs=chunk_pairs)


def _keyed_items(k, n_items, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, k, (n_items, 8), generator=g, dtype=torch.int32),
            torch.rand(n_items, 8, generator=g))


def test_the_loop_folds_its_own_carry_in_place_and_never_a_seed():
    """fold_items_chunked folds init_state's accumulator, and each chunk's
    result after it, in place; a state the caller seeds is copied once and
    is unchanged after the run; the bits are those of the folds out of
    place."""
    k, ci = 50, 40
    app, run = _keyed_sum_run(k, ci * 8)
    comb = run.combiner(ci)
    items = _keyed_items(k, 150)
    seen = []
    real = comb.fold_fn

    def fold(keys, rows, acc, **kw):
        out = real(keys, rows, acc, **kw)
        seen.append((kw.get("inplace", False), acc.data_ptr(),
                     out.data_ptr()))
        return out

    comb.fold_fn = fold
    state = eng.fold_items_chunked(app, comb, items, ci)
    assert len(seen) == 4 and all(inplace for inplace, _, _ in seen)
    assert {p for _, a, o in seen for p in (a, o)} == {state.data_ptr()}

    seen.clear()
    seed = comb.init_state() + 0.25
    kept = seed.clone()
    got = eng.fold_items_chunked(app, comb, items, ci, state=seed)
    assert torch.equal(seed, kept)
    assert len(seen) == 4 and all(inplace for inplace, _, _ in seen)
    assert {p for _, a, o in seen for p in (a, o)} == {got.data_ptr()}
    assert got.data_ptr() != seed.data_ptr()

    comb.fold_fn = lambda *a, **kw: real(*a, **{**kw, "inplace": False})
    assert torch.equal(eng.fold_items_chunked(app, comb, items, ci), state)
    want = eng.fold_items_chunked(app, comb, items, ci, state=kept)
    assert torch.equal(got, want)


def test_a_seed_is_copied_only_for_a_collector_that_folds_in_place():
    """The sort collector folds out of place: its seed is handed on as it
    is, and still never written."""
    app = apps.KeyedSum(50)
    spec = MapReduce(app, flow="sort", device="cpu").plan.spec
    run = eng.LocalRun(app, "sort", spec, device="cpu", use_kernels=True,
                       chunk_pairs=320)
    comb = run.combiner(40)
    assert not comb.folds_in_place
    items = _keyed_items(50, 150)
    seed = eng.fold_items_chunked(app, comb, items, 40)
    kept = pytree.tree_map(torch.clone, seed)
    got = eng.fold_items_chunked(app, comb, items, 40, state=seed)
    for a, b in zip(pytree.tree_leaves(seed), pytree.tree_leaves(kept)):
        assert torch.equal(a, b)
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(seed)):
        assert a.data_ptr() != b.data_ptr()


def test_dense_tables_folded_in_place_and_a_seed_kept():
    """The dense lowering's f32 max/min tables (BoundingBox through
    chunk_monoid_fold) follow the same rule: the loop's own tables in
    place, a seed never written, the bits of the plain fold."""
    app, ci, n = apps.BoundingBox(), 50, 170
    spec = MapReduce(app, flow="stream", device="cpu").plan.spec

    def combiner(use_kernels):
        return eng.LocalRun(app, "stream", spec, device="cpu",
                            use_kernels=use_kernels,
                            chunk_pairs=ci).combiner(ci)

    comb = combiner(True)
    assert comb.mode == "dense"
    g = torch.Generator().manual_seed(1)
    items = (torch.randint(0, app.key_space, (n,), generator=g,
                           dtype=torch.int32),
             torch.randn((n, 3), generator=g))
    own = eng.fold_items_chunked(app, comb, items, ci)
    seed = eng.fold_items_chunked(app, comb, tuple(a[:ci] for a in items),
                                  ci)
    kept = pytree.tree_map(torch.clone, seed)
    eng.fold_items_chunked(app, comb, items, ci, state=seed)
    for a, b in zip(pytree.tree_leaves(seed), pytree.tree_leaves(kept)):
        assert torch.equal(a, b)
    want = eng.fold_items_chunked(app, combiner(False), items, ci)
    for a, b in zip(pytree.tree_leaves(own), pytree.tree_leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k,route", [(1 << 20, "partitioned route"),
                                     (100, "tile route")])
def test_explain_names_the_route_and_keeps_the_stream_flow(k, route):
    """After a run with the kernels on, ``explain()`` says ``flow:
    stream`` and its ``lowering:`` line names the route of each chunk's
    fold."""
    mr = MapReduce(apps.KeyedSum(k), flow="auto", device="cpu",
                   use_kernels=True)
    assert "lowering:" not in mr.explain()
    mr.run(_keyed_items(k, 4))
    lines = mr.explain().splitlines()
    assert lines[0].startswith("flow: stream")
    (low,) = [ln for ln in lines if ln.startswith("lowering:")]
    assert low.startswith(f"lowering: stream (K={k}: onehot_fold [K, 2] "
                          f"n=32: {route}")

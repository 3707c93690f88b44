"""The keyed fold's partitioned route on the card, against its tile route
and a float64 reference.

Skips where there is no CUDA card (``tests/test_torch_fold_route.py``
holds the plan, the sub-chunk sizing, the counters and the chunk loop's
ownership on the CPU).  The tile route is reached through the bindings'
explicit plan (``ops.tile_plan``), the route through ``ops.fold_plan`` of
a fold in place, as the chunk loop folds: bit for bit where a chunk folds
whole (sums and counts at the benchmark cell's K = 2.5M, max and min with
NaN and signed zeros, also with a hot key's region cut into segments, B6
and B7 from the identity through the route's explicit plan), within
rounding of float64 at n = 2^22 with half the pairs on one key and with
sentinel and negative keys, the same bits on two runs, in place as out
of place, and no more device memory than the tile route, in place or
building a fresh table.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import combine_scatter as cs  # noqa: E402
from repro_torch.kernels import onehot_combine as oc  # noqa: E402
from repro_torch.kernels import radix_partition as rp  # noqa: E402
from repro_torch.kernels import segment_reduce as sr  # noqa: E402

K = 2_500_000  # the uv.sourceip cell's groups


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only there")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32)


def _pairs(dev, n, k, d, seed=0, *, hot=False, bad=False):
    """Uniform keys (``hot``: key 7 holds half the pairs; ``bad``: a tenth
    are the sentinel K, K + 3 or negative), f32 values, an f32 acc."""
    g = torch.Generator(device=dev).manual_seed(seed)
    keys = torch.randint(0, k, (n,), device=dev, generator=g,
                         dtype=torch.int32)
    if hot:
        keys[torch.rand(n, device=dev, generator=g) < 0.5] = 7
    if bad:
        pick = torch.rand(n, device=dev, generator=g)
        keys[pick < 0.04] = k
        keys[(pick >= 0.04) & (pick < 0.07)] = -1 - (keys[
            (pick >= 0.04) & (pick < 0.07)] % 5)
        keys[(pick >= 0.07) & (pick < 0.1)] = k + 3
    vals = torch.rand((n, d), device=dev, generator=g) - 0.5
    return keys, vals


def _acc(dev, k, d, seed=1, counts=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    acc = torch.rand((k, d), device=dev, generator=g)
    if counts:
        acc[:, -1] = torch.randint(0, 50, (k,), device=dev, generator=g)
    return acc


@pytest.mark.cuda
def test_route_equals_the_tile_route_bit_for_bit(card):
    """K = 2.5M, n = 2^21, D = 1 + counts: one sub-chunk, so each key's
    pairs fold in index order as the tile route's one segment does."""
    n = 1 << 21
    keys, vals = _pairs(card, n, K, 1)
    acc = _acc(card, K, 2)
    route = ops.fold_plan(n, K, 2, "add", None, True, True)
    tile = ops.tile_plan(n, K, 2, "add")
    assert route.route == "partitioned" and route.n_seg == 1
    assert tile.route == "tile" and tile.n_seg == 1
    got = oc.onehot_fold_cuda(keys, vals, acc, route, counts=True)
    want = oc.onehot_fold_cuda(keys, vals, acc, tile, counts=True)
    assert torch.equal(_bits(got), _bits(want))
    again = ops.onehot_fold(keys, vals, acc.clone(), counts=True,
                            inplace=True)
    assert torch.equal(_bits(again), _bits(got))


@pytest.mark.cuda
@pytest.mark.parametrize("hot,bad", [(False, True), (True, False),
                                     (True, True)])
def test_route_against_float64_with_hot_and_bad_keys(card, hot, bad):
    """n = 2^22 (two sub-chunks): sums within f32 rounding of float64
    (against each key's sum of magnitudes: the hot key's 2M terms cancel),
    counts exact, keys outside [0, K) dropped, two runs the same bits."""
    n = 1 << 22
    keys, vals = _pairs(card, n, K, 1, hot=hot, bad=bad)
    acc = _acc(card, K, 2)
    plan = ops.fold_plan(n, K, 2, "add", None, True, True)
    assert plan.route == "partitioned" and plan.n_seg == 2
    got = [ops.onehot_fold(keys, vals, acc.clone(), counts=True,
                           inplace=True) for _ in range(2)]
    assert torch.equal(_bits(got[0]), _bits(got[1]))
    ok = (keys >= 0) & (keys < K)
    k64 = keys[ok].long()
    want = acc.double()
    want[:, 0].index_add_(0, k64, vals[ok, 0].double())
    want[:, 1] += torch.bincount(k64, minlength=K).double()
    assert torch.equal(got[0][:, 1].double(), want[:, 1])
    mass = acc[:, 0].double().abs().index_add_(0, k64,
                                               vals[ok, 0].double().abs())
    err = (got[0][:, 0].double() - want[:, 0]).abs()
    assert float((err / mass.clamp(min=1.0)).max()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("op", ["max", "min"])
def test_max_min_route_equals_the_tile_route(card, op, hot):
    """B2 past FOLD_PART_SCANS, one sub-chunk: bit for bit the tile route,
    NaN payloads and signed zeros included, in place too; with half the
    pairs on one key its region is cut into segments joined in order."""
    n, d = 1 << 20, 1
    keys, vals = _pairs(card, n, K, d, hot=hot, bad=True)
    pick = torch.rand(n, device=card)
    vals[pick < 0.2] = 0.0
    vals[(pick >= 0.2) & (pick < 0.4)] = -0.0
    nan = torch.tensor([0x7FC00001, 0xFFC00002 - (1 << 32), 0x7F800003],
                       dtype=torch.int32, device=card).view(torch.float32)
    where = (pick >= 0.4) & (pick < 0.403)
    vals[where, 0] = nan[torch.arange(int(where.sum()), device=card) % 3]
    acc = _acc(card, K, d, counts=False)
    acc[::3] = -0.0
    acc[1::7] = float("nan")
    route = ops.fold_plan(n, K, d, op, inplace=True)
    assert route.route == "partitioned" and route.n_seg == 1
    assert route.extra > 1 and route.region_seg < n // 4  # hot: cut
    tile = ops.tile_plan(n, K, d, op)
    got = sr.chunk_monoid_fold_cuda(keys, vals, acc, op, route)
    want = sr.chunk_monoid_fold_cuda(keys, vals, acc, op, tile)
    assert torch.equal(_bits(got), _bits(want))
    inplace = ops.chunk_monoid_fold(keys, vals, acc.clone(), op,
                                    inplace=True)
    assert torch.equal(_bits(inplace), _bits(got))


@pytest.mark.cuda
@pytest.mark.parametrize("name,op", [("onehot_combine", "add"),
                                     ("combine_scatter", "add"),
                                     ("combine_scatter", "max")])
def test_tables_from_the_identity_on_the_route(card, name, op):
    """B6 and B7 build from the identity: through the route's explicit
    plan (they take it where the tile plan has segment partials to give
    up), the table equals the tile route's bit for bit (one sub-chunk)."""
    n, d = 1 << 20, 2
    keys, vals = _pairs(card, n, K, d, bad=True)
    route = ops.fold_plan(n, K, d, op, inplace=True)
    assert route.route == "partitioned" and route.n_seg == 1
    tile = ops.tile_plan(n, K, d, op)
    if name == "onehot_combine":
        got, want = (oc.onehot_combine_cuda(keys, vals, K, p)
                     for p in (route, tile))
    else:
        got, want = (cs.combine_scatter_cuda(keys, vals, K, op, p)
                     for p in (route, tile))
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_route_in_place_takes_no_more_memory_than_the_tile_route(card):
    """At the cell's shape (n = 2^22, [2.5M, 2] with counts) the route in
    place allocates its scratch alone, and no more than the tile route's
    fresh table."""
    n = 1 << 22
    keys, vals = _pairs(card, n, K, 1)
    acc = _acc(card, K, 2)
    tile = ops.tile_plan(n, K, 2, "add")
    peaks = {}
    for name, fold in (
            ("tile", lambda: oc.onehot_fold_cuda(keys, vals, acc, tile,
                                                 counts=True)),
            ("route", lambda: ops.onehot_fold(keys, vals, acc, counts=True,
                                              inplace=True))):
        fold()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fold()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
        del out
    assert 0 < peaks["route"] <= peaks["tile"], peaks


@pytest.mark.cuda
def test_a_table_from_the_identity_takes_no_more_memory(card):
    """B6 at the cell's K (n = 2^22, D = 2, a one-segment tile plan) folds
    out of place into a fresh table: it keeps the tile route and
    allocates no more than the tile route's explicit plan."""
    n = 1 << 22
    keys, vals = _pairs(card, n, K, 2, bad=True)
    tile = ops.tile_plan(n, K, 2, "add")
    assert tile.n_seg == 1 and ops.fold_plan(n, K, 2, "add") == tile
    peaks = {}
    for name, fold in (
            ("tile", lambda: oc.onehot_combine_cuda(keys, vals, K, tile)),
            ("ops", lambda: ops.onehot_combine(keys, vals, K))):
        fold()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fold()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
        del out
    assert 0 < peaks["ops"] <= peaks["tile"], peaks


@pytest.mark.cuda
def test_counters_and_the_scratch_the_kernel_carves(card):
    """One fold on the route counts n x plan.scans reads and one
    fold_partitioned; the plan's partition scratch is the kernel's."""
    n = 1 << 21
    keys, vals = _pairs(card, n, K, 1)
    plan = ops.fold_plan(n, K, 2, "add", None, True, True)
    with spans.recording() as rec:
        ops.onehot_fold(keys, vals, _acc(card, K, 2), counts=True,
                        inplace=True)
    assert rec.counters["fold_pairs"] == n
    assert rec.counters["fold_scans"] == n * plan.scans == 2 * n
    assert rec.counters["fold_partitioned"] == 1
    lib = _build.library("radix_partition")
    part = plan.part
    assert lib.radix_partition_scratch_bytes(
        n, 1, K, ops.FOLD_REGION_PAD, part.c_fields,
        len(part.passes)) == rp.scratch_bytes(part, n, 1)

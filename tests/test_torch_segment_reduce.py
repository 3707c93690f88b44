"""The sort flow's segment reduce, through its plain version (CPU).

``repro_torch.kernels.ops.segment_reduce`` on CPU tensors takes the plain
version of the ``segment_reduce`` kernel.  These tests hold it against the
Pallas kernel of ``repro`` (interpret mode) and ``repro.kernels.ref`` on
key-sorted streams and on the radix partition's layout, which is what the
sort flow hands it.  Max/min must agree bit for bit, NaN and signed zeros
included; sums within rtol = 1e-5 plus 1e-6 of each key's sum of absolute
values (the summation order differs).  ``sort_segment_fold`` (partition,
reduce and the merge onto the carried table) is held against the
reference's oracle the same way, and on tensors that do not lie on the CPU
the wrappers must reach the kernels' bindings and never the plain
versions.  The CUDA kernel itself is held against the plain version on the
card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import radix_partition as rp  # noqa: E402
from repro_torch.kernels import segment_reduce as sr  # noqa: E402


def _values(rng, shape, specials):
    vals = rng.standard_normal(shape).astype(np.float32)
    if specials:
        flat = vals.reshape(-1)
        p = rng.random(flat.size)
        flat[p < 0.15] = 0.0
        flat[(p >= 0.15) & (p < 0.3)] = -0.0
        flat[(p >= 0.3) & (p < 0.33)] = np.nan
    return vals


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _assert_reduced(got, want, keys, vals, k, op):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if op != "add":
        np.testing.assert_array_equal(_bits(got), _bits(want))
        return
    ok = (keys >= 0) & (keys < k)
    sum_abs = np.zeros(want.shape, np.float64)
    np.add.at(sum_abs, keys[ok], np.abs(vals[ok]).astype(np.float64))
    tol = 1e-5 * np.abs(want) + 1e-6 * sum_abs
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def _port(keys, vals, k, op, **kw):
    return ops.segment_reduce(torch.from_numpy(keys), torch.from_numpy(vals),
                              k, op, **kw).numpy()


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("n,d,k,tile", [(200, 8, 512, 64),
                                        (1000, 4, 4096, 256),
                                        (64, 16, 64, 32), (300, 2, 37, 16)])
def test_sorted_stream_matches_pallas_and_ref(op, n, d, k, tile):
    rng = np.random.default_rng(n + d + k)
    keys = np.sort(rng.integers(0, k + 1, size=n)).astype(np.int32)
    vals = _values(rng, (n, d), op != "add")
    got = _port(keys, vals, k, op, tile_n=tile)
    pallas = jops.segment_reduce(jnp.asarray(keys), jnp.asarray(vals), k, op,
                                 tile_n=tile, interpret=True)
    _assert_reduced(got, pallas, keys, vals, k, op)
    _assert_reduced(got, jref.segment_reduce(jnp.asarray(keys),
                                             jnp.asarray(vals), k, op),
                    keys, vals, k, op)


def test_skewed_keys():
    """One giant run and many singletons."""
    rng = np.random.default_rng(11)
    k = 2048
    keys = np.sort(np.concatenate([np.zeros(500, np.int32),
                                   rng.integers(0, k, size=100)])
                   ).astype(np.int32)
    vals = rng.standard_normal((600, 8)).astype(np.float32)
    got = _port(keys, vals, k, "add")
    want = jops.segment_reduce(jnp.asarray(keys), jnp.asarray(vals), k,
                               "add", interpret=True)
    _assert_reduced(got, want, keys, vals, k, "add")


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("n,d,k,bs,pa", [(300, 3, 100, 32, 16),
                                         (500, 2, 1000, 64, 16),
                                         (200, 1, 256, 16, 8)])
def test_radix_layout_matches_pallas(op, n, d, k, bs, pa):
    """What the sort flow runs: the partition's layout reduced with
    block_k = bucket_size and tile_n = pad_align."""
    rng = np.random.default_rng(7 * n + k)
    keys = rng.integers(0, k + 1, size=n).astype(np.int32)
    vals = _values(rng, (n, d), op != "add")
    pk, pv, _ = ops.radix_partition(torch.from_numpy(keys),
                                    torch.from_numpy(vals), k,
                                    bucket_size=bs, pad_align=pa)
    got = ops.segment_reduce(pk, pv, k, op, tile_n=pa, block_k=bs).numpy()
    jk, jv, _ = jops.radix_partition(jnp.asarray(keys), jnp.asarray(vals), k,
                                     bucket_size=bs, pad_align=pa, tile_n=pa,
                                     interpret=True)
    pallas = jops.segment_reduce(jk, jv, k, op, tile_n=pa, block_k=bs,
                                 interpret=True)
    _assert_reduced(got, pallas, keys, vals, k, op)


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("fanouts", [None, (4, 4)])
def test_sort_segment_fold_matches_oracle(op, fanouts):
    """Partition, reduce and the merge onto the carried table (rows of
    absent keys keep acc's value, bit for bit)."""
    rng = np.random.default_rng(3 if fanouts else 4)
    n, d, k, bs = 333, 2, 250, 16
    keys = rng.integers(0, k + 1, size=n).astype(np.int32)
    vals = _values(rng, (n, d), op != "add")
    acc = _values(rng, (k, d), op != "add")
    got = ops.sort_segment_fold(torch.from_numpy(keys),
                                torch.from_numpy(vals), torch.from_numpy(acc),
                                op, bucket_size=bs, fanouts=fanouts,
                                pad_align=16).numpy()
    want = np.asarray(jref.sort_segment_fold(jnp.asarray(keys),
                                             jnp.asarray(vals),
                                             jnp.asarray(acc), op))
    if op == "add":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    absent = np.setdiff1d(np.arange(k), keys)
    np.testing.assert_array_equal(_bits(got[absent]), _bits(acc[absent]))


def test_sort_segment_fold_plans_itself():
    """Without a bucket the fold takes plan_radix_levels' plan."""
    rng = np.random.default_rng(5)
    k = 50_000
    keys = rng.integers(0, k, size=2000).astype(np.int32)
    vals = rng.random((2000, 1), dtype=np.float32)
    got = ops.sort_segment_fold(torch.from_numpy(keys),
                                torch.from_numpy(vals),
                                torch.zeros(k, 1)).numpy()
    want = np.zeros((k, 1))
    np.add.at(want, keys, vals.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("op,ident", [("add", 0.0), ("max", -np.inf),
                                      ("min", np.inf)])
def test_absent_keys_get_the_identity(op, ident):
    keys = np.array([1, 1, 4, 9, -2, 12], np.int32)
    vals = np.arange(12, dtype=np.float32).reshape(6, 2)
    got = _port(np.sort(keys), vals, 9, op)
    for key in (0, 2, 3, 5, 6, 7, 8):
        assert (got[key] == ident).all()
    empty = _port(np.zeros(0, np.int32), np.zeros((0, 2), np.float32), 9, op)
    assert empty.shape == (9, 2) and (empty == ident).all()


@pytest.mark.parametrize("seed,tile", [(0, 16), (1, 64), (2, 256), (3, 8)])
def test_tile_block_k_is_the_smallest_aligned_block(seed, tile):
    """The block derived from the keys holds every tile's keys in [0, K)
    inside one aligned block, and half of it would not (unless it is at
    its floor of 8 or is K itself)."""
    rng = np.random.default_rng(seed)
    k = 5000
    keys = np.sort(rng.integers(-3, k + 4, size=1000)).astype(np.int32)
    blk = ops.tile_block_k(torch.from_numpy(keys), k, tile)

    def aligned(b):
        for lo in range(0, len(keys), tile):
            t = keys[lo:lo + tile]
            t = t[(t >= 0) & (t < k)]
            if t.size and t.min() // b != t.max() // b:
                return False
        return True

    assert aligned(blk)
    assert blk in (8, k) or not aligned(blk // 2)


def test_wrappers_on_a_card_tensor_reach_the_kernels_only(monkeypatch):
    """On tensors that do not lie on the CPU, sort_segment_fold calls the
    partition and segment_reduce bindings and nothing else: no plain
    version, no fallback.  Meta tensors stand in for CUDA tensors and
    recorders for the bindings."""
    calls = []

    def plain(*a, **k):
        raise AssertionError("a plain version ran on a card tensor")

    def partition(keys, values, key_space, plan, *, pad_align, multi):
        calls.append(("partition", plan.passes[-1].range_,
                      tuple((p.range_, p.digits) for p in plan.passes),
                      pad_align, multi))
        np_ = plan.slots
        return (torch.empty(np_, dtype=torch.int32, device="meta"),
                torch.empty((np_, values.shape[1]), device="meta"),
                torch.empty(plan.passes[-1].buckets, dtype=torch.int32,
                            device="meta"))

    def reduce(keys, values, key_space, op, *, block_k, tile, acc=None):
        calls.append(("segment_reduce", op, block_k, tile, acc is not None))
        return torch.empty((key_space, values.shape[1]), device="meta")

    for name in ("radix_partition_plain", "radix_partition_multi_plain"):
        monkeypatch.setattr(rp, name, plain)
    monkeypatch.setattr(sr, "segment_reduce_plain", plain)
    monkeypatch.setattr(rp, "radix_partition_cuda", partition)
    monkeypatch.setattr(sr, "segment_reduce_cuda", reduce)
    k = 1 << 20
    keys = torch.empty(4096, dtype=torch.int32, device="meta")
    vals = torch.empty((4096, 2), device="meta")
    acc = torch.empty((k, 2), device="meta")
    out = ops.sort_segment_fold(keys, vals, acc, "max")
    assert out.shape == (k, 2)
    # the plan's two levels (8, 8) reach the hierarchy's kernel as one
    # pass of 64 buckets
    assert calls == [("partition", 16384, ((16384, 64),), 256, True),
                     ("segment_reduce", "max", 16384, 256, True)]
    with pytest.raises(TypeError):  # the kernels take f32 values only
        ops.sort_segment_fold(keys, vals.to(torch.float64),
                              acc.to(torch.float64))


def test_infeasible_plan_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(ops, "MAX_RADIX_LEVELS", 1)
    monkeypatch.setattr(ops, "MAX_RADIX_FANOUT", 4)
    monkeypatch.setattr(ops, "LEAF_BUCKET_CAP", 256)
    keys = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="radix levels"):
        ops.sort_segment_fold(keys, torch.ones(8, 1), torch.zeros(4096, 1))


def _kernel_order(keys, vals, k, op, block_k, tile, window, group):
    """csrc/segment_reduce.cu's plan and order of operations on the CPU:
    segments are runs of tiles of one key block cut into windows of
    ``window`` tiles (a tile without a key in [0, K) joins the segment
    before it); each segment folds its pairs into its own table in layout
    order; a key block of one segment is that table, else ``group`` threads
    fold contiguous runs of its segments in order and a tree joins the runs
    left to right.  Sums in float64, max/min with JAX's rules."""
    from repro_torch import numerics
    if op == "add":
        comb, ident = (lambda a, b: a + b), 0.0
    else:
        f = numerics.maximum if op == "max" else numerics.minimum
        comb = lambda a, b: f(a, b)  # noqa: E731
        ident = float("-inf") if op == "max" else float("inf")
    dt = torch.float64 if op == "add" else torch.float32
    tk = torch.from_numpy(keys)
    tv = torch.from_numpy(vals).to(dt)
    n, d = vals.shape
    n_tiles = -(-n // tile)
    segs, prev = [], -1  # (first tile, block)
    for t in range(n_tiles):
        tile_keys = keys[t * tile:(t + 1) * tile]
        ok = tile_keys[(tile_keys >= 0) & (tile_keys < k)]
        eff = max(prev, int(ok[0]) // block_k if ok.size else -1)
        if eff >= 0 and (t % window == 0 or eff != prev):
            segs.append((t, eff))
        prev = eff
    tables = []
    for i, (t, b) in enumerate(segs):
        end = segs[i + 1][0] if i + 1 < len(segs) else n_tiles
        table = torch.full((block_k, d), ident, dtype=dt)
        for j in range(t * tile, min(n, end * tile)):
            lk = int(tk[j]) - b * block_k
            if 0 <= tk[j] < k and 0 <= lk < block_k:
                table[lk] = comb(table[lk], tv[j])
        tables.append(table)
    out = torch.full((-(-k // block_k) * block_k, d), ident, dtype=dt)
    for b in sorted({b for _, b in segs}):
        mine = [tables[i] for i, (_, sb) in enumerate(segs) if sb == b]
        if len(mine) == 1:
            r = mine[0]
        else:
            run = -(-len(mine) // group)
            parts = []
            for g in range(group):
                acc = torch.full((block_k, d), ident, dtype=dt)
                for tab in mine[g * run:(g + 1) * run]:
                    acc = comb(acc, tab)
                parts.append(acc)
            off = 1
            while off < group:
                for g in range(0, group, 2 * off):
                    parts[g] = comb(parts[g], parts[g + off])
                off *= 2
            r = parts[0]
        out[b * block_k:(b + 1) * block_k] = r
    return out[:k].to(torch.float32).numpy()


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("layout,window,group", [
    ("radix", 1, 1), ("radix", 3, 4), ("sorted", 2, 2), ("sorted", 5, 8)])
def test_segment_plan_and_merge_order_is_the_same_function(op, layout,
                                                           window, group):
    """The kernel's segment plan and fold order on the CPU equal the plain
    version and the Pallas kernel: every pair folded once, key blocks split
    over several segments merged in order."""
    rng = np.random.default_rng(window * 10 + group)
    n, d, k, bs, pa = 400, 2, 200, 32, 16
    keys = rng.integers(0, k + 3, size=n).astype(np.int32)
    vals = _values(rng, (n, d), op != "add")
    if layout == "radix":
        pk, pv, _ = ops.radix_partition(torch.from_numpy(keys),
                                        torch.from_numpy(vals), k,
                                        bucket_size=bs, pad_align=pa)
        keys, vals = pk.numpy(), pv.numpy()
    else:
        order = np.argsort(keys, kind="stable")
        keys, vals = keys[order], vals[order]
        bs = ops.tile_block_k(torch.from_numpy(keys), k, pa)
    got = _kernel_order(keys, vals, k, op, bs, pa, window, group)
    _assert_reduced(got, _port(keys, vals, k, op, tile_n=pa, block_k=bs),
                    keys, vals, k, op)
    # the Pallas kernel takes the radix layout's block; on a sorted stream
    # it derives its own
    kw = {"block_k": bs} if layout == "radix" else {}
    pallas = jops.segment_reduce(jnp.asarray(keys), jnp.asarray(vals), k, op,
                                 tile_n=pa, interpret=True, **kw)
    _assert_reduced(got, pallas, keys, vals, k, op)

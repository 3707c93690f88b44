"""Public wrappers of the port's kernels.

Counterpart of ``repro/kernels/ops.py``.  Each wrapper validates its inputs,
returns early on an empty chunk, sizes the launch, and then takes one of
two paths chosen by where the tensors lie: CUDA tensors launch the
hand-written kernel (or raise), CPU tensors take the kernel's plain PyTorch
version.  There is no fallback from one to the other.  Either path runs
through ``roofline.op_trace.kernel``: while a trace is active the call is
one op ``repro_torch::<kernel>`` of its tensors, the same on both paths.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch import numerics
from repro_torch.kernels import _build
from repro_torch.kernels import combine_scatter as _cs
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import int_fold as _if
from repro_torch.kernels import onehot_combine as _oc
from repro_torch.kernels import radix_partition as _rp
from repro_torch.kernels import segment_reduce as _sr
from repro_torch.roofline import op_trace as _trace

#: shared memory one block may use on an H100 (227 KB of the SM's 256 KB),
#: the shared memory of one SM, and what the runtime keeps per block
SMEM_PER_BLOCK = 232448
SMEM_PER_SM = 233472
SMEM_BLOCK_RESERVE = 1024
#: streaming multiprocessors of an H100 SXM
SM_COUNT = 132

#: The fold kernels' plan (csrc/fold_table.cuh, lane_fold.cuh and
#: keyed_fold.cuh hold the same numbers): a block folds its segment's pairs
#: into a [block_k, cols] f32 table of at most FOLD_TABLE_FLOATS floats and
#: FOLD_MAX_COLS columns, streaming them through FOLD_RING stages.  Three
#: block shapes (FOLD_SHAPES; the kernels take the index):
#:   ballot  one warp, when FOLD_BALLOT_FIT such blocks fit on an SM beside
#:           their tables (their launch bounds ask for FOLD_BALLOT_BLOCKS);
#:           stages of FOLD_BALLOT_STAGE pairs;
#:   bucket  eight warps (FOLD_BUCKET_WARPS) that bucket each stage by
#:           owner, FOLD_BUCKET_BLOCKS an SM (one past that); stages of up
#:           to FOLD_MAX_STAGE pairs;
#:   lane    sums only, up to FOLD_LANE_MAX_KEYS keys: one warp a column
#:           (at most FOLD_LANE_MAX_WARPS a block), each lane with its own
#:           copy of the column; whole rows wherever a block fits, column
#:           tiles where they leave FOLD_LANE_MIN_WARPS warps an SM; runs
#:           of FOLD_LANE_STAGE pairs; the launch bounds hold an SM to
#:           FOLD_LANE_SM_WARPS warps (64 registers a thread).
#: Ballot and bucket fold each key's pairs in index order, which max and
#: min need; the lane shape sums in a fixed order of its own.  The dynamic
#: shared memory of a block stays 256 bytes below SMEM_PER_BLOCK, for its
#: static shared memory.
FOLD_SHAPES = ("ballot", "bucket", "lane")
FOLD_TABLE_FLOATS = 32768
FOLD_MAX_COLS = 64
FOLD_RING = 3
FOLD_BALLOT_STAGE = 256
FOLD_MAX_STAGE = 1024
FOLD_BUCKET_WARPS = 8
FOLD_SMEM = SMEM_PER_BLOCK - 256
FOLD_BALLOT_FIT = 8
FOLD_BALLOT_BLOCKS = 16
FOLD_BUCKET_BLOCKS = 2
FOLD_LANE_STAGE = 256
FOLD_LANE_MAX_WARPS = 8
FOLD_LANE_MIN_WARPS = 8
FOLD_LANE_SM_WARPS = 32
FOLD_LANE_MAX_KEYS = 1024
#: largest segment-partials buffer [S, K, D] f32 the fold kernels allocate
FOLD_PARTIAL_ELEMS = 1 << 26
#: The partitioned route (csrc/keyed_fold.cuh launch_regions), for a table
#: of many key tiles: the chunk in sub-chunks, each partitioned stably by
#: key tile (radix_level.cuh, one pass while the key tiles fit its
#: MAX_PASS_BUCKETS digits) into regions that start at multiples of
#: FOLD_REGION_PAD slots, then each region folded by its own block, in
#: index order.  The plan takes it past one key tile where the tile route
#: would read each pair more than FOLD_PART_SCANS times.  Its scratch (the
#: layout and the partition's counts) comes out of memory the fold no
#: longer allocates: the tile route's segment partials, and for a fold in
#: place the [K, D] table too (so a fold out of place of a one-segment
#: tile plan, B6 and B7 at large K, keeps the tile route); a chunk whose layout
#: would pass that is folded in equal sub-chunks that fit, none shorter
#: than FOLD_PART_MIN_PAIRS pairs (else the tile route, whose launches
#: are fewer).  A region much longer than the mean (a hot key) is cut into
#: segments of at least FOLD_REGION_MIN_SEG slots, folded by blocks of
#: their own into partial tables and joined in order, where the scratch
#: leaves room for them.
#: FOLD_PART_SCANS from tools/fold_route_sweep.py on an NVIDIA H100 80GB
#: HBM3 at 700.00 W (B1 onto a [K, D] accumulator with counts, 2^22 uniform
#: pairs, CUDA graph, ms tile / partitioned, the tile plan's reads a pair
#: in brackets): K = 2^15 D = 2 0.202 / 0.325 [2], D = 4 0.388 / 0.484
#: [4]; 2^16 0.306 / 0.322 [4], 0.975 / 0.477 [8]; 2^17 0.824 / 0.270
#: [8], 1.543 / 0.504 [16]; 2^18 1.331 / 0.276 [16], 2.616 / 0.530 [32];
#: 2^20 4.115 / 0.293 [64], 6.775 / 0.548 [128]; 2.5M 10.888 / 0.359
#: [154], 18.670 / 0.810 [308].  The tile route wins up to 4 reads.
FOLD_PART_SCANS = 4
FOLD_REGION_PAD = 32
FOLD_REGION_MIN_SEG = 8192
FOLD_PART_MIN_PAIRS = 1 << 16
FOLD_ROUTES = ("tile", "partitioned")
#: keys of one block of the plain versions' one-hot contraction at most
#: (CPU tensors): the [N, block] one-hot stays small
FOLD_PLAIN_KEY_BLOCK = 256

launch_counts = _build.launch_counts
launch_counts_by_key = _build.launch_counts_by_key
reset_launch_counts = _build.reset_launch_counts


def _pow2_floor(x: int) -> int:
    return 1 << (max(int(x), 1).bit_length() - 1)


def _fold_cols(key_space: int, d: int) -> int:
    """Columns of a fold table: all D when the [K, D] table fits, else as
    many as leave the whole key space in one table, at least one (a key
    tile reads the whole chunk, so fewer key tiles beat wider ones)."""
    return max(1, min(d, FOLD_MAX_COLS, FOLD_TABLE_FLOATS // key_space))


def auto_key_block(key_space: int, d: int = 1) -> int:
    """Keys of one fold table (a key tile) at D columns: the whole key
    space when its table fits :data:`FOLD_TABLE_FLOATS`."""
    return min(key_space, FOLD_TABLE_FLOATS // _fold_cols(key_space, d))


def fold_smem_bytes(shape: str, block_k: int, cols: int, stage: int) -> int:
    """Dynamic shared memory of a fold block of ``shape``: the table, the
    ring of keys and values and, for the bucket shape, the stage's owner
    list, its counts and a claim byte a key (csrc/fold_table.cuh
    smem_bytes); for the lane shape 32 copies of the table and a ring
    (csrc/lane_fold.cuh smem_bytes)."""
    if shape == "lane":
        return block_k * cols * 32 * 4 + FOLD_RING * stage * (1 + cols) * 4
    table = block_k * cols * 4
    ring = FOLD_RING * stage * (1 + cols) * 4
    if shape == "ballot":
        return table + ring
    return table + ring + stage * 4 + (stage + 32) * 4 + -(-block_k // 16) * 16


@dataclasses.dataclass(frozen=True)
class FoldPlan:
    """Launch sizes of the keyed-fold kernels (B1, B2, B6, B7) on one of
    :data:`FOLD_ROUTES`.

    The tile route: a grid of ``n_seg`` segments × key tiles of
    ``block_k`` keys × column tiles of ``cols`` columns, blocks of
    ``shape`` (one of :data:`FOLD_SHAPES`) of ``warps`` warps with
    ``smem`` bytes of dynamic shared memory streaming ``stage`` pairs a
    ring stage, ``per_sm`` blocks an SM.  A segment of the ballot and
    bucket shapes is a run of ``seg_len`` pairs; one of the lane shape is
    every ``n_seg``-th run of ``seg_len`` pairs (a stage), so that the
    blocks running at one time read neighbouring runs.  Several segments
    fold into a partials buffer ``[n_seg, K, D]`` that a second pass joins.

    The partitioned route: ``n_seg`` sub-chunks of ``seg_len`` pairs, each
    partitioned by ``part`` (a ``radix_partition.PartitionPlan`` of a
    whole sub-chunk) into one region a key tile, then a bucket block a
    segment and column tile folds it: a region longer than ``region_seg``
    slots is cut into segments of that length, at most ``extra`` beyond
    one a region, whose partial tables are joined in order (``region_seg``
    0: no region is cut).  ``scratch`` bytes hold a ticket a region and
    column tile, ``2 * extra`` partial ``[block_k, D]`` tables, the layout
    and the partition's counts."""

    shape: str
    block_k: int
    cols: int
    warps: int
    stage: int
    smem: int
    per_sm: int
    seg_len: int
    n_seg: int
    key_tiles: int
    col_tiles: int
    route: str = "tile"
    part: _rp.PartitionPlan | None = None
    scratch: int = 0
    region_seg: int = 0
    extra: int = 0

    @property
    def scans(self) -> int:
        """Times the fold reads each pair: once a key tile and column tile
        on the tile route; once a partition pass, then once a column tile,
        on the partitioned route."""
        if self.route == "partitioned":
            return len(self.part.passes) + self.col_tiles
        return self.key_tiles * self.col_tiles

    def launch_args(self) -> tuple[int, ...]:
        """The kernels' launch arguments after K (and op)."""
        return (FOLD_SHAPES.index(self.shape), self.block_k, self.cols,
                self.stage, self.warps, self.seg_len, self.n_seg)

    def route_args(self) -> tuple:
        """The launch arguments of the route: the partition's passes (a C
        array, None on the tile route), their count, the scratch's bytes,
        ``region_seg`` and ``extra``."""
        if self.route != "partitioned":
            return (None, 0, 0, 0, 0)
        return (self.part.c_fields, len(self.part.passes), self.scratch,
                self.region_seg, self.extra)


def _blocks_per_sm(smem: int) -> int:
    """Blocks an SM holds beside their dynamic shared memory."""
    return SMEM_PER_SM // (smem + SMEM_BLOCK_RESERVE)


def _segments(n, key_space, d, shape, blk, cols, warps, stage, smem,
              per_sm) -> FoldPlan:
    """The plan of one block shape: the pairs split into one wave of
    blocks over the card, no segment shorter than a stage, and a partials
    buffer within :data:`FOLD_PARTIAL_ELEMS`."""
    key_tiles = -(-key_space // blk)
    col_tiles = -(-d // cols)
    n_seg = -(-per_sm * SM_COUNT // (key_tiles * col_tiles))
    n_seg = max(1, min(n_seg, -(-n // stage),
                       FOLD_PARTIAL_ELEMS // (key_space * d)))
    seg_len = stage if shape == "lane" else -(-n // n_seg)
    if shape != "lane":
        n_seg = -(-n // seg_len)
    return FoldPlan(shape=shape, block_k=blk, cols=cols, warps=warps,
                    stage=stage, smem=smem, per_sm=per_sm, seg_len=seg_len,
                    n_seg=n_seg, key_tiles=key_tiles,
                    col_tiles=col_tiles)


def _bucket_block(blk: int, cols: int) -> tuple[int, int, int]:
    """``(stage, smem, per_sm)`` of a bucket block over a ``[blk, cols]``
    table: its stage leaves room for :data:`FOLD_BUCKET_BLOCKS` blocks an
    SM (one, for a table past that)."""
    table = blk * cols * 4
    per_pair = FOLD_RING * (1 + cols) * 4 + 8
    fixed = fold_smem_bytes("bucket", blk, cols, 0) - table
    room = min(FOLD_SMEM,
               SMEM_PER_SM // FOLD_BUCKET_BLOCKS - SMEM_BLOCK_RESERVE)
    stage = min(FOLD_MAX_STAGE, (room - table - fixed) // per_pair) & ~31
    if stage < 32:
        stage = min(FOLD_MAX_STAGE,
                    (FOLD_SMEM - table - fixed) // per_pair) & ~31
    smem = fold_smem_bytes("bucket", blk, cols, stage)
    return stage, smem, min(FOLD_BUCKET_BLOCKS, _blocks_per_sm(smem))


def table_plan(n: int, key_space: int, d: int,
               block_k: int | None = None) -> FoldPlan:
    """The index-order plan (ballot or bucket shape) of the tile route:
    the table takes :func:`auto_key_block` keys (at most ``block_k``) and
    :func:`_fold_cols` columns.  A table small enough that
    :data:`FOLD_BALLOT_FIT` one-warp blocks fit on an SM takes the ballot
    shape; else the bucket shape (:func:`_bucket_block`)."""
    cols = _fold_cols(key_space, d)
    blk = auto_key_block(key_space, d)
    if block_k is not None:
        blk = max(1, min(blk, int(block_k)))
    shape, stage = "ballot", FOLD_BALLOT_STAGE
    smem = fold_smem_bytes(shape, blk, cols, stage)
    per_sm = min(_blocks_per_sm(smem), FOLD_BALLOT_BLOCKS)
    if per_sm < FOLD_BALLOT_FIT:
        shape = "bucket"
        stage, smem, per_sm = _bucket_block(blk, cols)
    warps = FOLD_BUCKET_WARPS if shape == "bucket" else 1
    return _segments(n, key_space, d, shape, blk, cols, warps, stage, smem,
                     per_sm)


def lane_plan(n: int, key_space: int, d: int,
              block_k: int | None = None) -> FoldPlan | None:
    """The lane-table plan of a sum, whatever its warps an SM (None when
    not one block fits): key tiles of ``block_k`` keys (the whole key
    space by default) and whole rows, one warp a column, where they fit
    (D up to :data:`FOLD_LANE_MAX_WARPS`); else column tiles split evenly
    over the columns, the tile that leaves the most warps on an SM (the
    widest of equals)."""
    blk = key_space if block_k is None else max(1, min(key_space,
                                                         int(block_k)))

    def fit(cols):  # (blocks an SM, smem) of a tile of ``cols`` columns
        smem = fold_smem_bytes("lane", blk, cols, FOLD_LANE_STAGE)
        per_sm = min(_blocks_per_sm(smem), FOLD_LANE_SM_WARPS // cols)
        return (per_sm if smem <= FOLD_SMEM else 0), smem

    best = None
    if d <= FOLD_LANE_MAX_WARPS and fit(d)[0] >= 1:
        best = (*fit(d), d)
    else:
        for most in range(min(d, FOLD_LANE_MAX_WARPS), 0, -1):
            cols = -(-d // -(-d // most))  # column tiles of equal width
            per_sm, smem = fit(cols)
            if per_sm >= 1 and (best is None
                                or per_sm * cols > best[0] * best[2]):
                best = (per_sm, smem, cols)
    if best is None:
        return None
    per_sm, smem, cols = best
    return _segments(n, key_space, d, "lane", blk, cols, cols,
                     FOLD_LANE_STAGE, smem, per_sm)


def _align256(nbytes: int) -> int:
    return -(-nbytes // 256) * 256


def route_scratch_bytes(part: _rp.PartitionPlan, n: int, vd: int) -> int:
    """Scratch of one sub-chunk of the partitioned route, as
    csrc/keyed_fold.cuh launch_regions carves it: the layout's keys and
    its ``vd`` value columns, each from a 256-byte boundary, then the
    partition's own scratch (:func:`radix_partition.scratch_bytes`)."""
    return (_align256(part.slots * 4) + _align256(part.slots * vd * 4)
            + _rp.scratch_bytes(part, n, vd))


def partitioned_plan(n: int, key_space: int, d: int,
                     block_k: int | None = None, *, counts: bool,
                     budget: int) -> FoldPlan | None:
    """The partitioned route's plan of a fold of ``n`` pairs into a
    ``[K, D]`` table (``counts``: the last column counts the pairs, and a
    pair carries D - 1 value columns), or None where its sub-chunks would
    be shorter than :data:`FOLD_PART_MIN_PAIRS` pairs (a shorter chunk is
    folded whole or not at all).

    Key tiles: as many as one partition pass splits into
    (:data:`radix_partition.MAX_PASS_BUCKETS`), each of the fewest keys
    that gives, with whole rows where the table holds them (columns cut
    to fit, down to one; past that, tables of one column and more passes);
    at most ``block_k`` keys; a bucket block a segment and column tile
    (:func:`_bucket_block`), whose eight warps share the segment's pairs.
    Sub-chunks: the fewest equal ones whose layout, partition scratch
    (:func:`route_scratch_bytes`) and tickets stay within ``budget`` bytes
    (:func:`route_budget`).  What the budget leaves holds the
    partial tables of regions cut into segments: ``extra`` further
    segments (at most one wave of blocks), each region's segments
    ``region_seg`` slots, at least twice a region's mean and
    :data:`FOLD_REGION_MIN_SEG`, so that uniform keys cut no region."""
    vd = d - int(counts)
    blk = -(-key_space // _rp.MAX_PASS_BUCKETS)
    cols = max(1, min(d, FOLD_MAX_COLS, FOLD_TABLE_FLOATS // blk))
    blk = min(blk, FOLD_TABLE_FLOATS // cols)
    if block_k is not None:
        blk = max(1, min(blk, int(block_k)))
    stage, smem, per_sm = _bucket_block(blk, cols)
    passes = _rp.partition_passes(key_space, blk, _rp.MAX_PASS_BUCKETS)
    regions, col_tiles = -(-key_space // blk), -(-d // cols)
    tickets = _align256(regions * col_tiles * 4)
    floor = min(n, FOLD_PART_MIN_PAIRS)
    n_sub = max(1, -(-n * 4 * (1 + vd) // budget))
    while True:
        m = -(-n // n_sub)
        if m < floor:
            return None
        part = _rp.plan_passes(m, vd, key_space, passes, FOLD_REGION_PAD)
        scratch = tickets + route_scratch_bytes(part, m, vd)
        if scratch <= budget:
            break
        if m == floor:
            return None
        n_sub = -(-n // (m - 1))  # the next shorter sub-chunk
    table = blk * d * 4  # a partial table
    shortest = max(2 * -(-part.slots // regions), FOLD_REGION_MIN_SEG)
    extra = max(0, min((budget - scratch) // (2 * table),
                       part.slots // shortest, per_sm * SM_COUNT))
    return FoldPlan(shape="bucket", block_k=blk, cols=cols,
                    warps=FOLD_BUCKET_WARPS, stage=stage, smem=smem,
                    per_sm=per_sm, seg_len=m, n_seg=-(-n // m),
                    key_tiles=regions, col_tiles=col_tiles,
                    route="partitioned", part=part,
                    scratch=scratch + _align256(2 * extra * table),
                    region_seg=-(-part.slots // extra) if extra else 0,
                    extra=extra)


def tile_plan(n: int, key_space: int, d: int, op: str,
              block_k: int | None = None) -> FoldPlan:
    """The tile route's plan of one keyed fold of ``n`` pairs into a
    ``[K, D]`` table with ``op`` (add, max or min).

    A sum over at most :data:`FOLD_LANE_MAX_KEYS` keys takes
    :func:`lane_plan` where its tile holds whole rows, or, with column
    tiles, where it leaves :data:`FOLD_LANE_MIN_WARPS` warps on an SM;
    everything else, max and min always, takes :func:`table_plan`.
    ``block_k`` caps the keys of a key tile."""
    if n < 1 or key_space < 1 or d < 1:
        raise ValueError(f"fold_plan: n={n}, key_space={key_space} and "
                         f"d={d} must be positive")
    if op not in _sr.OPS:
        raise ValueError(f"fold_plan: op must be one of {sorted(_sr.OPS)}, "
                         f"got {op!r}")
    if op == "add" and key_space <= FOLD_LANE_MAX_KEYS:
        plan = lane_plan(n, key_space, d, block_k)
        if plan is not None and (plan.col_tiles == 1 or plan.per_sm
                                 * plan.warps >= FOLD_LANE_MIN_WARPS):
            return plan
    return table_plan(n, key_space, d, block_k)


@functools.lru_cache(maxsize=512)
def fold_plan(n: int, key_space: int, d: int, op: str,
              block_k: int | None = None, counts: bool = False,
              inplace: bool = False) -> FoldPlan:
    """Plan one keyed fold of ``n`` pairs into a ``[K, D]`` table with
    ``op`` (add, max or min); ``counts``: the table's last column counts
    the pairs (B1's fused accumulator), so a pair carries D - 1 value
    columns; ``inplace``: the fold writes its result into acc.

    The tile route's plan (:func:`tile_plan`), or, past one key tile where
    that plan would read each pair more than :data:`FOLD_PART_SCANS`
    times, the partitioned route (:func:`partitioned_plan`) when it has
    one, its scratch within :func:`route_budget`.  ``block_k`` caps the
    keys of a key tile.  Kept per shape: a chunk loop asks for the same
    plan every call."""
    plan = tile_plan(n, key_space, d, op, block_k)
    budget = route_budget(plan, key_space, d, inplace)
    if budget and plan.key_tiles > 1 and plan.scans > FOLD_PART_SCANS:
        route = partitioned_plan(n, key_space, d, block_k, counts=counts,
                                 budget=budget)
        if route is not None:
            return route
    return plan


def route_budget(tile: FoldPlan, key_space: int, d: int,
                 inplace: bool) -> int:
    """Bytes the partitioned route's scratch may take in place of the
    tile plan ``tile``: memory the fold no longer allocates.  That is the
    tile plan's segment partials, and, for a fold in place (which writes
    into acc), the fresh ``[K, D]`` f32 table too: the larger of the two.
    0 (no route) for a fold out of place of a one-segment tile plan."""
    table = key_space * d * 4
    partials = tile.n_seg * table if tile.n_seg > 1 else 0
    return max(table if inplace else 0, partials)


def _check(name, keys, values, acc, counts=False):
    """``counts``: acc has one column more than values (the counts)."""
    if values.ndim != 2:
        raise ValueError("values must be [N, D]")
    if keys.ndim != 1 or keys.shape[0] != values.shape[0]:
        raise ValueError(f"keys {tuple(keys.shape)} must be [N] with N == "
                         f"values.shape[0] == {values.shape[0]}")
    width = values.shape[1] + int(counts)
    if acc.ndim != 2 or acc.shape[1] != width:
        raise ValueError(f"acc shape {tuple(acc.shape)} != (K, {width})")
    devices = {keys.device, values.device, acc.device}
    if len(devices) != 1:
        raise ValueError(f"{name}: keys, values and acc lie on different "
                         f"devices {sorted(map(str, devices))}")


def _check_cuda(name, keys, values, acc):
    if keys.dtype != torch.int32:
        raise TypeError(f"{name}: keys must be int32, got {keys.dtype}")
    if values.dtype != torch.float32 or acc.dtype != torch.float32:
        raise TypeError(f"{name}: values and acc must be float32, got "
                        f"{values.dtype} and {acc.dtype}")
    for t, what in ((keys, "keys"), (values, "values"), (acc, "acc")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


def _fold_launch(name, n, key_space, d, op, block_k,
                 counts=False, inplace=False) -> FoldPlan:
    """The fold kernels' plan, within their launch limits: int32 sizes,
    and a grid CUDA can launch."""
    if n >= 2**31 or key_space * d >= 2**31:
        raise ValueError(f"{name}: sizes past 2^31 elements are not taken")
    plan = fold_plan(n, key_space, d, op, block_k, counts, inplace)
    if plan.key_tiles > 65535 or plan.col_tiles > 65535:
        raise ValueError(f"{name}: {plan.key_tiles} key tiles x "
                         f"{plan.col_tiles} column tiles is not a grid "
                         f"CUDA can launch; raise block_k")
    return plan


def _block(block_k, key_space):
    if block_k is None:
        return None
    if block_k < 1:
        raise ValueError(f"block_k must be positive, got {block_k}")
    return min(int(block_k), key_space)


def _plain_block(block_k, key_space):
    """The plain one-hot contraction's key block: ``block_k`` or the key
    space, at most :data:`FOLD_PLAIN_KEY_BLOCK`."""
    return min(block_k or key_space, FOLD_PLAIN_KEY_BLOCK)


def _check_inplace(name, acc, inplace):
    if inplace and (acc.dtype != torch.float32 or not acc.is_contiguous()):
        raise ValueError(f"{name}: a fold in place needs a contiguous "
                         f"float32 acc, got {acc.dtype}")


def onehot_fold(keys, values, acc, key_space=None, *, block_k=None,
                counts=False, inplace=False):
    """Streaming-chunk additive fold: ``acc + one_hot(keys)ᵀ @ values``.

    [N] int32 keys, [N, D] f32 values, [K, D] f32 acc -> [K, D] f32.  Keys
    outside ``[0, K)`` (the sentinel ``K`` among them) never land.  With
    ``counts`` acc is ``[K, D + 1]`` and its last column gains each key's
    pair count, folded in the kernel from the keys alone (the stream
    flow's fused accumulator); the plan is that of acc's width, so the
    value columns take the bits of a fold of ``[values, ones]``.
    ``block_k`` caps the keys of one table of the kernel, a key tile (CPU:
    the key block of the plain contraction, at most
    :data:`FOLD_PLAIN_KEY_BLOCK`); ``None`` sizes it (:func:`fold_plan`).
    ``inplace`` writes the result into acc (f32, contiguous) and returns
    acc, the same bits as a fresh table; the caller owns acc.  Signature
    matches the stream collector's ``fold_fn(keys, mat, acc)``."""
    _check("onehot_fold", keys, values, acc, counts)
    _check_inplace("onehot_fold", acc, inplace)
    if key_space is None:
        key_space = acc.shape[0]
    if acc.shape[0] != key_space:
        raise ValueError(f"acc shape {tuple(acc.shape)} != ({key_space}, "
                         f"{acc.shape[1]})")
    n, width = values.shape[0], acc.shape[1]
    if n == 0 or width == 0:  # empty chunk: nothing to fold
        return acc if inplace else acc.to(torch.float32)
    block_k = _block(block_k, key_space)
    extra = {"counts": True} if counts else {}  # the flags only when set
    if inplace:
        extra["inplace"] = True
    if keys.device.type == "cpu":
        return _trace.kernel("onehot_fold", _oc.onehot_fold_plain, keys,
                             values, acc,
                             block_k=_plain_block(block_k, key_space),
                             **extra)
    _check_cuda("onehot_fold", keys, values, acc)
    return _trace.kernel("onehot_fold", _oc.onehot_fold_cuda, keys, values,
                         acc, _fold_launch("onehot_fold", n, key_space,
                                           width, "add", block_k, counts,
                                           inplace),
                         **extra)


def chunk_monoid_fold(keys, values, acc, op="add", *, block_k=None,
                      inplace=False):
    """Streaming-chunk monoid fold of an UNSORTED pair tile into [K, D] acc.

    ``op`` is add, max or min; max/min follow JAX's NaN and signed-zero
    rules.  ``inplace`` writes the result into acc (f32, contiguous) and
    returns acc.  Signature matches the stream collector's
    ``monoid_fold_fn(keys, mat, acc, op)``; the key space is acc's rows."""
    _check("chunk_monoid_fold", keys, values, acc)
    _check_inplace("chunk_monoid_fold", acc, inplace)
    if op not in _sr.OPS:
        raise ValueError(f"op must be one of {sorted(_sr.OPS)}, got {op!r}")
    key_space = acc.shape[0]
    n, d = values.shape
    if n == 0 or d == 0:  # empty chunk: nothing to fold
        return acc if inplace else acc.to(torch.float32)
    block_k = _block(block_k, key_space)
    extra = {"inplace": True} if inplace else {}
    if keys.device.type == "cpu":
        return _trace.kernel(
            "chunk_monoid_fold", _sr.chunk_monoid_fold_plain, keys, values,
            acc, op, block_k=_plain_block(block_k, key_space), **extra)
    _check_cuda("chunk_monoid_fold", keys, values, acc)
    return _trace.kernel(
        "chunk_monoid_fold", _sr.chunk_monoid_fold_cuda, keys, values, acc,
        op, _fold_launch("chunk_monoid_fold", n, key_space, d, op, block_k,
                         inplace=inplace),
        **extra)


def int_fold(keys, rows, table, counts=None):
    """Exact integer keyed fold: ``table`` plus each key's sum of ``rows``.

    [N] int32 keys, [N, D] int32 or int64 rows (D = 0: counts only),
    [K, D] int64 table -> [K, D] int64, wrapping modulo 2^64 as
    ``index_add_`` does; with ``counts`` ([K] int32) the pair
    ``(table', counts + each key's pair count)``.  Keys outside ``[0, K)``
    (the sentinel ``K`` among them) never land.  The outputs are fresh
    tensors: the inputs are never written.  The stream flow's integer
    additive holders and every pair count of the port take it."""
    if rows.ndim != 2 or keys.ndim != 1 or keys.shape[0] != rows.shape[0]:
        raise ValueError(f"int_fold: keys {tuple(keys.shape)} must be [N] and "
                         f"rows {tuple(rows.shape)} [N, D]")
    if table.ndim != 2 or table.shape[1] != rows.shape[1]:
        raise ValueError(f"int_fold: table shape {tuple(table.shape)} != "
                         f"(K, {rows.shape[1]})")
    k = table.shape[0]
    if counts is not None and tuple(counts.shape) != (k,):
        raise ValueError(f"int_fold: counts shape {tuple(counts.shape)} != "
                         f"({k},)")
    tensors = (keys, rows, table) + (() if counts is None else (counts,))
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"int_fold: inputs lie on different devices "
                         f"{sorted(map(str, devices))}")
    if (keys.dtype != torch.int32
            or rows.dtype not in (torch.int32, torch.int64)
            or table.dtype != torch.int64
            or (counts is not None and counts.dtype != torch.int32)):
        raise TypeError(f"int_fold: keys int32, rows int32 or int64, table "
                        f"int64 and counts int32, got {keys.dtype}, "
                        f"{rows.dtype}, {table.dtype}, "
                        f"{None if counts is None else counts.dtype}")
    if keys.shape[0] == 0:  # empty chunk: nothing to fold
        return (table.clone() if counts is None
                else (table.clone(), counts.clone()))
    if keys.device.type == "cpu":
        return _trace.kernel("int_fold", _if.int_fold_plain, keys, rows,
                             table, counts)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("int_fold: keys, rows, table and counts must be "
                         "contiguous")
    if keys.shape[0] > MAX_INDEX or k > MAX_INDEX:
        raise ValueError("int_fold: sizes past 2^31 - 1 pairs or keys are "
                         "not taken")
    return _trace.kernel("int_fold", _if.int_fold_cuda, keys, rows, table,
                         counts)


# ---------------------------------------------------------------------------
# Sort flow: radix partition + segment reduce
# ---------------------------------------------------------------------------

#: bytes of the ``[leaf, D]`` f32 table one block of the segment_reduce
#: kernel keeps in shared memory (csrc/segment_reduce.cu kTableFloats * 4):
#: the leaf bucket shrinks until its table fits.  It takes the place of the
#: reference's VMEM budget rule.
SEGMENT_TABLE_BYTES = 128 * 1024

#: buckets one pass of the partition kernel splits a parent into at most
#: (csrc/radix_level.cuh kMaxBuckets; radix_partition.MAX_PASS_BUCKETS):
#: a partition, of one level or a hierarchy, whose leaves pass it runs as
#: several passes
KERNEL_MAX_LEVEL_BUCKETS = _rp.MAX_PASS_BUCKETS

#: the kernels index slots with int32: a partition's output, and a table's
#: elements, stay below 2^31
MAX_INDEX = 2**31 - 1

#: per-level fan-out cap of the hierarchical radix partition; one level
#: covers key_space <= fan-out·leaf (the reference's value)
MAX_RADIX_FANOUT = 32

#: level budget of the hierarchical partition: 3 levels × fan-out 32 × a
#: 16k leaf covers K = 512M.  A key space past it has no kernel plan; the
#: sort flow then raises when asked for its kernels (the reference warns and
#: runs its plain fold instead).
MAX_RADIX_LEVELS = 3

#: leaf bucket cap (the reference's value): past it the hierarchy adds a
#: level instead of growing the leaf
LEAF_BUCKET_CAP = 16384


def _table_fits(leaf: int, d: int, table_bytes: int) -> bool:
    return leaf * max(d, 1) * 4 <= table_bytes


def auto_bucket_size(key_space: int, *, d: int = 1, pad_align: int = 256,
                     table_bytes: int | None = None) -> int:
    """Radix bucket width for a one-level partition: a few thousand keys at
    least (a bucket far below ``pad_align`` drowns in padding), shrunk until
    its ``[bucket, D]`` table fits :data:`SEGMENT_TABLE_BYTES`;
    ``key_space`` itself when one bucket covers it."""
    table_bytes = SEGMENT_TABLE_BYTES if table_bytes is None else table_bytes
    blk = _pow2_floor(max(key_space // 64, 8 * pad_align))
    while blk > 8 and not _table_fits(blk, d, table_bytes):
        blk //= 2
    return key_space if blk >= key_space else blk


@dataclasses.dataclass(frozen=True)
class RadixPlan:
    """Level decomposition of the sort flow's radix partition.

    ``fanouts == ()`` means one bucket (no partition needed);
    ``len(fanouts) == 1`` is the one-level partition (``radix_partition``);
    more entries run the hierarchy (``radix_partition_multi``).
    ``feasible == False`` marks a key space that needs more than the level
    budget; ``reason`` says why.
    """

    bucket_size: int
    fanouts: tuple[int, ...]
    key_space: int
    feasible: bool = True
    reason: str = ""

    @property
    def levels(self) -> int:
        return len(self.fanouts)

    @property
    def num_leaves(self) -> int:
        return -(-self.key_space // self.bucket_size)

    def describe(self) -> str:
        if not self.feasible:
            return f"INFEASIBLE ({self.reason})"
        if not self.fanouts:
            return "buckets=1 (single full segment reduce)"
        fan = "·".join(str(b) for b in self.fanouts)
        return (f"buckets={self.num_leaves}×{self.bucket_size}keys "
                f"levels={self.levels}({fan})")


def plan_radix_levels(key_space: int, *, d: int = 1, pad_align: int = 256,
                      max_fanout: int | None = None,
                      max_levels: int | None = None,
                      leaf_cap: int | None = None,
                      table_bytes: int | None = None) -> RadixPlan:
    """Pick the leaf bucket and the per-level fan-outs for a key space.

    The leaf is the segment_reduce block: ``key_space // max_fanout`` keys
    (at least ``8·pad_align``), at most ``leaf_cap``, halved until its
    ``[leaf, D]`` table fits ``table_bytes``.  The leaf count is split into
    the fewest levels whose power-of-two fan-outs stay within
    ``max_fanout``; more than ``max_levels`` levels is infeasible.  The
    knobs default to the module constants at call time."""
    max_fanout = MAX_RADIX_FANOUT if max_fanout is None else max_fanout
    max_levels = MAX_RADIX_LEVELS if max_levels is None else max_levels
    leaf_cap = LEAF_BUCKET_CAP if leaf_cap is None else leaf_cap
    table_bytes = SEGMENT_TABLE_BYTES if table_bytes is None else table_bytes
    leaf = _pow2_floor(max(key_space // max_fanout, 8 * pad_align))
    leaf = min(leaf, _pow2_floor(leaf_cap))
    while leaf > 8 and not _table_fits(leaf, d, table_bytes):
        leaf //= 2
    if leaf >= key_space:
        return RadixPlan(key_space, (), key_space)
    num_leaves = -(-key_space // leaf)
    # fan-outs are powers of two, so the cap that binds is the pow2 floor
    # of max_fanout
    fan_bits = max(max_fanout.bit_length() - 1, 1)
    bits = max(num_leaves - 1, 1).bit_length()
    levels = -(-bits // fan_bits)
    if levels > max_levels:
        return RadixPlan(
            leaf, (), key_space, feasible=False,
            reason=f"key_space={key_space} needs {levels} radix levels at "
                   f"fan-out {1 << fan_bits} (leaf bucket {leaf}), over "
                   f"the max_levels={max_levels} budget")
    base, extra = divmod(bits, levels)
    fanouts = tuple(1 << (base + (1 if i < extra else 0))
                    for i in range(levels))
    return RadixPlan(leaf, fanouts, key_space)


def _check_pairs(name, keys, values):
    if values.ndim != 2:
        raise ValueError("values must be [N, D]")
    if keys.ndim != 1 or keys.shape[0] != values.shape[0]:
        raise ValueError(f"keys {tuple(keys.shape)} must be [N] with N == "
                         f"values.shape[0] == {values.shape[0]}")
    if keys.device != values.device:
        raise ValueError(f"{name}: keys and values lie on different devices "
                         f"({keys.device}, {values.device})")


def _check_cuda_pairs(name, keys, values):
    if keys.dtype != torch.int32:
        raise TypeError(f"{name}: keys must be int32, got {keys.dtype}")
    if values.dtype != torch.float32:
        raise TypeError(f"{name}: values must be float32, got "
                        f"{values.dtype}")
    if not keys.is_contiguous() or not values.is_contiguous():
        raise ValueError(f"{name}: keys and values must be contiguous")


def radix_partition(keys, values, key_space, *, bucket_size=None,
                    fanouts=None, pad_align=256):
    """Radix partition of a pair chunk into padded LEAF bucket regions.

    [N] keys + [N, D] values -> ``(pkeys [Np], pvals [Np, D] f32,
    starts [B])``: leaf bucket ``b`` holds the keys in
    ``[b·bucket_size, (b+1)·bucket_size)`` at ``starts[b]`` in arrival
    order, each region a multiple of ``pad_align`` (sentinel-padded), then a
    trailing ``pad_align``-slot region — the layout :func:`segment_reduce`
    takes with ``block_k=bucket_size, tile_n=pad_align``.

    ``fanouts`` with two or more entries runs the hierarchy
    (``radix_partition_multi``, same layout); ``None`` or one entry the
    one-level partition.  Any ``pad_align`` works with either.  On the
    card both launch the plan's passes (``radix_partition.partition_plan``:
    the fewest passes of at most :data:`KERNEL_MAX_LEVEL_BUCKETS` buckets
    that reach the leaves)."""
    _check_pairs("radix_partition", keys, values)
    n, d = values.shape
    if bucket_size is None:
        bucket_size = auto_bucket_size(key_space, d=d, pad_align=pad_align)
    if bucket_size < 1 or pad_align < 1:
        raise ValueError(f"bucket_size={bucket_size} and pad_align="
                         f"{pad_align} must be positive")
    fanouts = tuple(fanouts or ())
    nb = -(-key_space // bucket_size)
    if len(fanouts) > 1:
        cover = bucket_size * math.prod(fanouts)
        if cover < key_space:
            raise ValueError(f"fanouts {fanouts} x bucket_size {bucket_size} "
                             f"cover {cover} < key_space {key_space}")
    np_ = _rp.partition_slots(n, nb, pad_align)
    # the launch counts as B4's when the caller asked for a hierarchy
    name = "radix_partition_multi" if len(fanouts) > 1 else "radix_partition"
    if keys.device.type == "cpu":
        if len(fanouts) > 1:
            return _trace.kernel(
                name, _rp.radix_partition_multi_plain, keys, values,
                key_space, bucket_size=bucket_size, fanouts=fanouts,
                pad_align=pad_align)
        return _trace.kernel(name, _rp.radix_partition_plain, keys, values,
                             key_space, bucket_size=bucket_size,
                             pad_align=pad_align)
    _check_cuda_pairs("radix_partition", keys, values)
    if np_ * max(d, 1) > MAX_INDEX or key_space >= MAX_INDEX:
        raise ValueError(f"radix_partition: {np_} slots x {d} columns pass "
                         f"the int32 index limit; shrink the chunk")
    if n == 0:  # empty chunk: the all-pad layout
        return (torch.full((np_,), key_space, dtype=torch.int32,
                           device=keys.device),
                torch.zeros((np_, d), dtype=torch.float32,
                            device=keys.device),
                torch.zeros((nb,), dtype=torch.int32, device=keys.device))
    plan = _rp.partition_plan(n, d, key_space, bucket_size, pad_align)
    return _trace.kernel(name, _rp.radix_partition_cuda, keys, values,
                         key_space, plan, pad_align=pad_align,
                         multi=len(fanouts) > 1)


def tile_block_k(keys: torch.Tensor, key_space: int, tile_n: int) -> int:
    """Smallest aligned key block that holds the keys in ``[0, K)`` of every
    ``tile_n``-pair tile of a key-sorted stream (at least 8, at most K):
    for a tile spanning keys lo..hi that is 2^bit_length(lo ^ hi).  Torch
    ops on the stream's own device, and one read of the result."""
    n = keys.shape[0]
    n_tiles = -(-n // tile_n)
    k = torch.full((n_tiles * tile_n,), -1, dtype=torch.int64,
                   device=keys.device)
    k[:n] = torch.where((keys >= 0) & (keys < key_space), keys, -1)
    tiles = k.view(n_tiles, tile_n)
    hi = tiles.amax(1)
    lo = torch.where(tiles >= 0, tiles, key_space).amin(1)
    span = torch.where(hi >= 0, lo ^ hi, 0)
    widest = int(span.max()) if span.numel() else 0
    return min(max(1 << widest.bit_length(), 8), key_space)


def segment_reduce(sorted_keys, sorted_values, key_space, op="add", *,
                   tile_n=256, block_k=None, acc=None):
    """Reduce a key-grouped stream to ``[K, D]`` f32 (absent keys get the
    identity; keys outside ``[0, K)`` are dropped); with ``acc`` the result
    is ``op(acc, chunk)``, in the kernel's last pass on the card.

    The stream is key-sorted, or the radix partition's layout: every
    ``tile_n``-pair tile keeps its keys inside one aligned ``block_k``
    block, and the tiles' blocks do not decrease.  ``block_k=None`` derives
    the block from the keys (:func:`tile_block_k`)."""
    _check_pairs("segment_reduce", sorted_keys, sorted_values)
    if op not in _sr.OPS:
        raise ValueError(f"op must be one of {sorted(_sr.OPS)}, got {op!r}")
    n, d = sorted_values.shape
    if acc is not None and tuple(acc.shape) != (key_space, d):
        raise ValueError(f"acc shape {tuple(acc.shape)} != ({key_space}, "
                         f"{d})")
    if n == 0 or d == 0:  # nothing to reduce
        if acc is not None:
            return acc.to(torch.float32)
        ident = {"add": 0.0, "max": float("-inf"), "min": float("inf")}[op]
        return torch.full((key_space, d), ident, dtype=torch.float32,
                          device=sorted_keys.device)
    if sorted_keys.device.type == "cpu":
        return _trace.kernel("segment_reduce", _segment_reduce_cpu,
                             sorted_keys, sorted_values, key_space, op, acc)
    _check_cuda_pairs("segment_reduce", sorted_keys, sorted_values)
    if acc is not None and (acc.dtype != torch.float32
                            or not acc.is_contiguous()):
        raise TypeError("segment_reduce: acc must be contiguous float32")
    if n >= MAX_INDEX or key_space * d >= MAX_INDEX:
        raise ValueError("segment_reduce: sizes past 2^31 elements are not "
                         "taken")
    if block_k is None:
        block_k = tile_block_k(sorted_keys, key_space, tile_n)
    if SEGMENT_TABLE_BYTES // 4 // block_k < 1:
        raise ValueError(f"segment_reduce: a block of {block_k} keys does "
                         f"not fit the kernel's {SEGMENT_TABLE_BYTES}-byte "
                         f"shared-memory table")
    return _trace.kernel("segment_reduce", _sr.segment_reduce_cuda,
                         sorted_keys, sorted_values, key_space, op,
                         block_k=block_k, tile=tile_n, acc=acc)


def _segment_reduce_cpu(sorted_keys, sorted_values, key_space, op, acc):
    """The plain segment_reduce, merged into ``acc`` when one is given."""
    chunk = _sr.segment_reduce_plain(sorted_keys, sorted_values, key_space,
                                     op)
    if acc is None:
        return chunk
    f = {"add": torch.add, "max": numerics.maximum,
         "min": numerics.minimum}[op]
    return f(acc.to(torch.float32), chunk)


def sort_segment_fold(keys, values, acc, op="add", *, bucket_size=None,
                      fanouts=None, pad_align=256):
    """Sort-flow chunk fold: radix partition + bucket-wise segment reduce,
    folded onto the carried ``[K, D]`` f32 accumulator.

    Signature matches the sort collector's ``sort_fold_fn(keys, mat, acc,
    op)``.  The partition puts every ``pad_align`` tile inside one aligned
    ``bucket_size`` block, so segment_reduce runs with
    ``block_k=bucket_size, tile_n=pad_align``, at any ``pad_align``.  On
    CUDA tensors that is ``radix_partition`` (one level) or
    ``radix_partition_multi`` (more), then ``segment_reduce`` with the
    merge in its last pass; nothing else.  ``bucket_size=None`` takes the
    :func:`plan_radix_levels` plan, and an infeasible one raises."""
    _check("sort_segment_fold", keys, values, acc)
    if op not in _sr.OPS:
        raise ValueError(f"op must be one of {sorted(_sr.OPS)}, got {op!r}")
    key_space = acc.shape[0]
    n, d = values.shape
    if n == 0 or d == 0:  # empty chunk: nothing to fold
        return acc.to(torch.float32)
    if bucket_size is None and fanouts is None:
        plan = plan_radix_levels(key_space, d=d, pad_align=pad_align)
        if not plan.feasible:
            raise ValueError(f"sort_segment_fold: {plan.reason}; no kernel "
                             f"plan for this key space")
        bucket_size, fanouts = plan.bucket_size, plan.fanouts
    elif bucket_size is None:
        bucket_size = auto_bucket_size(key_space, d=d, pad_align=pad_align)
    pkeys, pvals, _ = radix_partition(keys, values, key_space,
                                      bucket_size=bucket_size,
                                      fanouts=fanouts, pad_align=pad_align)
    return segment_reduce(pkeys, pvals, key_space, op, tile_n=pad_align,
                          block_k=bucket_size, acc=acc)


# ---------------------------------------------------------------------------
# Combine flow: whole pair buffers into fresh tables
# ---------------------------------------------------------------------------


def _combine_inputs(name, keys, values, key_space, block_k):
    """Checks shared by onehot_combine and combine_scatter; the values
    cast to f32 (bf16 values are taken, as in the reference) and the cap
    on a key tile."""
    _check_pairs(name, keys, values)
    if key_space < 1:
        raise ValueError(f"{name}: key_space must be positive, got "
                         f"{key_space}")
    return values.to(torch.float32), _block(block_k, key_space)


def _combine_cuda(name, keys, values, key_space, op, block_k) -> FoldPlan:
    """The CUDA path's checks and the fold kernels' plan."""
    _check_cuda_pairs(name, keys, values)
    n, d = values.shape
    return _fold_launch(name, n, key_space, d, op, block_k)


def onehot_combine(keys, values, key_space, *, block_k=None):
    """Additive combine of a whole pair buffer: ``one_hot(keys)ᵀ @ values``.

    [N] int32 keys, [N, D] float values -> [K, D] f32 per-key sums; keys
    outside ``[0, K)`` (the sentinel ``K`` among them) never land.  The
    combine flow's ``onehot_fn(keys, mat, K)``."""
    values, block_k = _combine_inputs("onehot_combine", keys, values,
                                      key_space, block_k)
    n, d = values.shape
    if n == 0 or d == 0:  # no pair: every sum is 0
        return torch.zeros((key_space, d), dtype=torch.float32,
                           device=values.device)
    if keys.device.type == "cpu":
        return _trace.kernel(
            "onehot_combine", _oc.onehot_combine_plain, keys, values,
            key_space, block_k=_plain_block(block_k, key_space))
    return _trace.kernel(
        "onehot_combine", _oc.onehot_combine_cuda, keys, values, key_space,
        _combine_cuda("onehot_combine", keys, values, key_space, "add",
                      block_k))


def combine_scatter(keys, values, key_space, op="add", *, block_k=None):
    """Monoid combine of a whole pair buffer into a fresh table:
    ``identity.at[keys].<op>(values)``.

    [N] int32 keys, [N, D] float values -> [K, D] f32; ``op`` is add, max
    or min (max/min follow JAX's NaN and signed-zero rules); keys outside
    ``[0, K)`` never land and absent keys keep the identity.  The combine
    flow's ``scatter_fn(keys, mat, K, op)``."""
    if op not in _sr.OPS:
        raise ValueError(f"op must be one of {sorted(_sr.OPS)}, got {op!r}")
    values, block_k = _combine_inputs("combine_scatter", keys, values,
                                      key_space, block_k)
    n, d = values.shape
    if n == 0 or d == 0:  # no pair: the identity table
        ident = {"add": 0.0, "max": float("-inf"), "min": float("inf")}[op]
        return torch.full((key_space, d), ident, dtype=torch.float32,
                          device=values.device)
    if keys.device.type == "cpu":
        return _trace.kernel("combine_scatter", _cs.combine_scatter_plain,
                             keys, values, key_space, op)
    return _trace.kernel("combine_scatter", _cs.combine_scatter_cuda, keys,
                         values, key_space, op,
                         _combine_cuda("combine_scatter", keys, values,
                                       key_space, op, block_k))


# ---------------------------------------------------------------------------
# Decode attention
# ---------------------------------------------------------------------------


def flash_decode(q, k, v, kv_len, *, tile_s=512):
    """Single-token GQA decode attention -> [B, H, D] f32.

    q [B, H, D], k and v [B, S, Hkv, D] (f32 or bf16, one dtype), kv_len
    [B] int32 valid lengths; head ``h`` attends KV head ``h // (H // Hkv)``
    over the positions below ``kv_len[b]``, with scale ``D^-0.5``.  A row
    with ``kv_len = 0`` gives zeros.  ``tile_s`` caps the positions one
    block of the kernel folds (the reference's KV tile); the plain version
    is unfused."""
    if q.ndim != 3 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_decode: q must be [B, H, D] and k, v "
                         f"[B, S, Hkv, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, D = q.shape
    _, S, Hkv, Dk = k.shape
    if k.shape[0] != B or Dk != D:
        raise ValueError(f"flash_decode: k {tuple(k.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if H % Hkv:
        raise ValueError("H must be a multiple of Hkv (GQA)")
    if tuple(kv_len.shape) != (B,):
        raise ValueError(f"flash_decode: kv_len must be [{B}], got "
                         f"{tuple(kv_len.shape)}")
    if tile_s < 1:
        raise ValueError(f"tile_s must be positive, got {tile_s}")
    devices = {q.device, k.device, v.device, kv_len.device}
    if len(devices) != 1:
        raise ValueError(f"flash_decode: inputs lie on different devices "
                         f"{sorted(map(str, devices))}")
    from torch._subclasses.fake_tensor import is_fake

    if is_fake(q):  # traced, not run: the kernel as one dispatcher op
        return _trace.kernel("flash_decode", _fd.traced_op(), q, k, v,
                             kv_len)
    if q.device.type == "cpu":
        return _trace.kernel("flash_decode", _fd.flash_decode_plain, q, k, v,
                             kv_len)
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_decode: q, k and v must share one dtype, "
                        f"float32 or bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if kv_len.dtype != torch.int32:
        raise TypeError(f"flash_decode: kv_len must be int32, got "
                        f"{kv_len.dtype}")
    for t, what in ((q, "q"), (k, "k"), (v, "v"), (kv_len, "kv_len")):
        if not t.is_contiguous():
            raise ValueError(f"flash_decode: {what} must be contiguous")
    G = H // Hkv
    item = q.element_size()
    if (D > _fd.MAX_HEAD_DIM or G > _fd.MAX_GROUP
            or G * D > _fd.MAX_GROUP_ELEMS or (D * item) % 16):
        raise ValueError(f"flash_decode: D={D}, G={G} passes the kernel's "
                         f"limits (D <= {_fd.MAX_HEAD_DIM}, G <= "
                         f"{_fd.MAX_GROUP}, G*D <= {_fd.MAX_GROUP_ELEMS}, "
                         f"rows of whole 16-byte vectors)")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_decode: q, k and v must be 16-byte aligned")
    if B > 65535 or Hkv > 65535 or k.numel() >= 2**62:
        raise ValueError("flash_decode: a grid CUDA cannot launch")
    tile, chunk, n_split = _fd.split_plan(B, H, Hkv, S, D, item, tile_s)
    return _trace.kernel("flash_decode", _fd.flash_decode_cuda, q, k, v,
                         kv_len, tile=tile, chunk=chunk, n_split=n_split)

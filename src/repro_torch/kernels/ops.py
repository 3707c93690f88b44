"""Public wrappers of the port's kernels.

Counterpart of ``repro/kernels/ops.py``.  Each wrapper validates its inputs,
returns early on an empty chunk, sizes the launch, and then takes one of
two paths chosen by where the tensors lie: CUDA tensors launch the
hand-written kernel (or raise), CPU tensors take the kernel's plain PyTorch
version.  There is no fallback from one to the other.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import numerics
from repro_torch.kernels import _build
from repro_torch.kernels import onehot_combine as _oc
from repro_torch.kernels import radix_partition as _rp
from repro_torch.kernels import segment_reduce as _sr

#: shared memory one block may use on an H100 (227 KB of the SM's 256 KB).
#: The fold kernels stage pairs in a slice of it, sized so that eight blocks
#: fit on one SM together.
SMEM_PER_BLOCK = 232448
FOLD_BLOCKS_PER_SM = 8
#: columns one fold thread carries in registers (csrc/keyed_fold.cuh kMaxCols)
FOLD_MAX_COLS = 8
#: keys (threads) per block of the fold kernels
FOLD_MAX_BLOCK_KEYS = 256
#: blocks the fold kernels aim to launch: several per SM of the 132
FOLD_TARGET_BLOCKS = 132 * 8
#: largest segment-partials buffer [S, K, D] f32 the fold kernels allocate
FOLD_PARTIAL_ELEMS = 1 << 26

launch_counts = _build.launch_counts
reset_launch_counts = _build.reset_launch_counts


def _pow2_floor(x: int) -> int:
    return 1 << (max(int(x), 1).bit_length() - 1)


def auto_key_block(key_space: int) -> int:
    """Keys per block of the fold kernels: one thread per key, a whole
    number of warps, at most :data:`FOLD_MAX_BLOCK_KEYS`."""
    return min(-(-key_space // 32) * 32, FOLD_MAX_BLOCK_KEYS)


def fold_tile_n(d: int) -> int:
    """Pairs a fold block stages in shared memory per step: its slice of
    :data:`SMEM_PER_BLOCK` over the bytes of one staged pair."""
    per_pair = 4 + 4 * min(d, FOLD_MAX_COLS)
    return _pow2_floor(SMEM_PER_BLOCK // FOLD_BLOCKS_PER_SM // per_pair)


def fold_segments(n: int, key_space: int, d: int, block_k: int
                  ) -> tuple[int, int]:
    """(segment length, segment count) of the fold kernels' pair axis:
    enough segments to fill the card, no segment shorter than one staged
    tile, and a partials buffer within :data:`FOLD_PARTIAL_ELEMS`."""
    other = -(-key_space // block_k) * -(-d // FOLD_MAX_COLS)
    n_seg = -(-FOLD_TARGET_BLOCKS // other)
    n_seg = min(n_seg, -(-n // fold_tile_n(d)),
                max(1, FOLD_PARTIAL_ELEMS // (key_space * d)))
    n_seg = max(n_seg, 1)
    seg_len = -(-n // n_seg)
    return seg_len, -(-n // seg_len)


def _check(name, keys, values, acc):
    if values.ndim != 2:
        raise ValueError("values must be [N, D]")
    if keys.ndim != 1 or keys.shape[0] != values.shape[0]:
        raise ValueError(f"keys {tuple(keys.shape)} must be [N] with N == "
                         f"values.shape[0] == {values.shape[0]}")
    if acc.ndim != 2 or acc.shape[1] != values.shape[1]:
        raise ValueError(f"acc shape {tuple(acc.shape)} != (K, "
                         f"{values.shape[1]})")
    devices = {keys.device, values.device, acc.device}
    if len(devices) != 1:
        raise ValueError(f"{name}: keys, values and acc lie on different "
                         f"devices {sorted(map(str, devices))}")


def _check_cuda(name, keys, values, acc, block_k):
    if keys.dtype != torch.int32:
        raise TypeError(f"{name}: keys must be int32, got {keys.dtype}")
    if values.dtype != torch.float32 or acc.dtype != torch.float32:
        raise TypeError(f"{name}: values and acc must be float32, got "
                        f"{values.dtype} and {acc.dtype}")
    for t, what in ((keys, "keys"), (values, "values"), (acc, "acc")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    n, d = values.shape
    if n >= 2**31 or acc.numel() >= 2**31:
        raise ValueError(f"{name}: sizes past 2^31 elements are not taken")
    if not 1 <= block_k <= 1024 or -(-acc.shape[0] // block_k) > 65535:
        raise ValueError(f"{name}: block_k={block_k} keys per block is not "
                         f"a launchable block for K={acc.shape[0]}")


def _block(block_k, key_space):
    if block_k is None:
        return auto_key_block(key_space)
    if block_k < 1:
        raise ValueError(f"block_k must be positive, got {block_k}")
    return min(int(block_k), key_space)


def onehot_fold(keys, values, acc, key_space=None, *, block_k=None):
    """Streaming-chunk additive fold: ``acc + one_hot(keys)ᵀ @ values``.

    [N] int32 keys, [N, D] f32 values, [K, D] f32 acc -> [K, D] f32.  Keys
    outside ``[0, K)`` (the sentinel ``K`` among them) never land.
    ``block_k`` is the number of keys one block of the kernel owns (CPU: the
    key block of the plain contraction); ``None`` sizes it.  Signature
    matches the stream collector's ``fold_fn(keys, mat, acc)``."""
    _check("onehot_fold", keys, values, acc)
    if key_space is None:
        key_space = acc.shape[0]
    if acc.shape[0] != key_space:
        raise ValueError(f"acc shape {tuple(acc.shape)} != ({key_space}, "
                         f"{values.shape[1]})")
    n, d = values.shape
    if n == 0 or d == 0:  # empty chunk: nothing to fold
        return acc.to(torch.float32)
    block_k = _block(block_k, key_space)
    if keys.device.type == "cpu":
        return _oc.onehot_fold_plain(keys, values, acc, block_k=block_k)
    _check_cuda("onehot_fold", keys, values, acc, block_k)
    seg_len, n_seg = fold_segments(n, key_space, d, block_k)
    return _oc.onehot_fold_cuda(keys, values, acc, block_k=block_k,
                                tile_n=fold_tile_n(d), seg_len=seg_len,
                                n_seg=n_seg)


def chunk_monoid_fold(keys, values, acc, op="add", *, block_k=None):
    """Streaming-chunk monoid fold of an UNSORTED pair tile into [K, D] acc.

    ``op`` is add, max or min; max/min follow JAX's NaN and signed-zero
    rules.  Signature matches the stream collector's
    ``monoid_fold_fn(keys, mat, acc, op)``; the key space is acc's rows."""
    _check("chunk_monoid_fold", keys, values, acc)
    if op not in _sr.OPS:
        raise ValueError(f"op must be one of {sorted(_sr.OPS)}, got {op!r}")
    key_space = acc.shape[0]
    n, d = values.shape
    if n == 0 or d == 0:  # empty chunk: nothing to fold
        return acc.to(torch.float32)
    block_k = _block(block_k, key_space)
    if keys.device.type == "cpu":
        return _sr.chunk_monoid_fold_plain(keys, values, acc, op,
                                           block_k=block_k)
    _check_cuda("chunk_monoid_fold", keys, values, acc, block_k)
    seg_len, n_seg = fold_segments(n, key_space, d, block_k)
    return _sr.chunk_monoid_fold_cuda(keys, values, acc, op, block_k=block_k,
                                      tile_n=fold_tile_n(d), seg_len=seg_len,
                                      n_seg=n_seg)


# ---------------------------------------------------------------------------
# Sort flow: radix partition + segment reduce
# ---------------------------------------------------------------------------

#: bytes of the ``[leaf, D]`` f32 table one block of the segment_reduce
#: kernel keeps in shared memory (csrc/segment_reduce.cu kTableFloats * 4):
#: the leaf bucket shrinks until its table fits.  It takes the place of the
#: reference's VMEM budget rule.
SEGMENT_TABLE_BYTES = 128 * 1024

#: buckets one level of the partition kernels splits into (the scatter's
#: per-warp cursors live in shared memory; csrc/radix_level.cuh kMaxFanout)
KERNEL_MAX_LEVEL_BUCKETS = 1024

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
    one-level partition.  Any ``pad_align`` works with either."""
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
    if keys.device.type == "cpu":
        if len(fanouts) > 1:
            return _rp.radix_partition_multi_plain(
                keys, values, key_space, bucket_size=bucket_size,
                fanouts=fanouts, pad_align=pad_align)
        return _rp.radix_partition_plain(keys, values, key_space,
                                         bucket_size=bucket_size,
                                         pad_align=pad_align)
    _check_cuda_pairs("radix_partition", keys, values)
    if np_ * max(d, 1) > MAX_INDEX or key_space >= MAX_INDEX:
        raise ValueError(f"radix_partition: {np_} slots x {d} columns pass "
                         f"the int32 index limit; shrink the chunk")
    if len(fanouts) > 1:
        top = -(-key_space // (bucket_size * math.prod(fanouts[1:])))
        widest = max(top, *fanouts[1:])
    else:
        widest = nb
    if widest > KERNEL_MAX_LEVEL_BUCKETS:
        raise ValueError(f"radix_partition: a level of {widest} buckets "
                         f"passes the kernels' {KERNEL_MAX_LEVEL_BUCKETS}; "
                         f"grow bucket_size or split the level (fanouts)")
    if n == 0:  # empty chunk: the all-pad layout
        return (torch.full((np_,), key_space, dtype=torch.int32,
                           device=keys.device),
                torch.zeros((np_, d), dtype=torch.float32,
                            device=keys.device),
                torch.zeros((nb,), dtype=torch.int32, device=keys.device))
    return _rp.radix_partition_cuda(keys, values, key_space,
                                    bucket_size=bucket_size, fanouts=fanouts,
                                    pad_align=pad_align)


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
        chunk = _sr.segment_reduce_plain(sorted_keys, sorted_values,
                                         key_space, op)
        if acc is None:
            return chunk
        f = {"add": torch.add, "max": numerics.maximum,
             "min": numerics.minimum}[op]
        return f(acc.to(torch.float32), chunk)
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
    return _sr.segment_reduce_cuda(sorted_keys, sorted_values, key_space, op,
                                   block_k=block_k, tile=tile_n, acc=acc)


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

"""``radix_partition`` / ``radix_partition_multi``: the sort flow's shuffle.

Counterpart of ``repro/kernels/radix_partition.py``.  A pair chunk is
partitioned by key into padded bucket regions: bucket ``b`` holds the keys
in ``[b·bucket_size, (b+1)·bucket_size)`` at ``starts[b]``, in arrival
order, its region a multiple of ``pad_align`` slots; pad slots and the
trailing ``pad_align``-slot region hold the key ``key_space`` and zero
values.  Keys of the last bucket at or past ``key_space`` keep their slots
and read ``key_space``; keys below 0 or past the last bucket are dropped.
The output has ``Np = N + B·pad_align + pad_align`` slots, rounded up to
``pad_align``.

``radix_partition_multi`` reaches the same leaf layout digit by digit over
``fanouts = (B1, …, BL)``: level ``l`` partitions by ``key // R_l`` with
``R_L = bucket_size`` and ``R_{l-1} = R_l·B_l``, each level a stable
partition of the one before.  Since every stable partition by a coarser
range keeps the order a finer one needs, any chain of ranges that ends at
``bucket_size`` gives the leaf layout.  The kernel therefore runs the
fewest passes the card takes (:func:`partition_passes`), planned from the
leaf count alone, for one level and for a hierarchy alike: the layout stays
the reference's and the data moves once per pass, not once per level.

The plain versions are PyTorch (a stable ``argsort`` of the bucket ids),
used for CPU tensors and as the kernels' oracle; the kernel is
``csrc/radix_partition.cu``, launched with a :func:`partition_plan`.  Call
it through :func:`repro_torch.kernels.ops.radix_partition`.
"""

from __future__ import annotations

import bisect
import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build

_INT32_MAX = 2**31 - 1

#: The kernels' plan (csrc/radix_level.cuh holds the same numbers): blocks
#: of PASS_THREADS threads (8 warps); a pass splits each parent into at most
#: MAX_PASS_BUCKETS buckets (ops.KERNEL_MAX_LEVEL_BUCKETS; past it one
#: pass took longer than two in `chip_smoke.py`'s radix_pass_sweep, PERF.md
#: §6); a tile is a multiple of PASS_THREADS pairs, at most MAX_TILE, sized
#: so that SCATTER_BLOCKS scatter blocks share an SM; the kernels refuse a
#: block's dynamic shared memory past SMEM_PER_BLOCK, 256 bytes below the
#: 227 KB an H100 block may use.
PASS_THREADS = 256
PASS_WARPS = PASS_THREADS // 32
MAX_PASS_BUCKETS = 256
MAX_TILE = 4096
SCATTER_BLOCKS = 4
SMEM_PER_BLOCK = 232448 - 256
SMEM_PER_SM = 233472
SMEM_RESERVE = 1024  # the runtime's share of a block


def partition_slots(n: int, num_buckets: int, pad_align: int) -> int:
    """Slots of a partition's output: the pairs, a pad per bucket and the
    trailing region, rounded up to ``pad_align``."""
    slots = n + num_buckets * pad_align + pad_align
    return slots + (-slots) % pad_align


def level_ranges(bucket_size: int, fanouts) -> list[int]:
    """``[R_1, …, R_L]`` of a hierarchy: ``R_L = bucket_size`` and
    ``R_{l-1} = R_l·B_l``."""
    ranges = [bucket_size]
    for b in reversed(tuple(fanouts)[1:]):
        ranges.insert(0, ranges[0] * b)
    return ranges


def _partition_level(keys, values, *, range_, num_buckets, pad_align,
                     n_slots, fill_key, clamp_key):
    """One stable partition by ``key // range_`` into padded regions."""
    k64 = keys.to(torch.int64)
    b = torch.div(k64, range_, rounding_mode="floor")
    valid = (k64 >= 0) & (b < num_buckets)
    bid = torch.where(valid, b, num_buckets)
    hist = torch.bincount(bid, minlength=num_buckets + 1)[:num_buckets]
    padded = (hist + pad_align - 1) // pad_align * pad_align
    starts = torch.cumsum(padded, 0) - padded
    order = torch.argsort(bid, stable=True)
    sb = bid[order]
    first = torch.cumsum(hist, 0) - hist  # sorted position of each bucket
    n_valid = int(hist.sum())
    sel = order[:n_valid]  # the valid pairs, bucket by bucket, stable
    sbv = sb[:n_valid]
    dst = starts[sbv] + torch.arange(n_valid, device=keys.device) - first[sbv]
    out_k = torch.full((n_slots,), fill_key, dtype=torch.int32,
                       device=keys.device)
    out_v = torch.zeros((n_slots, values.shape[1]), dtype=torch.float32,
                        device=keys.device)
    out_k[dst] = torch.clamp(keys[sel], max=clamp_key).to(torch.int32)
    out_v[dst] = values[sel].to(torch.float32)
    return out_k, out_v, starts.to(torch.int32)


def radix_partition_plain(keys: torch.Tensor, values: torch.Tensor,
                          key_space: int, *, bucket_size: int,
                          pad_align: int):
    """[N] keys + [N, D] values -> (pkeys [Np], pvals [Np, D], starts [B])."""
    nb = -(-key_space // bucket_size)
    return _partition_level(
        keys, values, range_=bucket_size, num_buckets=nb, pad_align=pad_align,
        n_slots=partition_slots(keys.shape[0], nb, pad_align),
        fill_key=key_space, clamp_key=key_space)


def radix_partition_multi_plain(keys: torch.Tensor, values: torch.Tensor,
                                key_space: int, *, bucket_size: int,
                                fanouts: tuple[int, ...], pad_align: int):
    """The hierarchy, level by level: each level a stable partition of the
    previous layout by ``key // R_l``, inner layouts padded with ``-1`` (a
    key no level takes).  Returns the leaf layout and ``starts`` of the
    ``ceil(key_space / bucket_size)`` leaves."""
    n = keys.shape[0]
    ranges = level_ranges(bucket_size, fanouts)
    pk, pv = keys, values
    starts = None
    for lvl, rng in enumerate(ranges):
        last = lvl == len(ranges) - 1
        nb = -(-key_space // rng)
        pk, pv, starts = _partition_level(
            pk, pv, range_=rng, num_buckets=nb, pad_align=pad_align,
            n_slots=partition_slots(n, nb, pad_align),
            fill_key=key_space if last else -1,
            clamp_key=key_space if last else _INT32_MAX)
    return pk, pv, starts


@dataclasses.dataclass(frozen=True)
class Pass:
    """A pass of the partition: bucket id ``key // range_``, split into
    ``fanout`` digits per parent (the first pass: into its buckets)."""

    range_: int
    fanout: int


def partition_passes(key_space: int, bucket_size: int,
                     max_buckets: int) -> tuple[Pass, ...]:
    """The fewest passes of at most ``max_buckets`` buckets a parent that
    reach the ``nb = ceil(key_space / bucket_size)`` leaves: one pass of
    ``nb`` buckets when they fit, else power-of-two fan-outs that split the
    bits of ``nb`` as evenly as they can, the odd bits to the passes at the
    top.  A hierarchy's fan-outs do not enter: every chain of ranges that
    ends at ``bucket_size`` gives its leaf layout."""
    nb = -(-key_space // bucket_size)
    if nb <= max_buckets:
        return (Pass(bucket_size, nb),)
    bits = (nb - 1).bit_length()
    levels = -(-bits // max(max_buckets.bit_length() - 1, 1))
    base, extra = divmod(bits, levels)
    passes, range_ = [], bucket_size
    for i in reversed(range(levels)):
        fanout = 1 << (base + (i < extra))
        passes.insert(0, Pass(range_, fanout))
        range_ *= fanout
    return tuple(passes)


def scatter_smem_bytes(tile: int, digits: int, d: int,
                       staged: bool = True) -> int:
    """Dynamic shared memory of a scatter block (csrc/radix_level.cuh
    scatter_smem): the tile's values when ``staged`` and its keys (16 bytes
    of slack each for their alignment), a meta word and a slot per pair,
    per-warp counts and five words a digit."""
    def a16(x):
        return -(-x // 16) * 16
    vals = a16((tile * d + 4) * 4) if staged else 0
    return (vals + a16((tile + 4) * 4) + tile * 8
            + (PASS_WARPS + 5) * digits * 4)


def pass_tile(d: int, digits: int) -> tuple[int, bool]:
    """``(tile, staged)`` of a pass: the largest multiple of
    :data:`PASS_THREADS` pairs up to :data:`MAX_TILE` whose scatter blocks
    fit :data:`SCATTER_BLOCKS` an SM with the tile's values staged in
    shared memory; when not even :data:`PASS_THREADS` pairs fit so (D past
    about 50), the values stay in device memory, where a pair's row is
    already a contiguous run, and the tile is sized on the keys alone."""
    budget = SMEM_PER_SM // SCATTER_BLOCKS - SMEM_RESERVE - 256
    for staged in (True, False):
        for tile in range(MAX_TILE, PASS_THREADS - 1, -PASS_THREADS):
            if scatter_smem_bytes(tile, digits, d, staged) <= budget:
                return tile, staged
    raise ValueError(f"radix_partition: {digits} digits a pass pass the "
                     f"kernels' shared memory")


@dataclasses.dataclass(frozen=True)
class PassLaunch:
    """One pass as the kernels launch it: ``buckets`` ids of ``key //
    range_``, ``digits`` per parent over ``parents`` parents, tiles of at
    most ``tile`` pairs in a grid of ``grid`` blocks (an inner pass's grid
    bounds its data-dependent tile count: ``ceil(n / tile) + parents``),
    the values ``staged`` in shared memory or not, and ``smem`` bytes of
    shared memory a scatter block."""

    range_: int
    digits: int
    buckets: int
    parents: int
    tile: int
    grid: int
    staged: bool
    smem: int


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """The launch of a partition of ``n`` pairs into ``slots`` slots."""

    passes: tuple[PassLaunch, ...]
    slots: int

    def launch_fields(self) -> list[int]:
        """The launch's seven ints a pass (csrc/radix_level.cuh
        read_passes)."""
        return [int(v) for p in self.passes for v in (
            p.range_, p.digits, p.buckets, p.parents, p.tile, p.grid,
            p.staged)]

    @functools.cached_property
    def c_fields(self):
        """:meth:`launch_fields` as the C array the launch takes."""
        fields = self.launch_fields()
        return (ctypes.c_int * len(fields))(*fields)


def plan_passes(n: int, d: int, key_space: int, passes,
                pad_align: int) -> PartitionPlan:
    """The launch of ``passes`` (:func:`partition_passes`, the last one's
    range the leaves' bucket size) over ``n >= 1`` pairs of ``d``
    columns: each pass's digits, parents, grid and tile (:func:`pass_tile`)."""
    launches, parents = [], 1
    for i, p in enumerate(passes):
        buckets = -(-key_space // p.range_)
        digits = buckets if i == 0 else p.fanout
        tile, staged = pass_tile(d, digits)
        grid = -(-n // tile) + (parents if i else 0)
        launches.append(PassLaunch(
            p.range_, digits, buckets, parents, tile, grid, staged,
            scatter_smem_bytes(tile, digits, d, staged)))
        parents = buckets
    return PartitionPlan(tuple(launches),
                         partition_slots(n, launches[-1].buckets, pad_align))


@functools.lru_cache(maxsize=256)
def partition_plan(n: int, d: int, key_space: int, bucket_size: int,
                   pad_align: int = 256) -> PartitionPlan:
    """The kernels' plan of a partition into ``bucket_size``-key leaves:
    :func:`partition_passes` at :data:`MAX_PASS_BUCKETS`, launched by
    :func:`plan_passes`.  Kept per shape: a chunk loop asks for the same
    plan every call."""
    return plan_passes(
        n, d, key_space,
        partition_passes(key_space, bucket_size, MAX_PASS_BUCKETS), pad_align)


def scratch_bytes(plan: PartitionPlan, n: int, d: int) -> int:
    """Bytes of the scratch the kernels carve for ``plan`` over ``n``
    pairs of ``d`` value columns (csrc/radix_level.cuh ``carve``; what
    ``radix_partition_scratch_bytes`` returns): the count matrix of the
    widest pass, a ticket, two sets of totals, starts and next-pass tile
    offsets, and one or two compact layouts between passes, each from a
    256-byte boundary."""
    def a(nbytes):
        return -(-max(nbytes, 4) // 256) * 256

    passes = plan.passes
    cells = max(p.digits * (p.grid + 1) for p in passes)
    width = max(p.buckets + 1 for p in passes)
    inner = n if len(passes) > 1 else 0
    bufs = min(len(passes) - 1, 2)
    sizes = ([cells * 4, 4] + [width * 4] * 6 + [inner * 4] * bufs
             + [inner * d * 4] * bufs)
    return sum(a(x) for x in sizes)


def pass_tiles(parent_starts, parent_counts, tile: int):
    """The tiles of a pass as the kernels cut them: parent ``p``'s pairs
    ``[starts[p], starts[p] + counts[p])`` in tiles of at most ``tile``
    pairs, parent by parent.  Returns ``(parent, lo, hi)`` a tile, tile
    ``t`` being block ``t``'s (``csrc/radix_level.cuh`` ``tile_of``)."""
    off = [0]
    for c in parent_counts:
        off.append(off[-1] + -(-int(c) // tile))
    tiles = []
    for t in range(off[-1]):
        p = bisect.bisect_right(off, t) - 1
        lo = int(parent_starts[p]) + (t - off[p]) * tile
        hi = min(int(parent_starts[p]) + int(parent_counts[p]), lo + tile)
        tiles.append((p, lo, hi))
    return tiles


def radix_partition_passes_plain(keys: torch.Tensor, values: torch.Tensor,
                                 key_space: int, *, passes, pad_align: int):
    """The partition pass by pass, as the kernels run it: each pass a
    stable partition of the previous layout by ``key // range_``; a pass
    before the last writes a compact layout (``pad_align`` 1, ``n`` slots,
    the rest keyed ``-1``, a key no pass takes).  Returns the last pass's
    layout and ``starts``."""
    n = keys.shape[0]
    pk, pv, starts = keys, values, None
    for i, p in enumerate(passes):
        last = i == len(passes) - 1
        nb = -(-key_space // p.range_)
        pk, pv, starts = _partition_level(
            pk, pv, range_=p.range_, num_buckets=nb,
            pad_align=pad_align if last else 1,
            n_slots=partition_slots(n, nb, pad_align) if last else n,
            fill_key=key_space if last else -1,
            clamp_key=key_space if last else _INT32_MAX)
    return pk, pv, starts


def radix_partition_cuda(keys: torch.Tensor, values: torch.Tensor,
                         key_space: int, plan: PartitionPlan, *,
                         pad_align: int, multi: bool):
    """Launch the plan's passes; the launch counts as B4's
    (``radix_partition_multi``) when the caller asked for a hierarchy
    (``multi``), else as B3's.  The wrapper in ``ops`` has checked the
    inputs."""
    lib = _build.library("radix_partition")
    n, d = values.shape
    arr = plan.c_fields
    n_passes = len(plan.passes)
    nbytes = lib.radix_partition_scratch_bytes(n, d, key_space, pad_align,
                                               arr, n_passes)
    if nbytes < 0:
        raise ValueError(f"radix_partition: the kernel refuses n={n}, d={d}, "
                         f"key_space={key_space}, pad_align={pad_align}, "
                         f"plan={plan}")
    dev = keys.device
    nb = plan.passes[-1].buckets
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    pkeys = torch.empty(plan.slots, dtype=torch.int32, device=dev)
    pvals = torch.empty((plan.slots, d), dtype=torch.float32, device=dev)
    starts = torch.empty(nb, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.radix_partition_launch(
        keys.data_ptr(), values.data_ptr(), n, d, key_space, pad_align, arr,
        n_passes, pkeys.data_ptr(), pvals.data_ptr(), starts.data_ptr(),
        scratch.data_ptr(), stream)
    _build.check("radix_partition", lib, err)
    _build.count_launch("radix_partition_multi" if multi
                        else "radix_partition")
    return pkeys, pvals, starts

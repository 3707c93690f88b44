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
partition of the one before.

The plain versions are PyTorch (a stable ``argsort`` of the bucket ids),
used for CPU tensors and as the kernels' oracle; the kernels are
``csrc/radix_partition.cu`` and ``csrc/radix_partition_multi.cu``.  Call
them through :func:`repro_torch.kernels.ops.radix_partition`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_INT32_MAX = 2**31 - 1


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


def radix_partition_cuda(keys: torch.Tensor, values: torch.Tensor,
                         key_space: int, *, bucket_size: int,
                         fanouts: tuple[int, ...] = (), pad_align: int):
    """Launch B3 (one level) or B4 (``len(fanouts) > 1``); the wrapper in
    ``ops`` has checked the inputs."""
    name = "radix_partition_multi" if len(fanouts) > 1 else "radix_partition"
    lib = _build.library(name)
    n, d = values.shape
    nb = -(-key_space // bucket_size)
    np_ = partition_slots(n, nb, pad_align)
    dev = keys.device
    if name == "radix_partition":
        shape_args = (n, d, key_space, bucket_size, pad_align)
        fan = None
    else:
        fan = (ctypes.c_int * len(fanouts))(*fanouts)
        shape_args = (n, d, key_space, bucket_size, fan, len(fanouts),
                      pad_align)
    nbytes = getattr(lib, f"{name}_scratch_bytes")(*shape_args)
    if nbytes < 0:
        raise ValueError(f"{name}: the kernel refuses n={n}, d={d}, "
                         f"key_space={key_space}, bucket_size={bucket_size}, "
                         f"fanouts={fanouts}, pad_align={pad_align}")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    pkeys = torch.empty(np_, dtype=torch.int32, device=dev)
    pvals = torch.empty((np_, d), dtype=torch.float32, device=dev)
    starts = torch.empty(nb, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if name == "radix_partition":
        err = lib.radix_partition_launch(
            keys.data_ptr(), values.data_ptr(), n, d, key_space, bucket_size,
            pad_align, pkeys.data_ptr(), pvals.data_ptr(), starts.data_ptr(),
            scratch.data_ptr(), stream)
    else:
        err = lib.radix_partition_multi_launch(
            keys.data_ptr(), values.data_ptr(), n, d, key_space, bucket_size,
            fan, len(fanouts), pad_align, pkeys.data_ptr(), pvals.data_ptr(),
            starts.data_ptr(), scratch.data_ptr(), stream)
    _build.check(name, lib, err)
    _build.count_launch(name)
    return pkeys, pvals, starts

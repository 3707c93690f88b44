"""Public wrappers of the port's kernels.

Counterpart of ``repro/kernels/ops.py``.  Each wrapper validates its inputs,
returns early on an empty chunk, sizes the launch, and then takes one of
two paths chosen by where the tensors lie: CUDA tensors launch the
hand-written kernel (or raise), CPU tensors take the kernel's plain PyTorch
version.  There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import onehot_combine as _oc
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

"""The shuffle wire layer: the one owner of the all-to-all's wire format.

Counterpart of ``repro/distributed/wire.py``, byte for byte: a
:class:`WireFormat` record (codec, capacity envelope, per-destination key
layout; resolved once by :func:`wire_format`) and three codecs that
encode the send buckets before the all-to-all and decode them after.

Codecs (``ShuffleOptions.wire``):

``raw``
    ``keys [S, B] int32`` and the values ``[S, B, ...]`` a destination.
``delta``
    Each key stored as its residual from the destination's range base,
    bit-packed at ``ceil(log2(span + n_hot + 1))`` bits; hot split keys
    and the pad sentinel take reserved symbols past the span.  Lossless:
    decode gives the raw buckets bit for bit.
``packed``
    ``delta`` keys, and every value leaf narrowed to int8: integer leaves
    cast (exact while the values fit [-128, 127], wrapping modulo 256
    otherwise, as in the reference), float leaves quantized per
    destination row (``compression.quant_int8``) with the row's f32 scale
    on the wire.  It can change bits, so it is an explicit opt-in.

The reference builds the buckets and the bit lane with dense ``jnp``
expansions (an ``[n, S]`` one-hot cumsum; every symbol expanded to ``w``
int32 bits).  Here the ranks come from one cumsum a destination, and the
bit lane is packed a byte at a time with int64 shifts; the encoded bytes
are the reference's.  :attr:`WireFormat.epoch` is the reference's
``zlib.crc32`` of the same ``repr``: numpy dtype names, Python ints and
tuples, so a partial checkpointed by either package is recognized by the
other.
"""

from __future__ import annotations

import dataclasses
import math
import zlib

import numpy as np
import torch
from torch.utils import _pytree as pytree

CODECS = ("raw", "delta", "packed")


def dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype, or of a dtype name
    (``torch.float32`` → ``"float32"``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    if isinstance(dtype, str):
        return dtype.replace("torch.", "")
    return np.dtype(dtype).name


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, dtype_name(name))


def _itemsize(name: str) -> int:
    return torch.empty((), dtype=_torch_dtype(name)).element_size()


def _is_float(name: str) -> bool:
    return _torch_dtype(name).is_floating_point


def shuffle_bucket_capacity(n_pairs: int, num_shards: int) -> int:
    """Default send capacity a destination: twice the uniform share.  A
    skewed key distribution can exceed it; the shuffle counts what falls
    past it and the engine reports the count."""
    return -(-2 * n_pairs // num_shards)


def resolve_capacity(n_pairs: int, num_shards: int, *,
                     capacity: int | None = None, plan=None) -> int:
    """Explicit capacity, else the skew plan's envelope, else twice the
    uniform share."""
    if capacity:
        return int(capacity)
    if plan is not None:
        return int(plan.capacity_for(n_pairs))
    return shuffle_bucket_capacity(n_pairs, num_shards)


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """Static description of one shuffle's wire layout (host-side ints and
    tuples only)."""

    codec: str
    num_shards: int
    #: per-destination bucket capacity B (slots, pairs)
    capacity: int
    key_space: int
    #: per-destination key-range base (one a destination)
    lo: tuple[int, ...]
    #: widest destination range: every non-hot residual is in [0, span)
    span: int
    #: hot split keys (reserved symbols past the span)
    hot_keys: tuple[int, ...] = ()
    #: ``skew.ShufflePlan.epoch`` of the routing plan (0: fixed width)
    plan_epoch: int = 0
    #: value-leaf layout: (numpy dtype name, elements a pair)
    value_leaves: tuple[tuple[str, int], ...] = (("int32", 1),)

    def __post_init__(self):
        if self.codec not in CODECS:
            raise ValueError(
                f"unknown wire codec {self.codec!r}; expected one of "
                f"{CODECS}")
        if len(self.lo) != self.num_shards:
            raise ValueError(
                f"need one range base per destination "
                f"({self.num_shards}), got {len(self.lo)}")

    @property
    def n_hot(self) -> int:
        return len(self.hot_keys)

    @property
    def n_symbols(self) -> int:
        """Residuals, one symbol a hot key, and the pad sentinel."""
        return self.span + self.n_hot + 1

    @property
    def delta_bits(self) -> int:
        """Bit width of one packed key symbol."""
        return max(1, math.ceil(math.log2(self.n_symbols)))

    @property
    def packed_row_bytes(self) -> int:
        """Bytes of one destination's bit-packed key lane."""
        return -(-self.capacity * self.delta_bits // 8)

    @property
    def epoch(self) -> int:
        """Content fingerprint of the layout (the reference's)."""
        return zlib.crc32(repr((
            self.codec, self.num_shards, self.capacity, self.key_space,
            self.lo, self.span, self.hot_keys, self.plan_epoch,
            self.value_leaves)).encode())


def _leaf_layout(value_avals) -> tuple[tuple[str, int], ...]:
    """(dtype name, elements a pair) of each value leaf: tensors, numpy
    arrays or anything with ``shape`` and ``dtype``, leading axis the
    pairs."""
    leaves = pytree.tree_leaves(
        value_avals, is_leaf=lambda x: hasattr(x, "shape")
        and hasattr(x, "dtype"))
    return tuple((dtype_name(l.dtype),
                  int(np.prod(tuple(l.shape)[1:], dtype=np.int64)))
                 for l in leaves)


def wire_format(*, key_space: int, num_shards: int, n_pairs: int,
                value_avals, codec: str = "raw",
                capacity: int | None = None, plan=None) -> WireFormat:
    """The wire layout of one shuffle: ``value_avals`` is one shard's value
    stream (or shape/dtype records of it), ``plan`` a
    ``skew.ShufflePlan`` (None: fixed-width ranges)."""
    S = int(num_shards)
    B = resolve_capacity(int(n_pairs), S, capacity=capacity, plan=plan)
    if plan is None:
        k_local = -(-int(key_space) // S)
        lo = tuple(d * k_local for d in range(S))
        span = k_local
        hot: tuple[int, ...] = ()
        plan_epoch = 0
    else:
        lo = tuple(int(b) for b in plan.boundaries[:-1])
        span = int(plan.width)
        hot = tuple(int(k) for k in plan.hot_keys)
        plan_epoch = int(plan.epoch)
    return WireFormat(codec=codec, num_shards=S, capacity=int(B),
                      key_space=int(key_space), lo=lo, span=span,
                      hot_keys=hot, plan_epoch=plan_epoch,
                      value_leaves=_leaf_layout(value_avals))


# ---------------------------------------------------------------------------
# Bucketize: pair stream -> per-destination send buckets
# ---------------------------------------------------------------------------


def destinations(fmt: WireFormat, keys: torch.Tensor, valid: torch.Tensor,
                 plan=None) -> torch.Tensor:
    """Each pair's destination shard (``S`` for an invalid pair): the range
    owner, or a hot key's occurrences round-robin over its split
    destinations from the owner on, in the source's own pair order."""
    S, K = fmt.num_shards, fmt.key_space
    dev = keys.device
    if plan is None:
        k_local = -(-K // S)
        tgt = torch.div(keys, k_local, rounding_mode="floor").to(torch.int32)
    else:
        tgt = torch.zeros_like(keys, dtype=torch.int32)
        if S > 1:
            cuts = torch.tensor(plan.boundaries[1:-1], dtype=torch.int32,
                                device=dev)
            tgt = torch.searchsorted(cuts, keys.contiguous(),
                                     right=True).to(torch.int32)
        for k, w in zip(plan.hot_keys, plan.hot_ways):
            hit = keys == k
            occ = torch.cumsum(hit.to(torch.int64), dim=0) - 1
            dest = (plan.hot_owner(k) + occ % w) % S
            tgt = torch.where(hit, dest.to(torch.int32), tgt)
    return torch.where(valid, tgt, S)


def bucketize(fmt: WireFormat, stream, plan=None):
    """Pack a shard's pair stream (a ``collector.PairStream``) into
    destination send buckets, in stream order within a bucket.

    Returns ``(send_keys [S, B] int32, send_vals [S, B, ...], overflow)``:
    empty slots hold the sentinel key ``K`` and zero values; ``overflow``
    (an int64 scalar tensor) counts the valid pairs past their
    destination's capacity, which are dropped.  ``plan`` must be the one
    ``fmt`` was resolved from."""
    K, S, B = fmt.key_space, fmt.num_shards, fmt.capacity
    plan_epoch = plan.epoch if plan is not None else 0
    if plan_epoch != fmt.plan_epoch:
        raise ValueError(
            f"shuffle plan (epoch {plan_epoch}) is not the one this "
            f"WireFormat was resolved from (epoch {fmt.plan_epoch})")
    keys = stream.keys
    valid = stream.valid
    tgt = destinations(fmt, keys, valid, plan)
    rank = torch.zeros_like(keys, dtype=torch.int64)
    for d in range(S):
        hit = tgt == d
        rank = torch.where(hit, torch.cumsum(hit.to(torch.int64), 0) - 1,
                           rank)
    ok = valid & (rank < B)
    overflow = (valid & (rank >= B)).sum()
    slot = torch.where(ok, tgt.to(torch.int64).clamp(max=S - 1) * B + rank,
                       S * B)
    send_keys = torch.full((S * B + 1,), K, dtype=torch.int32,
                           device=keys.device)
    send_keys[slot] = keys.to(torch.int32)
    send_keys = send_keys[:S * B].reshape(S, B)

    def scatter(v):
        out = torch.zeros((S * B + 1,) + tuple(v.shape[1:]), dtype=v.dtype,
                          device=v.device)
        out[slot] = v
        return out[:S * B].reshape((S, B) + tuple(v.shape[1:]))

    return send_keys, pytree.tree_map(scatter, stream.values), overflow


# ---------------------------------------------------------------------------
# The bit-packed key lane (delta / packed codecs)
# ---------------------------------------------------------------------------


def _pack_symbols(sym: torch.Tensor, w: int) -> torch.Tensor:
    """``[R, B]`` symbols below ``2**w`` -> ``[R, ceil(B*w/8)] uint8``, bits
    little-endian within and across bytes: symbol ``i``'s bit ``b`` is bit
    ``i*w + b`` of the row.  Each symbol, shifted to its bit offset in
    int64, spans at most ``ceil((w + 7) / 8)`` bytes; its bytes are added
    into place (no two symbols share a bit, so the sum is the OR)."""
    R, B = sym.shape
    P = -(-B * w // 8)
    span = -(-(w + 7) // 8)
    off = torch.arange(B, dtype=torch.int64, device=sym.device) * w
    shifted = sym.to(torch.int64) << (off % 8)
    base = (off // 8).expand(R, B)
    out = torch.zeros((R, P + span), dtype=torch.int64, device=sym.device)
    for k in range(span):
        out.scatter_add_(1, base + k, (shifted >> (8 * k)) & 0xFF)
    return out[:, :P].to(torch.uint8)


def _unpack_symbols(packed: torch.Tensor, capacity: int,
                    w: int) -> torch.Tensor:
    """Inverse of :func:`_pack_symbols`: ``[R, P] uint8`` ->
    ``[R, capacity] int32``."""
    R, P = packed.shape
    span = -(-(w + 7) // 8)
    padded = torch.zeros((R, P + span), dtype=torch.int64,
                         device=packed.device)
    padded[:, :P] = packed.to(torch.int64)
    off = torch.arange(capacity, dtype=torch.int64,
                       device=packed.device) * w
    base = (off // 8).expand(R, capacity)
    word = torch.zeros((R, capacity), dtype=torch.int64,
                       device=packed.device)
    for k in range(span):
        word |= torch.gather(padded, 1, base + k) << (8 * k)
    return ((word >> (off % 8)) & ((1 << w) - 1)).to(torch.int32)


def _symbols_of(fmt: WireFormat, send_keys: torch.Tensor) -> torch.Tensor:
    """Keys ``[S, B]`` -> bounded symbols: the residual from the
    destination's base, a hot key's index past the span, or the pad
    sentinel ``span + n_hot``."""
    lo = torch.tensor(fmt.lo, dtype=torch.int32,
                      device=send_keys.device)[:, None]
    sym = send_keys - lo
    for i, k in enumerate(fmt.hot_keys):
        sym = torch.where(send_keys == k, fmt.span + i, sym)
    return torch.where(send_keys >= fmt.key_space, fmt.span + fmt.n_hot,
                       sym).to(torch.int32)


def _keys_of(fmt: WireFormat, sym: torch.Tensor,
             dest_index: int) -> torch.Tensor:
    """Symbols ``[R, B]`` received by destination ``dest_index`` -> keys."""
    lo = int(fmt.lo[dest_index])
    tail = torch.tensor(fmt.hot_keys + (fmt.key_space,), dtype=torch.int32,
                        device=sym.device)
    hot_i = torch.clamp(sym - fmt.span, 0, fmt.n_hot).to(torch.int64)
    return torch.where(sym < fmt.span, lo + sym, tail[hot_i]).to(torch.int32)


# ---------------------------------------------------------------------------
# Codecs: encode (send side) / decode (receive side)
# ---------------------------------------------------------------------------


def encode(fmt: WireFormat, send_keys: torch.Tensor, send_vals) -> dict:
    """Send buckets -> the encoded tree that rides the all-to-all (every
    leaf keeps a leading destination axis of ``num_shards``)."""
    if fmt.codec == "raw":
        return {"keys": send_keys, "vals": send_vals}
    bits = _pack_symbols(_symbols_of(fmt, send_keys), fmt.delta_bits)
    if fmt.codec == "delta":
        return {"bits": bits, "vals": send_vals}
    from repro_torch.distributed import compression as comp

    leaves, treedef = pytree.tree_flatten(send_vals)
    out, scales = [], []
    for leaf in leaves:
        if leaf.is_floating_point():
            q, s = comp.quant_int8_rows(leaf)
            out.append(q)
            scales.append(s)
        elif leaf.element_size() > 1:
            out.append(leaf.to(torch.int8))
        else:
            out.append(leaf)
    # keys in sorted order: torch's pytree takes a dict's leaves in
    # insertion order, JAX's sorted, so both packages flatten alike
    enc = {"bits": bits}
    if scales:
        enc["scales"] = tuple(scales)
    enc["vals"] = pytree.tree_unflatten(out, treedef)
    return enc


def decode(fmt: WireFormat, enc: dict, dest_index: int):
    """Received rows (one source a row) -> ``(recv_keys [R, B] int32,
    recv_vals [R, B, ...])`` for destination ``dest_index``."""
    if fmt.codec == "raw":
        return enc["keys"], enc["vals"]
    sym = _unpack_symbols(enc["bits"], fmt.capacity, fmt.delta_bits)
    keys = _keys_of(fmt, sym, dest_index)
    if fmt.codec == "delta":
        return keys, enc["vals"]
    leaves, treedef = pytree.tree_flatten(enc["vals"])
    scales = list(enc.get("scales", ()))
    out = []
    for leaf, (dt, _) in zip(leaves, fmt.value_leaves):
        tdt = _torch_dtype(dt)
        if tdt.is_floating_point:
            s = scales.pop(0)
            # a half-precision leaf times the f32 scale is f32, as in the
            # reference
            out.append(leaf.to(tdt)
                       * s.reshape((-1,) + (1,) * (leaf.ndim - 1)))
        else:
            out.append(leaf.to(tdt))
    return keys, pytree.tree_unflatten(out, treedef)


# ---------------------------------------------------------------------------
# Byte accounting (cost model, roofline, chip_smoke.py)
# ---------------------------------------------------------------------------


def tree_nbytes(tree) -> int:
    """Total bytes of a tree of tensors or arrays."""
    return int(sum(int(np.prod(tuple(l.shape), dtype=np.int64))
                   * (l.element_size() if isinstance(l, torch.Tensor)
                      else np.dtype(l.dtype).itemsize)
                   for l in pytree.tree_leaves(tree)))


def encoded_nbytes(fmt: WireFormat) -> int:
    """Bytes of one source shard's encoded tree (all S buckets): equal to
    ``tree_nbytes(encode(...))`` leaf for leaf."""
    S, B = fmt.num_shards, fmt.capacity
    key_b = S * B * 4 if fmt.codec == "raw" else S * fmt.packed_row_bytes
    val_b = 0
    for dt, elems in fmt.value_leaves:
        itemsize = _itemsize(dt)
        if fmt.codec == "packed":
            per = 1 if itemsize > 1 else itemsize
            val_b += S * B * elems * per
            if _is_float(dt):
                val_b += S * 4  # the per-destination f32 scale
        else:
            val_b += S * B * elems * itemsize
    return key_b + val_b


def raw_nbytes(fmt: WireFormat) -> int:
    """Bytes of the same buckets under the ``raw`` codec."""
    return encoded_nbytes(dataclasses.replace(fmt, codec="raw"))


def wire_bytes_per_shard(fmt: WireFormat) -> float:
    """Bytes a shard sends to the other shards in the tiled all-to-all:
    ``(S - 1) / S`` of its encoded tree (it keeps its own bucket)."""
    S = fmt.num_shards
    if S <= 1:
        return 0.0
    return encoded_nbytes(fmt) * (S - 1) / S

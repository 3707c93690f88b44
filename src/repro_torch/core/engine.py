"""Execution engine of the stream and sort flows: the map phase and the
chunked fold.

Counterpart of the local part of ``repro/core/engine.py`` (``Emitter``,
``map_phase``, ``_fold_items_chunked``, ``stream_local_tables``,
``run_local_stream``, ``sort_local_tables``, ``run_local_sort``).  The
reference scans the chunks with ``lax.scan``; here the chunk loop is a
Python loop, so chunks are large (see ``autotune``) and each one is a
handful of launches.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import collector as col
from repro_torch.core import combiner as C


class Emitter:
    """Fixed-capacity recording emitter handed to ``map``.

    ``emit(keys, values, valid=None)`` takes scalars or 1-D vectors; the
    calls append into the item's pair buffer, which holds at most
    ``capacity`` pairs.  Invalid slots, and keys below 0 or above
    ``key_space``, carry the sentinel key ``key_space``.
    """

    def __init__(self, capacity: int, key_space: int, value_spec: C.ValueSpec,
                 device):
        self.capacity = capacity
        self.key_space = key_space
        self.value_spec = value_spec
        self.device = device
        self._keys: list[torch.Tensor] = []
        self._vals: list[torch.Tensor] = []
        self._used = 0

    def __call__(self, keys, values, valid=None):
        return self.emit(keys, values, valid)

    def _tensor(self, x, dtype):
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(x, device=self.device)
        return x.to(dtype)

    def emit(self, keys, values, valid=None):
        keys = self._tensor(keys, torch.int32)
        values = self._tensor(values, self.value_spec.dtype)
        if keys.ndim == 0:
            keys = keys.unsqueeze(0)
            values = values.unsqueeze(0)
        n = keys.shape[0]
        if valid is not None:
            valid = self._tensor(valid, torch.bool)
            if valid.ndim == 0:
                valid = valid.unsqueeze(0)
            keys = torch.where(valid, keys, self.key_space)
        if self._used + n > self.capacity:
            raise ValueError(
                f"map emitted more than emit_capacity={self.capacity} pairs")
        expected = (n,) + tuple(self.value_spec.shape)
        if tuple(values.shape) != expected:
            raise ValueError(f"emitted values shape {tuple(values.shape)} != "
                             f"{expected}")
        self._keys.append(keys)
        self._vals.append(values)
        self._used += n

    def pairs(self) -> tuple[torch.Tensor, torch.Tensor]:
        pad_n = self.capacity - self._used
        vshape = tuple(self.value_spec.shape)
        ks = self._keys + [torch.full((pad_n,), self.key_space,
                                      dtype=torch.int32, device=self.device)]
        vs = self._vals + [torch.zeros((pad_n,) + vshape,
                                       dtype=self.value_spec.dtype,
                                       device=self.device)]
        ks = torch.cat(ks)
        vs = torch.cat(vs)
        ks = torch.where((ks < 0) | (ks > self.key_space), self.key_space, ks)
        return ks, vs


def items_length(items) -> int:
    return pytree.tree_leaves(items)[0].shape[0]


def map_phase(app, items, device) -> col.PairStream:
    """The user map over every item (``torch.func.vmap``) -> flat pairs."""

    def one(item):
        em = Emitter(app.emit_capacity, app.key_space, app.value_spec, device)
        app.map(item, em)
        return em.pairs()

    keys, vals = torch.func.vmap(one)(items)
    # a map that emits the same key (or value) for every item gets it back
    # expanded with stride 0; the kernels take dense rows
    return col.PairStream(
        keys.reshape(-1).contiguous(),
        vals.reshape((-1,) + tuple(vals.shape[2:])).contiguous(),
        app.key_space)


def _fold_kernels(use_kernels: bool, key_block: int | None = None
                  ) -> tuple[Callable | None, Callable | None]:
    """(additive fold_fn, monoid_fold_fn) for the stream collector."""
    if not use_kernels:
        return None, None
    from repro_torch.kernels import ops

    return (partial(ops.onehot_fold, block_k=key_block),
            partial(ops.chunk_monoid_fold, block_k=key_block))


def stream_combiner(app, spec, *, device, use_kernels=False,
                    chunk_pairs: int | None = None,
                    key_block: int | None = None) -> col.StreamCombiner:
    fold_fn, monoid_fold_fn = _fold_kernels(use_kernels, key_block)
    return col.StreamCombiner(spec, app.key_space, app.value_spec,
                              device=device, fold_fn=fold_fn,
                              monoid_fold_fn=monoid_fold_fn,
                              chunk_pairs=chunk_pairs, key_block=key_block)


def fold_items_chunked(app, combiner, items, chunk_items: int,
                       n_valid: int | None = None, state=None):
    """Map ``items`` a chunk at a time and fold each chunk's pairs into the
    carried collector state (``state`` seeds it; default: the identity).
    ``combiner`` is the stream flow's :class:`~collector.StreamCombiner` or
    the sort flow's :class:`~collector.SortCombiner`.

    Items at index ``n_valid`` and beyond are mapped but their pairs are
    masked to the sentinel key, as in the reference's padded serving path.
    """
    n_items = items_length(items)
    if state is None:
        state = combiner.init_state()
    valid_items = n_items if n_valid is None else int(n_valid)
    cap = app.emit_capacity
    for lo in range(0, n_items, chunk_items):
        hi = min(lo + chunk_items, n_items)
        chunk = pytree.tree_map(lambda a: a[lo:hi], items)
        stream = map_phase(app, chunk, combiner.device)
        keys = stream.keys
        if hi > valid_items:
            item_ok = torch.arange(lo, hi, device=keys.device) < valid_items
            keys = torch.where(item_ok.repeat_interleave(cap), keys,
                               app.key_space)
        state = combiner.fold_chunk(
            state, col.PairStream(keys, stream.values, app.key_space))
    return state


def stream_local_tables(app, spec, items, *, chunk_pairs: int,
                        device, use_kernels: bool = False,
                        key_block: int | None = None,
                        n_valid: int | None = None):
    """Fused map+combine over ``items``: chunks of about ``chunk_pairs``
    emitted pairs fold straight into the carried holder tables, so the full
    ``N × emit_capacity`` pair buffer never exists.  Returns un-finalized
    ``(tables, counts)``."""
    n_items = items_length(items)
    cap = max(app.emit_capacity, 1)
    chunk_items = max(1, min(n_items, chunk_pairs // cap))
    sc = stream_combiner(app, spec, device=device, use_kernels=use_kernels,
                         chunk_pairs=chunk_items * cap, key_block=key_block)
    state = fold_items_chunked(app, sc, items, chunk_items, n_valid=n_valid)
    return sc.tables_counts(state)


def run_local_stream(app, spec, items, **kw):
    tables, counts = stream_local_tables(app, spec, items, **kw)
    grouped = col.finalize_tables(spec, tables, counts, app.key_space)
    return grouped.keys, grouped.values, grouped.counts


def _sort_fold_kernel(use_kernels: bool, bucket_size: int | None,
                      level_fanouts: tuple[int, ...] | None
                      ) -> Callable | None:
    """The radix partition + segment reduce pipeline for the sort
    collector, bound to its level plan."""
    if not use_kernels:
        return None
    from repro_torch.kernels import ops

    return partial(ops.sort_segment_fold, bucket_size=bucket_size,
                   fanouts=level_fanouts)


def _check_sort_kernel_plan(spec, key_space: int, value_spec,
                           use_kernels: bool, bucket_size: int | None,
                           level_fanouts: tuple[int, ...] | None):
    """Resolve the radix level plan of the kernel sort fold:
    ``(bucket_size, level_fanouts)``.

    A key space past the level budget has no kernel plan, and the fold
    raises with the plan's reason: asked for its kernels, the sort flow
    runs them or nothing (the reference warns and takes its plain fold)."""
    if not use_kernels or bucket_size is not None:
        return bucket_size, level_fanouts
    if not spec.kernel_monoid_ok(value_spec):
        return bucket_size, level_fanouts  # the kernels are not used
    from repro_torch.kernels import ops

    d, _ = spec.holder_width(value_spec)
    plan = ops.plan_radix_levels(key_space, d=d + 1)
    if not plan.feasible:
        raise ValueError(
            f"sort flow: {plan.reason}; the radix kernels cannot take this "
            f"key space (pass use_kernels=False for the plain sorted fold)")
    return plan.bucket_size, plan.fanouts


def sort_local_tables(app, spec, items, *, chunk_pairs: int, device,
                      use_kernels: bool = False,
                      bucket_size: int | None = None,
                      level_fanouts: tuple[int, ...] | None = None,
                      n_valid: int | None = None):
    """Sort flow over ``items``: the stream flow's chunk loop, each chunk
    partitioned by key and reduced a run (or a leaf bucket) at a time into
    the carried tables (:class:`collector.SortCombiner`).  Returns
    un-finalized ``(tables, counts)``."""
    n_items = items_length(items)
    cap = max(app.emit_capacity, 1)
    chunk_items = max(1, min(n_items, chunk_pairs // cap))
    bucket_size, level_fanouts = _check_sort_kernel_plan(
        spec, app.key_space, app.value_spec, use_kernels, bucket_size,
        level_fanouts)
    sc = col.SortCombiner(
        spec, app.key_space, app.value_spec, device=device,
        sort_fold_fn=_sort_fold_kernel(use_kernels, bucket_size,
                                       level_fanouts))
    state = fold_items_chunked(app, sc, items, chunk_items, n_valid=n_valid)
    return sc.tables_counts(state)


def run_local_sort(app, spec, items, **kw):
    tables, counts = sort_local_tables(app, spec, items, **kw)
    grouped = col.finalize_tables(spec, tables, counts, app.key_space)
    return grouped.keys, grouped.values, grouped.counts

"""Execution engine: the map phase, the stream and sort flows' chunked
fold, and the single-shot combine and reduce flows.

Counterpart of the local part of ``repro/core/engine.py`` (``Emitter``,
``map_phase``, ``_fold_items_chunked``, ``stream_local_tables``,
``sort_local_tables``, ``run_local``, ``build_stream_ingest``,
``merge_partial_tables``).  The reference scans the chunks
with ``lax.scan``; here the chunk loop is a Python loop, so chunks are
large (see ``autotune``) and each one is a handful of launches.  The
combine and reduce flows map every item at once and hand the whole pair
buffer to their collector.  :class:`LocalRun` is a flow prepared to
dispatch, what the staged API's ``compile()`` caches.
"""

from __future__ import annotations

import warnings
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


def valid_items(items, n_valid: int | None = None) -> int:
    """Items a run folds: the first ``n_valid`` (all when None)."""
    n_items = items_length(items)
    return n_items if n_valid is None else max(0, min(int(n_valid), n_items))


def chunk_items_of(app, n_items: int, chunk_pairs: int) -> int:
    """Items of one chunk: about ``chunk_pairs`` emitted pairs, at most
    the items the run folds."""
    cap = max(app.emit_capacity, 1)
    return max(1, min(n_items, chunk_pairs // cap))


def fold_items_chunked(app, combiner, items, chunk_items: int,
                       n_valid: int | None = None, state=None):
    """Map ``items`` a chunk at a time and fold each chunk's pairs into the
    carried collector state (``state`` seeds it; default: the identity).
    ``combiner`` is the stream flow's :class:`~collector.StreamCombiner` or
    the sort flow's :class:`~collector.SortCombiner`.

    Items at index ``n_valid`` and beyond are neither mapped nor folded:
    the reference maps a padded batch and masks its tail to the sentinel
    key (its executables have static shapes); the chunk loop here runs on
    the host and stops at ``n_valid``, so a padded call folds the pairs of
    the exact call, chunk for chunk.  A fold's sum order depends on the
    pairs a call sees (the lane tables' segments, ROADMAP C.26), so this
    is what keeps a padded run's bits those of the exact run.
    """
    n_items = valid_items(items, n_valid)
    if state is None:
        state = combiner.init_state()
    for lo in range(0, n_items, chunk_items):
        hi = min(lo + chunk_items, n_items)
        chunk = pytree.tree_map(lambda a: a[lo:hi], items)
        state = combiner.fold_chunk(state, map_phase(app, chunk,
                                                     combiner.device))
    return state


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


class LocalRun:
    """One flow of one plan on one device, prepared to dispatch: the knobs
    resolved, the sort flow's radix plan checked, and the stream or sort
    collector built once per chunk size (kept for later calls).  Calling it
    maps and folds ``items`` (the first ``n_valid`` of them) and returns
    fresh ``(keys, values, counts)`` tensors.

    ``plan`` (an ``ExecutionPlan``) is needed for the combine and reduce
    flows, whose runs record their lowering and fallbacks on it."""

    def __init__(self, app, flow: str, spec, *, device, plan=None,
                 combine_impl: str = "auto", use_kernels: bool = False,
                 chunk_pairs: int | None = None,
                 key_block: int | None = None,
                 bucket_size: int | None = None,
                 level_fanouts: tuple[int, ...] | None = None):
        if flow in ("stream", "sort") and chunk_pairs is None:
            raise ValueError(f"the {flow} flow needs chunk_pairs")
        if flow in ("combine", "reduce") and plan is None:
            raise ValueError(f"the {flow} flow needs its plan")
        self.app = app
        self.flow = flow
        self.spec = spec
        self.plan = plan
        self.device = torch.device(device)
        self.combine_impl = combine_impl
        self.use_kernels = use_kernels
        self.chunk_pairs = chunk_pairs
        self.key_block = key_block
        if flow == "sort":
            bucket_size, level_fanouts = _check_sort_kernel_plan(
                spec, app.key_space, app.value_spec, use_kernels,
                bucket_size, level_fanouts)
        self.bucket_size = bucket_size
        self.level_fanouts = level_fanouts
        self._combiners: dict[int, col.CarriedTables] = {}

    def combiner(self, chunk_items: int) -> col.CarriedTables:
        """The collector of chunks of ``chunk_items`` items."""
        comb = self._combiners.get(chunk_items)
        if comb is None:
            app = self.app
            if self.flow == "stream":
                comb = stream_combiner(
                    app, self.spec, device=self.device,
                    use_kernels=self.use_kernels,
                    chunk_pairs=chunk_items * max(app.emit_capacity, 1),
                    key_block=self.key_block)
            else:
                comb = col.SortCombiner(
                    self.spec, app.key_space, app.value_spec,
                    device=self.device,
                    sort_fold_fn=_sort_fold_kernel(
                        self.use_kernels, self.bucket_size,
                        self.level_fanouts))
            self._combiners[chunk_items] = comb
        return comb

    def tables(self, items, n_valid: int | None = None):
        """The stream or sort flow's un-finalized ``(collector, tables,
        counts)`` over ``items``."""
        n_items = valid_items(items, n_valid)
        ci = chunk_items_of(self.app, n_items, self.chunk_pairs)
        comb = self.combiner(ci)
        state = fold_items_chunked(self.app, comb, items, ci, n_valid=n_items)
        tables, counts = comb.tables_counts(state)
        return comb, tables, counts

    def __call__(self, items, n_valid: int | None = None, *,
                 values: bool = True, sinks=None):
        """``(keys, values, counts)``.  ``values=False`` (a pipeline's dead
        value column) leaves the values unfinalized in the stream and sort
        flows and hands back zeros of their shape and dtype, broadcast from
        one element (no ``[K]`` column is written); the combine and reduce
        flows compute their values and drop them.  ``sinks``: the plans a
        combine run records its lowering and fallbacks on (default: the
        plan)."""
        K = self.app.key_space
        if self.flow in ("combine", "reduce"):
            keys, vals, counts = run_local(
                self.app, self.plan, items, device=self.device,
                combine_impl=self.combine_impl, use_kernels=self.use_kernels,
                n_valid=n_valid, sinks=sinks)
            return keys, (vals if values else dead_values(vals, K)), counts
        comb, tables, counts = self.tables(items, n_valid)
        if values:
            grouped = col.finalize_tables(self.spec, tables, counts, K)
            return grouped.keys, grouped.values, grouped.counts
        # one row is finalized, for the values' shape and dtype only
        one = col.finalize_tables(
            self.spec, pytree.tree_map(lambda t: t[:1], tables),
            counts[:1], 1)
        keys = torch.arange(K, dtype=torch.int32, device=counts.device)
        return keys, dead_values(one.values, K), counts


    def launch_plan(self, n_items: int) -> str:
        """The launches of a run over ``n_items`` items: the chunk loop and,
        per chunk, each fold with its kernel plan (``ops.fold_plan``;
        the sort flow's ``radix_partition.partition_passes``); the plain
        versions where the kernels are off.  The combine flow's lowering
        is the collector's rule at this size (the run records the one it
        took on ``plan.lowering``)."""
        from repro_torch.kernels import ops
        from repro_torch.kernels import radix_partition as rp

        app, spec, K = self.app, self.spec, self.app.key_space
        cap = max(app.emit_capacity, 1)
        head = (f"flow {self.flow} on {self.device}: N={n_items} items x "
                f"{cap} pairs = {n_items * cap} pairs, kernels "
                f"{'on' if self.use_kernels else 'off'}")
        if self.flow == "reduce":
            return "\n".join([head, "map over every item (torch.func.vmap)",
                              "reduce flow: stable torch.sort of the pairs, "
                              f"[K={K}, Lmax={app.max_values_per_key}] "
                              "windows, vmap of app.reduce; no kernel"])
        if self.flow == "combine":
            n = n_items * cap
            impl = self.combine_impl
            if impl == "auto":
                impl, _ = col.choose_combine_impl(
                    spec, K, n, onehot_kernel=self.use_kernels)
            d, _ = spec.holder_width(app.value_spec)
            line = f"combine flow: lowering {impl} over the {n} pairs"
            if impl == "onehot" and self.use_kernels:
                line += (f"; onehot_combine per holder leaf, [K={K}, "
                         f"D={d}] in all: "
                         f"{_fold_desc(ops.fold_plan(n, K, d, 'add'))}; "
                         f"and the counts, [K={K}, 1]: "
                         f"{_fold_desc(ops.fold_plan(n, K, 1, 'add'))}")
            elif impl == "scatter" and self.use_kernels:
                line += ("; per f32 leaf combine_scatter or sort_segment_fold "
                         "by collector.scatter_route")
            if not (impl == "onehot" and self.use_kernels):
                line += "; counts: torch.bincount"
            return "\n".join([head, "map over every item (torch.func.vmap)",
                              line])
        n_items = max(n_items, 0)
        ci = chunk_items_of(self.app, max(n_items, 1), self.chunk_pairs)
        full, last = divmod(n_items, ci)
        loop = f"chunk loop: {full} chunk(s) of {ci * cap} pairs"
        if last:
            loop += f" and one of {last * cap}"
        lines = [head, loop + "; per chunk: map (torch.func.vmap), then:"]
        comb = self.combiner(ci)
        sizes = sorted({ci * cap} | ({last * cap} if last else set()))
        if self.flow == "stream":
            if comb.fused_acc:
                width = sum(comb._widths()) + 1
                for m in sizes:
                    lines.append(
                        f"  onehot_fold, fused [K={K}, {width}] accumulator "
                        f"(counts in the last column), n={m}: "
                        f"{_fold_desc(ops.fold_plan(m, K, width, 'add', self.key_block))}")
            elif comb.mode == "dense" and comb.monoid_fold_fn is not None:
                for mono, leaf in zip(spec.monoids, comb._holder_leaves):
                    for m in sizes:
                        lines.append(
                            f"  chunk_monoid_fold {mono.name} [K={K}, "
                            f"{leaf.numel()}], n={m}: "
                            f"{_fold_desc(ops.fold_plan(m, K, leaf.numel(), mono.name, self.key_block))}")
                lines.append("  counts: torch.bincount")
            else:
                lines.append(f"  {comb.mode} fold in plain PyTorch (no "
                             f"kernel); counts: torch.bincount")
        elif comb.sort_fold_fn is not None:
            passes = rp.partition_passes(K, self.bucket_size,
                                         ops.KERNEL_MAX_LEVEL_BUCKETS)
            name = ("radix_partition_multi" if len(self.level_fanouts or ())
                    > 1 else "radix_partition")
            lines.append(
                f"  per holder leaf (the counts column with the first "
                f"additive leaf): {name}, leaf {self.bucket_size} keys, "
                f"levels {tuple(self.level_fanouts or ())}, "
                + ", ".join(f"pass range {p.range_} fan-out {p.fanout}"
                            for p in passes)
                + "; then segment_reduce")
        else:
            lines.append("  one stable torch.sort per chunk, one aggregate "
                         "per run merged at its key (no kernel)")
        lines.append(f"finalize: vmap of the combiner's finalize over "
                     f"K={K} rows")
        return "\n".join(lines)


def _fold_desc(plan) -> str:
    return (f"{plan.shape} block_k={plan.block_k} cols={plan.cols} "
            f"warps={plan.warps} stage={plan.stage} seg_len={plan.seg_len} "
            f"n_seg={plan.n_seg} key_tiles={plan.key_tiles} "
            f"col_tiles={plan.col_tiles}")


def dead_values(values, key_space: int):
    """Zeros of ``values``' row shape and dtype for ``key_space`` rows,
    broadcast from one element."""
    return pytree.tree_map(
        lambda v: torch.zeros((), dtype=v.dtype, device=v.device).expand(
            (key_space,) + tuple(v.shape[1:])), values)


def stream_local_tables(app, spec, items, *, chunk_pairs: int,
                        device, use_kernels: bool = False,
                        key_block: int | None = None,
                        n_valid: int | None = None):
    """Fused map+combine over ``items``: chunks of about ``chunk_pairs``
    emitted pairs fold straight into the carried holder tables, so the full
    ``N × emit_capacity`` pair buffer never exists.  Returns un-finalized
    ``(tables, counts)``."""
    run = LocalRun(app, "stream", spec, device=device,
                   use_kernels=use_kernels, chunk_pairs=chunk_pairs,
                   key_block=key_block)
    return run.tables(items, n_valid)[1:]


def sort_local_tables(app, spec, items, *, chunk_pairs: int, device,
                      use_kernels: bool = False,
                      bucket_size: int | None = None,
                      level_fanouts: tuple[int, ...] | None = None,
                      n_valid: int | None = None):
    """Sort flow over ``items``: the stream flow's chunk loop, each chunk
    partitioned by key and reduced a run (or a leaf bucket) at a time into
    the carried tables (:class:`collector.SortCombiner`).  Returns
    un-finalized ``(tables, counts)``."""
    run = LocalRun(app, "sort", spec, device=device,
                   use_kernels=use_kernels, chunk_pairs=chunk_pairs,
                   bucket_size=bucket_size, level_fanouts=level_fanouts)
    return run.tables(items, n_valid)[1:]


class StreamIngest:
    """The streaming service's incremental fold, built by
    :func:`build_stream_ingest`.  ``ingest(state, items, n_valid)`` maps
    and folds the first ``n_valid`` of ``items`` (at most ``batch_items``
    rows) into the carried ``state`` and returns the new state;
    ``combiner`` is its collector, which makes, reads and finalizes the
    state, and ``run`` the batch run it was taken from.

    The collector is the one a batch run over chunks of ``batch_items``
    items builds (:meth:`LocalRun.combiner`), and the fold is the batch
    run's chunk loop (:func:`fold_items_chunked`) seeded with ``state``.
    So N ingests of full micro-batches give the bits of one batch run
    whose chunk is the micro-batch.  A short batch is not padded: the
    reference pads it and masks the tail to the sentinel key, but a sum's
    lane order depends on the pairs a fold call sees (ROADMAP C.26), so
    here the loop stops at ``n_valid``.  The state passed in is never
    written through (every fold returns new tensors)."""

    def __init__(self, app, spec, *, batch_items: int, chunk_pairs: int,
                 device, use_kernels: bool = False,
                 key_block: int | None = None):
        self.app = app
        self.batch_items = batch_items
        self.run = LocalRun(app, "stream", spec, device=device,
                            use_kernels=use_kernels, chunk_pairs=chunk_pairs,
                            key_block=key_block)
        self.chunk_items = chunk_items_of(app, batch_items, chunk_pairs)
        self.combiner = self.run.combiner(self.chunk_items)

    def __call__(self, state, items, n_valid: int | None = None):
        n = items_length(items)
        if n > self.batch_items:
            raise ValueError(
                f"micro-batch of {n} items exceeds batch_capacity="
                f"{self.batch_items}; split it or raise the capacity")
        return fold_items_chunked(self.app, self.combiner, items,
                                  self.chunk_items,
                                  n_valid=valid_items(items, n_valid),
                                  state=state)

    def launch_plan(self) -> str:
        """The launches of one full micro-batch (the batch run's over
        ``batch_items`` items)."""
        return self.run.launch_plan(self.batch_items)


def build_stream_ingest(app, spec, *, batch_items: int, chunk_pairs: int,
                        device, use_kernels: bool = False,
                        key_block: int | None = None) -> StreamIngest:
    """The streaming service's ingest (:class:`StreamIngest`): the
    reference's ``(combiner, ingest)`` pair as one object, whose
    ``combiner`` is the collector and whose call is the ingest."""
    return StreamIngest(app, spec, batch_items=batch_items,
                        chunk_pairs=chunk_pairs, device=device,
                        use_kernels=use_kernels, key_block=key_block)


# ---------------------------------------------------------------------------
# Merging partial tables (window slots; A11 and A12 reuse these)
# ---------------------------------------------------------------------------


def _merge_tables_host(spec, tables_seq, counts_seq):
    """Un-finalized merge of partial holder tables, in sequence order:
    per leaf ``Monoid.dense_reduce`` over the stacked partials (the first
    partial's table where a monoid has no dense reduction), else
    ``spec.merge`` folded left to right."""
    leaves_seq = [pytree.tree_leaves(t) for t in tables_seq]
    treedef = pytree.tree_structure(tables_seq[0])
    if (spec.monoids is not None
            and len(spec.monoids) == len(leaves_seq[0])):
        merged = []
        for i, mono in enumerate(spec.monoids):
            stack = torch.stack([ls[i] for ls in leaves_seq])
            red = (mono.dense_reduce(stack, 0)
                   if mono.dense_reduce is not None else stack[0])
            merged.append(red.to(leaves_seq[0][i].dtype))
        return pytree.tree_unflatten(merged, treedef)
    tables, na = tables_seq[0], counts_seq[0]
    for tab, nb in zip(tables_seq[1:], counts_seq[1:]):
        tables = torch.func.vmap(spec.merge)(tables, tab, na, nb)
        na = na + nb
    return tables


def _reapply_merge(app, g_vals, g_cnt):
    """The Hadoop reapply contract over stacked finalized partials:
    values ``[S, K, ...]``, counts ``[S, K]``.  Per key, the partials with
    a count come first (in partial order), the rest hold ``pad_value``,
    and ``app.reduce`` runs over them with the number of such partials as
    its count."""
    cnt_t = g_cnt.T  # [K, S]
    order = torch.argsort((cnt_t == 0).to(torch.int8), dim=1, stable=True)
    live = torch.take_along_dim(cnt_t, order, dim=1) > 0

    def gather(v):
        v = v.movedim(0, 1)  # [K, S, ...]
        tail = (1,) * (v.ndim - 2)
        got = torch.take_along_dim(v, order.reshape(order.shape + tail),
                                   dim=1)
        pad = torch.tensor(app.pad_value, dtype=v.dtype, device=v.device)
        return torch.where(live.reshape(live.shape + tail), got, pad)

    vals = pytree.tree_map(gather, g_vals)
    nvalid = (cnt_t > 0).sum(dim=1).to(torch.int32)
    keys = torch.arange(app.key_space, dtype=torch.int32,
                        device=g_cnt.device)
    merged = torch.func.vmap(app.reduce)(keys, vals, nvalid)
    return keys, merged, g_cnt.sum(dim=0).to(g_cnt.dtype)


def merge_partial_tables(app, spec, tables_seq, counts_seq):
    """Merge partial holder tables, first to last, and finalize:
    ``(keys, values, counts)``.

    The derived combiner is a monoid, so partials folded apart (window
    slots; in A11 and A12, shards) merge into the tables of one fold over
    all their pairs: exactly for counts, integer sums and max/min, and
    within rounding for float sums, whose merge adds the partial sums in
    another order than one fold would.  Per-leaf monoid reductions over
    the stacked partials, else ``spec.merge``, else the reapply
    contract."""
    counts_stack = torch.stack(counts_seq)  # [S, K]
    total = counts_stack.sum(dim=0).to(counts_seq[0].dtype)
    if spec.merge is not None:
        tables = _merge_tables_host(spec, tables_seq, counts_seq)
        out = col.finalize_tables(spec, tables, total, total.shape[0])
        return out.keys, out.values, out.counts
    if spec.reapply_ok:
        finals = [col.finalize_tables(spec, t, c, app.key_space).values
                  for t, c in zip(tables_seq, counts_seq)]
        g_vals = pytree.tree_map(lambda *vs: torch.stack(vs), *finals)
        return _reapply_merge(app, g_vals, counts_stack)
    raise ValueError("combiner has no cross-partial merge strategy")


# ---------------------------------------------------------------------------
# Combine and reduce flows (single shot)
# ---------------------------------------------------------------------------


def _onehot_kernel(use_kernels: bool) -> Callable | None:
    if not use_kernels:
        return None
    from repro_torch.kernels import ops

    return ops.onehot_combine


def _scatter_kernel(use_kernels: bool) -> Callable | None:
    if not use_kernels:
        return None
    from repro_torch.kernels import ops

    return ops.combine_scatter


def _plan_fallback_cb(plans) -> Callable | None:
    """The plans' fallback sink: warn once per plan (the first of
    ``plans``), and record every message on each plan's ``diagnostics``
    for ``explain()``."""
    if not plans:
        return None

    def cb(msg: str) -> None:
        if not getattr(plans[0], "_fallback_warned", False):
            warnings.warn(msg, col.LoweringFallbackWarning, stacklevel=4)
            plans[0]._fallback_warned = True
        for plan in plans:
            if msg not in plan.diagnostics:
                plan.diagnostics += (msg,)

    return cb


def _plan_lowering_cb(plans) -> Callable | None:
    """Record the lowering a combine run took on each plan's
    ``lowering``."""
    if not plans:
        return None

    def cb(taken: str) -> None:
        for plan in plans:
            plan.lowering = taken

    return cb


def run_local(app, plan, items, *, device, combine_impl: str = "auto",
              use_kernels: bool = False, n_valid: int | None = None,
              sinks=None):
    """The combine or reduce flow over ``items``: one map phase over the
    first ``n_valid`` items (all when None; the rest are neither mapped nor
    folded, as in :func:`fold_items_chunked`), then ``combine_flow``
    (kernels bound by ``use_kernels``) or ``reduce_flow``.  The combine
    flow records its lowering and fallbacks on the plans ``sinks``
    (default: ``plan``).  Returns ``(keys, values, counts)``."""
    sinks = (plan,) if sinks is None else tuple(sinks)
    if n_valid is not None:
        n = valid_items(items, n_valid)
        items = pytree.tree_map(lambda a: a[:n], items)
    stream = map_phase(app, items, device)
    if plan.flow == "combine":
        grouped = col.combine_flow(
            plan.spec, stream, impl=combine_impl,
            onehot_fn=_onehot_kernel(use_kernels),
            scatter_fn=_scatter_kernel(use_kernels),
            sort_fold_fn=_sort_fold_kernel(use_kernels, None, None),
            on_fallback=_plan_fallback_cb(sinks),
            on_lowering=_plan_lowering_cb(sinks))
    elif plan.flow == "reduce":
        grouped = col.reduce_flow(
            app.reduce, stream, max_values_per_key=app.max_values_per_key,
            pad_value=app.pad_value)
    else:
        raise ValueError(f"run_local runs the combine and reduce flows, not "
                         f"{plan.flow!r}")
    return grouped.keys, grouped.values, grouped.counts

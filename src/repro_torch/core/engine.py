"""Execution engine: the map phase, the stream and sort flows' chunked
fold, the single-shot combine and reduce flows, and the four flows over a
shard mesh.

Counterpart of ``repro/core/engine.py``: ``Emitter``, ``map_phase``,
``_fold_items_chunked``, ``stream_local_tables``, ``sort_local_tables``,
``run_local``, ``build_stream_ingest``, ``merge_partial_tables``, the
distributed half (``merge_tables_collective``, the shuffle's send and
receive sides, ``run_distributed``, ``build_distributed_fn``) and the
resilient driver (``run_resilient`` over ``resilient_run``).  The reference scans the chunks
with ``lax.scan``; here the chunk loop is a Python loop, so chunks are
large (see ``autotune``) and each one is a handful of launches.  On the
card a prepared stream run captures that loop as one CUDA graph and
replays it (:class:`CapturedLoop`), so the host no longer paces the
chunks.  The combine and reduce flows map every item at once and hand the
whole pair buffer to their collector.  :class:`LocalRun` is a flow
prepared to dispatch, what the staged API's ``compile()`` caches.
"""

from __future__ import annotations

import atexit
import collections
import inspect
import itertools
import numbers
import threading
import types
import warnings
import weakref
from functools import partial
from typing import Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch import spans
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

    with spans.span("map"):
        keys, vals = torch.func.vmap(one)(items)
        # a map that emits the same key (or value) for every item gets it
        # back expanded with stride 0; the kernels take dense rows
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

    A collector that folds in place (``combiner.folds_in_place``) is
    handed the loop's own state: ``init_state``'s, or a copy of the state
    the caller seeded, which is never written.
    """
    n_items = valid_items(items, n_valid)
    if state is None:
        with spans.span("init"):
            state = combiner.init_state()
    elif combiner.folds_in_place:
        state = pytree.tree_map(
            lambda t: t.clone(memory_format=torch.contiguous_format), state)
    for lo in range(0, n_items, chunk_items):
        with spans.span("chunk"):
            hi = min(lo + chunk_items, n_items)
            chunk = pytree.tree_map(lambda a: a[lo:hi], items)
            stream = map_phase(app, chunk, combiner.device)
            spans.count("chunks")
            spans.count("pairs", stream.keys.shape[0])
            state = combiner.fold_chunk(state, stream)
            del stream  # the chunk's pairs go before the next are mapped
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


#: the app's attribute that memoizes its plan keys (``plan_cache``): not
#: read by its map
_PLAN_MEMO = "_plan_cache_fp"
#: a closure's cell that was never set (it has no ``cell_contents``)
_EMPTY_CELL = types.CellType()


def _state_key(obj, seen: set) -> object:
    """What a captured map reads of ``obj``, an attribute of its app: a
    tensor by its address and layout (a replay reads what the address
    holds then), a number or string by value, a container, a function's
    closure or a plain object by its parts, anything else by identity."""
    if isinstance(obj, torch.Tensor):
        return ("tensor", obj.data_ptr(), tuple(obj.shape), obj.stride(),
                obj.dtype, obj.device)
    if obj is None or isinstance(obj, (numbers.Number, str, bytes,
                                       torch.dtype, torch.device)):
        return obj
    if id(obj) in seen:
        return ("seen", id(obj))
    seen.add(id(obj))
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__,) + tuple(_state_key(x, seen)
                                             for x in obj)
    if isinstance(obj, dict):
        return ("dict",) + tuple((repr(k), _state_key(v, seen))
                                 for k, v in obj.items())
    if inspect.isfunction(obj):
        cells = [c.cell_contents for c in obj.__closure__ or ()
                 if c != _EMPTY_CELL]
        return ("function", id(obj)) + tuple(_state_key(c, seen)
                                             for c in cells)
    if (hasattr(obj, "__dict__") and not isinstance(obj, type)
            and not inspect.ismodule(obj)):
        return (type(obj).__qualname__,) + tuple(
            (name, _state_key(v, seen)) for name, v in vars(obj).items())
    return ("object", id(obj))


def loop_key(app, items, n_items: int) -> tuple:
    """What a captured chunk loop reads from its call: the items it folds,
    each items leaf's address (its storage and offset), shape, strides,
    dtype and device, and the app's attributes (:func:`_state_key`).  A
    replay reads whatever those addresses hold then, so items changed in
    place, or new items at the same address and layout, fold as they are;
    an app attribute set to another tensor or value is another key."""
    seen = {id(app)}
    state = tuple((name, _state_key(v, seen))
                  for name, v in vars(app).items() if name != _PLAN_MEMO)
    return (n_items, state) + tuple(
        (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device)
        for t in pytree.tree_leaves(items))


def graph_capturable(device: torch.device) -> bool:
    """Whether a chunk loop on ``device`` can be captured: a CUDA card."""
    return device.type == "cuda"


def _dispatch_mode_on() -> bool:
    """A ``TorchDispatchMode`` is active (an op trace, fake tensors): it
    has to see every op, so the loop runs eagerly."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    return _get_current_dispatch_mode() is not None


def _abandon(graph, device: torch.device, pool) -> None:
    """After a capture that raised: end it if it is still open, and free
    ``pool`` with its last reference.  A capture that ends is reset, which
    lets go of the pool; one that fails to end leaves the pool held by the
    graph and the capture's stream routed to it (torch 2.11 on the card),
    so both are undone here."""
    if torch.cuda.is_current_stream_capturing():
        try:
            graph.capture_end()
        except Exception:  # noqa: BLE001 - the capture was spoiled
            pass
        else:
            graph.reset()
            return
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    try:
        torch._C._cuda_endAllocateToPool(index, pool.id)
    except Exception:  # noqa: BLE001 - not routed
        pass
    while pool.use_count() > 1:
        torch._C._cuda_releasePool(index, pool.id)


def capture(fold: Callable, device: torch.device):
    """``(graph, result, pool, pool bytes)``: ``fold()`` captured as one
    CUDA graph on a side stream into a memory pool of its own
    (``torch.cuda.MemPool``), which computes nothing until it is replayed,
    and the bytes ``torch.cuda.memory_reserved`` grew by over the capture
    (the pool, and whatever other threads reserved meanwhile).  The
    capture is ``thread_local``: other threads' calls that may not run
    during a capture (a cudaMalloc, a synchronize) neither raise nor spoil
    it, though one that draws from the card's default random generator
    raises while it lasts (torch's generator is in capture mode for every
    thread).  Raises what the capture raised (a host sync or a copy from
    host memory inside ``fold``, an op that cannot be captured), with the
    pool freed."""
    with torch.cuda.device(device):
        pool = torch.cuda.MemPool()
        before = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(torch.cuda.Stream(device)):
            graph.capture_begin(pool=pool.id,
                                capture_error_mode="thread_local")
            try:
                result = fold()
                graph.capture_end()
            except BaseException:
                _abandon(graph, device, pool)
                raise
        return (graph, result, pool,
                max(torch.cuda.memory_reserved(device) - before, 0))


class CapturedLoop:
    """A stream run's chunk loop, from its state's init to the last
    chunk's fold, captured as one CUDA graph for one :func:`loop_key`.

    ``state`` is the graph's output, in its memory pool: each replay
    writes the folded state there again, so what a caller keeps is copied
    out first (:meth:`LocalRun.__call__`).  Every replay launches the
    capture's kernels in the capture's order with the same launch plans,
    so its bits are the eager loop's.  ``tally`` holds what the capture
    counted (``repro_torch.spans``: chunks, pairs, folds, launches), added
    again on each replay.  The graph, its output and then its pool are
    freed with the loop's last reference (:meth:`close`)."""

    def __init__(self, key: tuple, fold: Callable, device: torch.device):
        self.key = key
        with spans.span("graph.capture"), spans.tally() as tally:
            try:
                self.graph, self.state, self.pool, self.pool_bytes = capture(
                    fold, device)
            except BaseException:
                spans.credit(tally, -1)  # the eager loop counts it again
                raise
        self.tally = tally
        spans.count("loop_captures")
        spans.count("graph_pool_bytes", self.pool_bytes)
        with spans.span("graph.replay"):  # the capture computed nothing
            self.graph.replay()

    def replay(self):
        """The state folded again from what the items hold now."""
        with spans.span("graph.replay"):
            self.graph.replay()
            spans.credit(self.tally)
            spans.count("loop_replays")
        return self.state

    def close(self) -> None:
        """Free the graph, then its output, then its pool: a pool that a
        graph still holds cannot be freed (torch asserts it)."""
        graph = getattr(self, "graph", None)
        self.graph = None
        if hasattr(graph, "reset"):
            graph.reset()
        del graph
        self.state = self.pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - at exit the card may be gone
            pass


#: the bytes of graph pools the process holds: past them the least
#: recently used captured loops are freed (the newest is held whatever its
#: size)
GRAPH_POOL_BYTES = 1 << 30
#: the captured loops held, one a run (by its token), least recently used
#: first; their pools sum to at most ``GRAPH_POOL_BYTES`` or one loop's
_held: collections.OrderedDict[int, CapturedLoop] = collections.OrderedDict()
_held_lock = threading.Lock()
_tokens = itertools.count()
atexit.register(_held.clear)  # while the card is up: each loop frees its pool


def held_loop(token: int, use: bool = False) -> CapturedLoop | None:
    """The loop run ``token`` holds; ``use`` marks it most recently used."""
    with _held_lock:
        loop = _held.get(token)
        if use and loop is not None:
            _held.move_to_end(token)
        return loop


def _hold(token: int, loop: CapturedLoop) -> None:
    """Hold ``loop`` as run ``token``'s, then let go of the least recently
    used loops while the pools pass ``GRAPH_POOL_BYTES``."""
    with _held_lock:
        dropped = [_held.pop(token, None)]
        _held[token] = loop
        while len(_held) > 1 and (sum(h.pool_bytes for h in _held.values())
                                  > GRAPH_POOL_BYTES):
            dropped.append(_held.popitem(last=False)[1])
    del dropped  # freed outside the lock, as their last references go


def _let_go(token: int) -> None:
    """Free the loop run ``token`` holds (its graph and pool go with the
    last reference: a call replaying it still has one)."""
    with _held_lock:
        loop = _held.pop(token, None)
    del loop


def _copied_out(out, state):
    """``out`` with each tensor that shares storage with ``state`` (a
    captured loop's output, which its next replay overwrites) copied."""
    held = {t.untyped_storage().data_ptr() for t in pytree.tree_leaves(state)}
    return pytree.tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor)
        and t.untyped_storage().data_ptr() in held else t, out)


class LocalRun:
    """One flow of one plan on one device, prepared to dispatch: the knobs
    resolved, the sort flow's radix plan checked, and the stream or sort
    collector built once per chunk size (kept for later calls).  Calling it
    maps and folds ``items`` (the first ``n_valid`` of them) and returns
    fresh ``(keys, values, counts)`` tensors.

    On a CUDA card with the kernels on, a call of the stream flow over the
    same items as the run's call before it (the same :func:`loop_key`:
    the items' addresses and layout, their count and the app's
    attributes) captures its chunk loop as one CUDA graph
    (:class:`CapturedLoop`), and later calls with that key replay it.  So
    the loop is captured only for items that repeat, as a dashboard's
    GROUP BY over a resident column store does: a one-shot call, or calls
    over items at new addresses each time, stay on the eager loop and pay
    no capture.  A run holds one captured loop: capturing another frees
    the old graph and its pool first.  The process holds at most
    ``GRAPH_POOL_BYTES`` of pools over all runs (or one loop's), freeing
    the least recently used loops past it; a run's loop is freed with the
    run.  The loop runs eagerly on the CPU, with the kernels off, in the
    sort flow, under a dispatch mode, and for good once a capture raised;
    :meth:`tables` (the distributed and resilient paths) and seeded folds
    (the streaming ingest) are always eager.  A captured map may read its
    items and its app's attributes; what else it reads (a global, an
    object changed in place) is frozen into the graph, so such state has
    to reach it through the items or a new attribute.  ``loop_path`` says
    which path the last call took; ``explain()`` prints it (``loop:``).
    Calls from several threads take turns from the loop to the copy out
    of the pool, which the next replay writes.

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
        #: :meth:`fold_lowering` by item count
        self._lowerings: dict[int, str] = {}
        #: this run's captured loop among those the process holds
        #: (:func:`held_loop`), freed with the run
        self._token = next(_tokens)
        weakref.finalize(self, _let_go, self._token)
        #: the last call's :func:`loop_key`
        self._last_key: tuple | None = None
        #: why the loop stays eager for good (a capture raised)
        self._no_capture = ""
        self.loop_path = ""
        self._lock = threading.Lock()

    @property
    def captured(self) -> CapturedLoop | None:
        """The captured chunk loop this run holds, if any."""
        return held_loop(self._token)

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
        run records its lowering on (a combine run its fallbacks too;
        default: the plan).  Each call counts one ``runs``
        (``repro_torch.spans``)."""
        K = self.app.key_space
        spans.count("runs")
        if self.flow in ("combine", "reduce"):
            keys, vals, counts = run_local(
                self.app, self.plan, items, device=self.device,
                combine_impl=self.combine_impl, use_kernels=self.use_kernels,
                n_valid=n_valid, sinks=sinks)
            return keys, (vals if values else dead_values(vals, K)), counts
        with self._lock:
            return self._stream_call(items, n_valid, values, sinks)

    def _stream_call(self, items, n_valid, values, sinks):
        """The stream or sort flow's call (:meth:`__call__`)."""
        K = self.app.key_space
        n_items = valid_items(items, n_valid)
        ci = chunk_items_of(self.app, n_items, self.chunk_pairs)
        comb = self.combiner(ci)
        state, pooled = self._fold(comb, items, ci, n_items)
        tables, counts = comb.tables_counts(state)
        lowering = self._lowerings.get(n_items)
        if lowering is None:
            lowering = self._lowerings[n_items] = self.fold_lowering(n_items)
        for p in ((self.plan,) if sinks is None else sinks):
            if p is not None:
                p.loop = self.loop_path
                if lowering:
                    p.lowering = lowering
        if values:
            with spans.span("finalize"):
                grouped = col.finalize_tables(self.spec, tables, counts, K)
            out = grouped.keys, grouped.values, grouped.counts
        else:
            # one row is finalized, for the values' shape and dtype only
            one = col.finalize_tables(
                self.spec, pytree.tree_map(lambda t: t[:1], tables),
                counts[:1], 1)
            keys = torch.arange(K, dtype=torch.int32, device=counts.device)
            out = keys, dead_values(one.values, K), counts
        return _copied_out(out, state) if pooled else out

    def _fold(self, comb, items, ci: int, n_items: int):
        """``(state, pooled)``: the carried state after the chunk loop over
        the first ``n_items`` items, and whether it is a captured loop's
        output (``pooled``), which the next replay overwrites."""
        def fold():
            return fold_items_chunked(self.app, comb, items, ci,
                                      n_valid=n_items)

        why = self._eager_reason(comb)
        if not why:
            key = loop_key(self.app, items, n_items)
            repeat, self._last_key = key == self._last_key, key
            loop = held_loop(self._token, use=True)
            if loop is not None and loop.key == key:
                self.loop_path = (f"cuda graph, replayed (pool "
                                  f"{loop.pool_bytes / 2**20:.1f} MiB)")
                return loop.replay(), True
            if not repeat:
                why = ("other items than the call before; the next call "
                       "over the same items captures the loop")
            else:
                _let_go(self._token)  # frees the old graph and its pool
                try:
                    loop = CapturedLoop(key, fold, self.device)
                except Exception as exc:  # noqa: BLE001 - any failure: eager
                    msg = str(exc).strip().splitlines()
                    self._no_capture = (
                        f"capture failed: {type(exc).__name__}"
                        + (f": {msg[0][:160]}" if msg else ""))
                    spans.count("loop_fallbacks")
                    why = self._no_capture
                else:
                    _hold(self._token, loop)
                    self.loop_path = (f"cuda graph, captured (pool "
                                      f"{loop.pool_bytes / 2**20:.1f} MiB)")
                    return loop.state, True
        self.loop_path = f"eager ({why})"
        return fold(), False

    def _eager_reason(self, comb) -> str:
        """Why this call's chunk loop runs eagerly whatever its items; ""
        where it may be captured or replayed."""
        if self.flow != "stream":
            return f"the {self.flow} flow"
        if not graph_capturable(self.device):
            return f"on a {self.device.type} device, not a CUDA card"
        if not self.use_kernels:
            return "kernels off"
        if comb.mode == "sequential":
            return "the sequential fold reads each key on the host"
        if self._no_capture:
            return self._no_capture
        if _dispatch_mode_on():
            return "under a dispatch mode (an op trace, fake tensors)"
        if (self.device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            return "inside another capture"
        return ""


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
                line += "; counts: int_fold"
            return "\n".join([head, "map over every item (torch.func.vmap)",
                              line])
        ci, full, last, sizes = self._chunks(n_items)
        loop = f"chunk loop: {full} chunk(s) of {ci * cap} pairs"
        if last:
            loop += f" and one of {last * cap}"
        lines = [head, loop + "; per chunk: map (torch.func.vmap), then:"]
        comb = self.combiner(ci)
        if self.flow == "stream":
            if comb.fused_acc:
                width = sum(comb._widths()) + 1
                for m in sizes:
                    lines.append(
                        f"  onehot_fold, fused [K={K}, {width}] accumulator "
                        f"(values [n, {width - 1}]; the counts column folded "
                        f"in the kernel from the keys), n={m}: "
                        f"{_fold_desc(ops.fold_plan(m, K, width, 'add', self.key_block, True, True))}")
            elif comb.mode == "dense" and comb.monoid_fold_fn is not None:
                for mono, leaf in zip(spec.monoids, comb._holder_leaves):
                    for m in sizes:
                        lines.append(
                            f"  chunk_monoid_fold {mono.name} [K={K}, "
                            f"{leaf.numel()}], n={m}: "
                            f"{_fold_desc(ops.fold_plan(m, K, leaf.numel(), mono.name, self.key_block, inplace=True))}")
                lines.append("  counts: int_fold")
            elif comb.mode == "additive" and any(
                    not leaf.is_floating_point()
                    for leaf in comb._holder_leaves):
                ints = [f"[K={K}, {leaf.numel()}]"
                        for leaf in comb._holder_leaves
                        if not leaf.is_floating_point()]
                line = (f"  int_fold per integer holder leaf, int64 "
                        f"{', '.join(ints)} (the counts in the first "
                        f"launch)")
                if len(ints) < len(comb._holder_leaves):
                    line += "; float leaves: " + (
                        "onehot_fold" if comb.fold_fn is not None
                        else "the plain one-hot contraction")
                lines.append(line)
            elif comb.mode == "sequential":
                lines.append("  sequential fold in plain PyTorch (no kernel)")
            else:
                lines.append(f"  {comb.mode} fold in plain PyTorch (no "
                             f"kernel); counts: int_fold")
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

    def _chunks(self, n_items: int):
        """``(chunk items, full chunks, items of the last, the chunks'
        distinct pair counts)`` of a stream or sort run over ``n_items``."""
        n_items = max(n_items, 0)
        cap = max(self.app.emit_capacity, 1)
        ci = chunk_items_of(self.app, max(n_items, 1), self.chunk_pairs)
        full, last = divmod(n_items, ci)
        return ci, full, last, sorted({ci * cap}
                                      | ({last * cap} if last else set()))

    def fold_lowering(self, n_items: int) -> str:
        """The stream flow's ``lowering:`` record of a run over
        ``n_items`` with the kernels on: each keyed fold kernel a chunk
        launches and the route its plan takes (``ops.fold_plan``), by
        chunk size; "" where no keyed fold kernel runs."""
        if self.flow != "stream" or not self.use_kernels:
            return ""
        from repro_torch.kernels import ops

        K = self.app.key_space
        ci, _, _, sizes = self._chunks(n_items)
        comb = self.combiner(ci)
        folds = []
        if comb.fused_acc:
            width = sum(comb._widths()) + 1
            folds = [(f"onehot_fold [K, {width}]", m,
                      ops.fold_plan(m, K, width, "add", self.key_block, True,
                                    True))
                     for m in sizes]
        elif comb.mode == "dense" and comb.monoid_fold_fn is not None:
            folds = [(f"chunk_monoid_fold {mono.name} [K, {leaf.numel()}]", m,
                      ops.fold_plan(m, K, leaf.numel(), mono.name,
                                    self.key_block, inplace=True))
                     for mono, leaf in zip(self.spec.monoids,
                                           comb._holder_leaves)
                     if leaf.dtype == torch.float32
                     and mono.name in ("add", "max", "min")
                     for m in sizes]
        if not folds:
            return ""
        return (f"stream (K={K}: "
                + "; ".join(f"{name} n={m}: {_fold_route(plan)}"
                            for name, m, plan in folds) + ")")


def _fold_route(plan) -> str:
    """The route of a keyed fold's plan, for the ``lowering:`` line (and
    the head of :func:`_fold_desc`)."""
    if plan.route == "partitioned":
        head = (f"partitioned route, {len(plan.part.passes)} partition "
                f"pass(es) into {plan.key_tiles} key tiles of {plan.block_k}"
                f", {plan.n_seg} sub-chunk(s) of {plan.seg_len} pairs")
    else:
        head = (f"tile route, {plan.key_tiles} key tile(s) x "
                f"{plan.col_tiles} column tile(s)")
    return f"{head}, {plan.scans} read(s) a pair"


def _fold_desc(plan) -> str:
    """A keyed fold's plan in full, for the launch plan."""
    desc = (f"{plan.shape} block_k={plan.block_k} cols={plan.cols} "
            f"warps={plan.warps} stage={plan.stage} seg_len={plan.seg_len} "
            f"n_seg={plan.n_seg} key_tiles={plan.key_tiles} "
            f"col_tiles={plan.col_tiles}")
    if plan.route == "partitioned":
        desc += (f" region_seg={plan.region_seg} extra={plan.extra} "
                 f"scratch={plan.scratch}B")
    return f"{_fold_route(plan)}: {desc}"


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
    written: the chunk loop folds a state it did not make out of place."""

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


# ---------------------------------------------------------------------------
# Distributed (A11): the four flows over a shard mesh
# ---------------------------------------------------------------------------
#
# A flow's shard body is written as stages separated by collectives
# (``distributed/mesh.py``): each stage maps over ``mesh.shards()`` (every
# shard of a LocalMesh, in turn; the rank's own on a ProcessGroupMesh), and
# every collective takes and returns one tensor per shard of that list.


def shard_items(items, num_shards: int) -> list:
    """The S contiguous blocks of ``items`` along the item axis (views), as
    the reference's ``P(data_axis)`` splits them; an item count that S does
    not divide raises, as the reference's ``shard_map`` does."""
    n = items_length(items)
    if n % num_shards:
        raise ValueError(
            f"{n} items are not evenly divisible by the mesh's "
            f"{num_shards} shards (the data axis splits the items into "
            f"equal contiguous blocks)")
    per = n // num_shards
    return [pytree.tree_map(lambda a: a[s * per:(s + 1) * per], items)
            for s in range(num_shards)]


def _stack_leaves(xs):
    return [pytree.tree_leaves(x) for x in xs]


def merge_tables_collective(spec, tables, counts, mesh, *,
                            scatter: bool = False):
    """Merge the shards' un-finalized holder tables across ``mesh``.

    ``tables`` / ``counts`` hold one partial a shard of ``mesh.shards()``;
    the result holds the merged ``(tables, counts)`` a shard: every key
    (replicated), or with ``scatter=True`` the shard's block of
    ``K / S`` keys (the reference's ``psum_scatter``).

    The merge equals :func:`merge_partial_tables` over the shards' tables
    in shard order, bit for bit, on every mesh: integer sums and counts
    are summed and integer max/min (and/or) reduced by the mesh (exact in
    any order); float leaves, integer products and a ``spec.merge``
    without monoids are all-gathered and merged as
    :func:`_merge_tables_host` merges them, since a backend's float
    all-reduce adds in an order of its own."""
    S = mesh.size
    mine = mesh.shards()
    K = counts[0].shape[0]
    if scatter and K % S:
        raise ValueError(f"scatter_output needs the key space ({K}) to be a "
                         f"multiple of the mesh size ({S})")

    def block(x, s):
        return x[s * (K // S):(s + 1) * (K // S)] if scatter else x

    def reduce_exact(op, xs):
        if scatter and op is mesh.psum:
            return mesh.psum_scatter(xs)
        return [block(r, s) for r, s in zip(op(xs), mine)]

    total = reduce_exact(mesh.psum, counts)
    leaves_seq = _stack_leaves(tables)
    treedef = pytree.tree_structure(tables[0])
    if spec.monoids is not None and len(spec.monoids) == len(leaves_seq[0]):
        merged = [[] for _ in mine]
        for i, mono in enumerate(spec.monoids):
            xs = [ls[i] for ls in leaves_seq]
            dt = xs[0].dtype
            if not dt.is_floating_point and mono.name == "add":
                red = reduce_exact(mesh.psum, xs)
            elif not dt.is_floating_point and mono.name in (
                    "max", "min", "and", "or"):
                op = mesh.pmax if mono.name in ("max", "or") else mesh.pmin
                wide = [x.to(torch.int64) if dt == torch.bool else x
                        for x in xs]
                red = [r.to(dt) for r in reduce_exact(op, wide)]
            else:
                red = []
                for g, s in zip(mesh.all_gather(xs), mine):
                    r = (mono.dense_reduce(g, 0)
                         if mono.dense_reduce is not None else g[0])
                    red.append(block(r.to(dt), s))
            for out, r in zip(merged, red):
                out.append(r)
        return ([pytree.tree_unflatten(m, treedef) for m in merged], total)
    # a spec.merge without monoids: gather every shard's tables and fold
    # them left to right, as the host merge does
    g_leaves = [mesh.all_gather([ls[i] for ls in leaves_seq])
                for i in range(len(leaves_seq[0]))]
    g_counts = mesh.all_gather(counts)
    out = []
    for j, s in enumerate(mine):
        seq = [pytree.tree_unflatten([g[j][src] for g in g_leaves], treedef)
               for src in range(S)]
        merged = _merge_tables_host(spec, seq, list(g_counts[j].unbind(0)))
        out.append(pytree.tree_map(lambda t, s=s: block(t, s), merged))
    return out, total


def _finalize_rows(spec, tables, counts, lo: int = 0):
    """``(keys, values, counts)`` of tables whose row 0 is key ``lo``."""
    keys = torch.arange(counts.shape[0], dtype=torch.int32,
                        device=counts.device) + lo
    return keys, torch.func.vmap(spec.finalize)(keys, tables, counts), counts


def _merge_shard_tables(app, spec, tables, counts, mesh, *, scatter):
    """Merge the shards' partial tables and finalize: the shared tail of the
    stream and combine flows.  ``spec.merge`` (monoid collectives, or the
    gathered fold), else the reapply contract over the gathered finalized
    partials.  Returns ``(keys, values, counts)`` a shard."""
    mine = mesh.shards()
    if spec.merge is not None:
        mt, mc = merge_tables_collective(spec, tables, counts, mesh,
                                         scatter=scatter)
        if not scatter:  # replicated: every shard's merge is the same
            out = _finalize_rows(spec, mt[0], mc[0])
            return [out] * len(mine)
        rows = mc[0].shape[0]
        return [_finalize_rows(spec, t, c, s * rows)
                for t, c, s in zip(mt, mc, mine)]
    if spec.reapply_ok:
        K = app.key_space
        finals = [col.finalize_tables(spec, t, c, K).values
                  for t, c in zip(tables, counts)]
        leaves = _stack_leaves(finals)
        treedef = pytree.tree_structure(finals[0])
        g_leaves = [mesh.all_gather([ls[i] for ls in leaves])
                    for i in range(len(leaves[0]))]
        g_cnt = mesh.all_gather(counts)
        outs = []
        for j, s in enumerate(mine):
            g_vals = pytree.tree_unflatten([g[j] for g in g_leaves], treedef)
            keys, vals, cnt = _reapply_merge(app, g_vals, g_cnt[j])
            if scatter:
                if K % mesh.size:
                    raise ValueError(
                        f"scatter_output needs the key space ({K}) to be a "
                        f"multiple of the mesh size ({mesh.size})")
                rows = K // mesh.size
                cut = slice(s * rows, (s + 1) * rows)
                keys, cnt = keys[cut], cnt[cut]
                vals = pytree.tree_map(lambda v: v[cut], vals)
            outs.append((keys, vals, cnt))
        return outs
    raise ValueError("combiner has no cross-shard merge strategy")


def _combine_local_tables(app, spec, stream: col.PairStream, *,
                          combine_impl: str, use_kernels: bool, routes=None):
    """The combine flow's fold of one shard's pairs into un-finalized
    ``(tables, counts)``, by the reference's rule for its distributed run:
    counts alone, the first-element idiom, the scatter lowering
    (``combine_impl`` auto or scatter; ``combine_scatter`` or the sort
    route with the kernels), the one-hot lowering (``onehot_combine``),
    else the coupled fold.  ``routes`` receives the lowering taken."""
    K = app.key_space
    note = routes.append if routes is not None else (lambda _: None)
    if spec.strategy == C.STRATEGY_SIZE:
        note("scatter (counts only)")
        return (), col._counts(stream.keys, K)
    if spec.strategy == C.STRATEGY_FIRST:
        note("first")
        return col.combine_first(spec, stream)
    if spec.scatter_lowerable and combine_impl in ("auto", "scatter"):
        leaf_routes: list[str] = []
        out = col.combine_scatter(
            spec, stream, scatter_fn=_scatter_kernel(use_kernels),
            sort_fold_fn=_sort_fold_kernel(use_kernels, None, None),
            routes=leaf_routes)
        note(f"scatter (K={K}: {', '.join(leaf_routes)})")
        return out
    if spec.sum_lowerable and combine_impl == "onehot":
        note("onehot (onehot_combine)" if use_kernels
             else "onehot (plain contraction)")
        return col.combine_onehot(spec, stream,
                                  onehot_fn=_onehot_kernel(use_kernels))
    note("segment")
    return col.combine_segment(spec, stream)


def _localize_recv(app, recv_keys, recv_vals, *, num_shards: int,
                   shard_index: int, shuffle_plan=None):
    """Rebase a received ``[S, B]`` bucket stack into the shard's key range
    ``[0, K_local]`` (sentinel ``K_local``): ``(local stream, lo)``.  With a
    skew plan the range is the shard's boundary span, rebased into the
    static width ``plan.width``, and hot keys drop to the sentinel (they
    fold into the hot tables and land back at the finalize patch)."""
    K = app.key_space
    if shuffle_plan is None:
        K_local = -(-K // num_shards)
        lo = shard_index * K_local
        lkeys = torch.where(recv_keys < K, recv_keys - lo, K_local)
        lkeys = torch.where((lkeys >= 0) & (lkeys <= K_local), lkeys,
                            K_local)
    else:
        K_local = shuffle_plan.width
        lo = shuffle_plan.boundaries[shard_index]
        hi = shuffle_plan.boundaries[shard_index + 1]
        inside = (recv_keys >= lo) & (recv_keys < hi)
        for k in shuffle_plan.hot_keys:
            inside = inside & (recv_keys != k)
        lkeys = torch.where(inside, recv_keys - lo, K_local)
    lstream = col.PairStream(
        lkeys.reshape(-1).to(torch.int32).contiguous(),
        pytree.tree_map(lambda v: v.reshape((-1,) + tuple(v.shape[2:])),
                        recv_vals), K_local)
    return lstream, int(lo)


def _send_partial(stream: col.PairStream, fmt, shuffle_plan=None):
    """The shuffle's send side for one shard: its pairs bucketized by
    destination and encoded under ``fmt``, and the count of pairs past a
    destination's capacity.  This is the reduce and sort flows'
    checkpointable shard partial, the reference's tree ``{"wire",
    "overflow", "wire_epoch"}``: the overflow an int32 scalar, the epoch
    ``fmt.epoch`` as a ``[1]`` uint32 on the host (C.47: torch has few
    uint32 kernels, so it is only stored and read back as an int)."""
    from repro_torch.distributed import wire as wirelib

    sk, sv, overflow = wirelib.bucketize(fmt, stream, shuffle_plan)
    return {"wire": wirelib.encode(fmt, sk, sv),
            "overflow": overflow.to(torch.int32),
            "wire_epoch": torch.tensor([fmt.epoch], dtype=torch.uint32)}


def _recv_range(app, fmt, recv_enc, r: int, *, num_shards: int,
                shuffle_plan=None):
    """The shuffle's receive side for key range ``r``: ``recv_enc`` holds
    every source's ``r``-th encoded row, in source order; decode it and
    rebase it into the range (:func:`_localize_recv`).  Returns the local
    stream, its key offset and the decoded flat ``(keys, values)`` (the
    hot-split path folds its tables from them)."""
    from repro_torch.distributed import wire as wirelib

    recv_keys, recv_vals = wirelib.decode(fmt, recv_enc, r)
    lstream, lo = _localize_recv(app, recv_keys, recv_vals,
                                 num_shards=num_shards, shard_index=r,
                                 shuffle_plan=shuffle_plan)
    flat = (recv_keys.reshape(-1),
            pytree.tree_map(lambda v: v.reshape((-1,) + tuple(v.shape[2:])),
                            recv_vals))
    return lstream, lo, flat


def _reduce_range(app, lstream: col.PairStream, lo: int):
    """The reduce flow's tail for one key range: group the local stream and
    run the user reduce with the global keys."""

    def reduce_global(k, vals, cnt):
        return app.reduce(k + lo, vals, cnt)

    grouped = col.reduce_flow(reduce_global, lstream,
                              max_values_per_key=app.max_values_per_key,
                              pad_value=app.pad_value)
    return grouped.keys + lo, grouped.values, grouped.counts


def _fold_hot_tables(app, spec, recv_keys, recv_vals, shuffle_plan, *,
                     device, use_kernels: bool):
    """A shard's received hot-key pairs folded into ``[H, ...]`` partial
    tables (identity rows for hot keys it received nothing of)."""
    H = len(shuffle_plan.hot_keys)
    hidx = torch.full_like(recv_keys, H, dtype=torch.int32)
    for i, k in enumerate(shuffle_plan.hot_keys):
        hidx = torch.where(recv_keys == k, i, hidx)
    fold_fn, monoid_fold_fn = _fold_kernels(use_kernels)
    sc = col.StreamCombiner(spec, H, app.value_spec, device=device,
                            fold_fn=fold_fn, monoid_fold_fn=monoid_fold_fn)
    state = sc.fold_chunk(sc.init_state(),
                          col.PairStream(hidx, recv_vals, H))
    return sc.tables_counts(state)


def _patch_hot_rows(tables, counts, hot_tables, hot_counts, shuffle_plan,
                    shard_index: int):
    """Write the merged hot-key rows into the range tables of each key's
    owner shard, before the finalize."""
    tables = pytree.tree_map(lambda t: t.clone(), tables)
    counts = counts.clone()
    hot_leaves = pytree.tree_leaves(hot_tables)
    leaves, treedef = pytree.tree_flatten(tables)
    for i, k in enumerate(shuffle_plan.hot_keys):
        owner = shuffle_plan.hot_owner(k)
        if owner != shard_index:
            continue
        row = k - shuffle_plan.boundaries[owner]
        counts[row] = hot_counts[i].to(counts.dtype)
        for leaf, hot in zip(leaves, hot_leaves):
            leaf[row] = hot[i].to(leaf.dtype)
    return pytree.tree_unflatten(leaves, treedef), counts


def _sort_range_tables(app, spec, lstream: col.PairStream, *, device,
                       use_kernels: bool, chunk_pairs: int,
                       bucket_size=None, level_fanouts=None):
    """One key range folded by the sort collector in ``chunk_pairs``
    pieces, to un-finalized ``(tables, counts)``.  The radix plan is the
    range's own (``K_local``): the all-to-all was radix level 0."""
    K_local = lstream.key_space
    bs, lf = _check_sort_kernel_plan(spec, K_local, app.value_spec,
                                     use_kernels, bucket_size, level_fanouts)
    sc = col.SortCombiner(spec, K_local, app.value_spec, device=device,
                          sort_fold_fn=_sort_fold_kernel(use_kernels, bs, lf))
    state = sc.init_state()
    n = lstream.keys.shape[0]
    for lo in range(0, n, chunk_pairs):
        hi = min(lo + chunk_pairs, n)
        state = sc.fold_chunk(state, col.PairStream(
            lstream.keys[lo:hi],
            pytree.tree_map(lambda v: v[lo:hi], lstream.values), K_local))
    return sc.tables_counts(state)


def _sort_range_fold(app, spec, lstream: col.PairStream, lo: int, *,
                     device, use_kernels: bool, chunk_pairs: int,
                     bucket_size=None, level_fanouts=None, hot_patch=None):
    """The sort flow's tail for one key range: fold, patch the merged hot
    rows (``hot_patch``), finalize."""
    tables, counts = _sort_range_tables(
        app, spec, lstream, device=device, use_kernels=use_kernels,
        chunk_pairs=chunk_pairs, bucket_size=bucket_size,
        level_fanouts=level_fanouts)
    if hot_patch is not None:
        tables, counts = hot_patch(tables, counts)
    return _finalize_rows(spec, tables, counts, lo)


def _distributed_tiling(app, plan, *, device, use_kernels: bool,
                        chunk_pairs, key_block):
    """The per-shard tiling: the given knobs, else the flow's tiling on
    ``device`` (the port's chunk does not depend on the item count)."""
    from repro_torch.core import autotune as at

    if plan.flow == "stream" and chunk_pairs is None:
        t = at.autotune_stream(app, plan.spec, device=device,
                               use_kernels=use_kernels)
        chunk_pairs = t.chunk_pairs
        if key_block is None and t.blocked:
            key_block = t.key_block
    if plan.flow == "sort" and chunk_pairs is None:
        chunk_pairs = at.autotune_sort(app, plan.spec, device=device,
                                       use_kernels=use_kernels).chunk_pairs
    return chunk_pairs, key_block


def _densify_ranges(keys, values, counts, shuffle_plan):
    """Scatter the concatenated boundary-range outputs into the dense
    ``keys == arange(K)`` layout: shard ``s``'s row ``i`` is authoritative
    iff ``i`` lies inside its boundary span (the rows past it pad to the
    widest span)."""
    K = shuffle_plan.key_space
    b = shuffle_plan.boundaries
    W = shuffle_plan.width
    spans = torch.tensor([b[s + 1] - b[s]
                          for s in range(shuffle_plan.num_shards)],
                         device=counts.device)
    auth = (torch.arange(W, device=counts.device)[None, :]
            < spans[:, None]).reshape(-1)
    slot = torch.where(auth, keys.to(torch.int64), K)
    dcounts = torch.zeros((K + 1,), dtype=counts.dtype, device=counts.device)
    dcounts[slot] = torch.where(auth, counts, 0)

    def dense(v):
        out = torch.zeros((K + 1,) + tuple(v.shape[1:]), dtype=v.dtype,
                          device=v.device)
        m = auth.reshape((-1,) + (1,) * (v.ndim - 1))
        out[slot] = torch.where(m, v, torch.zeros((), dtype=v.dtype,
                                                  device=v.device))
        return out[:K]

    return (torch.arange(K, dtype=torch.int32, device=counts.device),
            pytree.tree_map(dense, values), dcounts[:K])


def _surface_overflow(sinks, overflow, *, strict: bool,
                      shuffle_capacity) -> None:
    """Report shuffle overflow (``overflow``: the per-source-shard counts):
    ``ValueError`` under ``strict``, else a ``LoweringFallbackWarning`` on
    every call (an overflow makes the output wrong; it is not a lowering
    fallback to warn about once) and the message in each plan's
    ``diagnostics``."""
    counts = [int(x) for x in overflow.reshape(-1).tolist()]
    total = sum(counts)
    if total == 0:
        return
    msg = (f"distributed shuffle overflow: {total} pairs exceeded the "
           f"per-destination capacity "
           f"(shuffle_capacity={shuffle_capacity or 'auto(2x uniform)'}; "
           f"per-shard counts {counts}) and were dropped — the key "
           f"distribution is skewed past the bucket envelope; raise "
           f"shuffle_capacity (or rebalance the key ranges)")
    if strict:
        raise ValueError(msg)
    warnings.warn(msg, col.LoweringFallbackWarning, stacklevel=3)
    for plan in sinks:
        if msg not in plan.diagnostics:
            plan.diagnostics += (msg,)


class ShardedResult:
    """Where a distributed result's rows live: ``sharded`` rows are one
    block a shard (a ProcessGroupMesh rank holds its own), otherwise every
    shard holds them all.  :meth:`gather` assembles the global layout (a
    collective: every rank calls it)."""

    def __init__(self, mesh, sharded: bool):
        self.mesh = mesh
        self.sharded = sharded

    @property
    def local(self) -> bool:
        """True when the rows this process holds are only its own block."""
        return self.sharded and self.mesh.kind != "local"

    def gather(self, keys, values, counts):
        if not self.local:
            return keys, values, counts

        def g(x):
            got = self.mesh.all_gather([x])[0]
            return got.reshape((-1,) + tuple(x.shape[1:]))

        return g(keys), pytree.tree_map(g, values), g(counts)


class DistributedRun:
    """One flow of one plan over a shard mesh, prepared to dispatch (what
    the staged API's ``compile()`` caches in distributed mode).  Calling it
    with the global items runs the flow's stages and returns the raw
    per-shard outputs; :meth:`postprocess` reports overflow and assembles
    ``(keys, values, counts, layout)``.

    ``last_exchange`` records the last call's all-to-all: the wire format
    and the encoded bytes one shard sent; with ``time_exchange`` set, also
    the seconds of its stages on the host's clock (bucketize and encode,
    the all-to-all, decode), each closed by a device synchronization."""

    time_exchange = False

    def __init__(self, app, plan, *, mesh, combine_impl: str = "auto",
                 use_kernels: bool = False, scatter_output: bool = False,
                 shuffle_capacity: int | None = None,
                 chunk_pairs: int | None = None,
                 key_block: int | None = None,
                 bucket_size: int | None = None,
                 level_fanouts: tuple[int, ...] | None = None,
                 shuffle_plan=None, wire: str = "raw"):
        S = mesh.size
        if (shuffle_plan is not None and plan.flow in ("reduce", "sort")
                and shuffle_plan.num_shards != S):
            raise ValueError(
                f"shuffle_plan was derived for {shuffle_plan.num_shards} "
                f"shards but the mesh data axis has {S}")
        if (plan.flow == "reduce" and shuffle_plan is not None
                and shuffle_plan.hot_keys):
            raise ValueError(
                "hot-key splitting needs the sort flow's monoid tables; "
                "the reduce flow takes boundary rebalancing only")
        if plan.flow in ("stream", "sort") and chunk_pairs is None:
            raise ValueError(f"the distributed {plan.flow} flow needs its "
                             f"per-shard chunk_pairs (_distributed_tiling)")
        self.app = app
        self.plan = plan
        self.flow = plan.flow
        self.spec = plan.spec
        self.mesh = mesh
        self.device = mesh.device
        self.combine_impl = combine_impl
        self.use_kernels = use_kernels
        self.scatter_output = scatter_output
        self.shuffle_capacity = shuffle_capacity
        self.chunk_pairs = chunk_pairs
        self.key_block = key_block
        self.bucket_size = bucket_size
        self.level_fanouts = level_fanouts
        self.shuffle_plan = shuffle_plan
        self.wire = wire
        self.local_run = None
        if plan.flow == "stream":
            self.local_run = LocalRun(app, "stream", plan.spec,
                                      device=self.device,
                                      use_kernels=use_kernels,
                                      chunk_pairs=chunk_pairs,
                                      key_block=key_block)
        self.last_exchange: dict | None = None
        self._routes: list[str] = []
        self._formats: dict = {}
        #: a shard partial's layout (meta tensors), which the resilient
        #: driver holds a restored checkpoint to
        self.partial_example = None

    # -- the flows' stages ---------------------------------------------------

    def wire_format(self, shard_items_n: int):
        """The shuffle's ``wire.WireFormat`` for shards of
        ``shard_items_n`` items (``emit_capacity`` pairs each)."""
        fmt = self._formats.get(shard_items_n)
        if fmt is None:
            from repro_torch.distributed import wire as wirelib

            vs = self.app.value_spec
            n_pairs = shard_items_n * self.app.emit_capacity
            fmt = wirelib.wire_format(
                key_space=self.app.key_space, num_shards=self.mesh.size,
                n_pairs=n_pairs,
                value_avals=torch.empty((n_pairs,) + tuple(vs.shape),
                                        dtype=vs.dtype, device="meta"),
                codec=self.wire, capacity=self.shuffle_capacity,
                plan=self.shuffle_plan)
            self._formats[shard_items_n] = fmt
        return fmt

    def shard_partial(self, s: int, block):
        """Shard ``s``'s partial over its items ``block``, before any
        collective: ``{"tables", "counts"}`` for the stream flow
        (``LocalRun.tables`` at the run's tiling) and the combine flow
        (``_combine_local_tables``), the send side
        (:func:`_send_partial`) for the reduce and sort flows.  A pure
        function of the block: the resilient driver recomputes a lost
        shard with it, or restores it from a checkpoint."""
        if self.flow == "stream":
            tables, counts = self.local_run.tables(block)[1:]
            return {"tables": tables, "counts": counts}
        stream = map_phase(self.app, block, self.device)
        if self.flow == "combine":
            tables, counts = _combine_local_tables(
                self.app, self.spec, stream, combine_impl=self.combine_impl,
                use_kernels=self.use_kernels, routes=self._routes)
            return {"tables": tables, "counts": counts}
        return _send_partial(stream, self.wire_format(items_length(block)),
                             self.shuffle_plan)

    def shard_tables(self, items) -> list:
        """The stream or combine flow's per-shard partial ``(tables,
        counts)`` before any collective (the shards of ``mesh.shards()``)."""
        blocks = shard_items(items, self.mesh.size)
        parts = [self.shard_partial(s, blocks[s]) for s in self.mesh.shards()]
        return [(p["tables"], p["counts"]) for p in parts]

    def _merge_flow(self, items):
        parts = self.shard_tables(items)
        return _merge_shard_tables(
            self.app, self.spec, [p[0] for p in parts], [p[1] for p in parts],
            self.mesh, scatter=self.scatter_output), None

    def _shuffle_flow(self, items):
        import time

        mesh, app = self.mesh, self.app
        blocks = shard_items(items, mesh.size)
        fmt = self.wire_format(items_length(blocks[0]))
        streams = [map_phase(app, blocks[s], self.device)
                   for s in mesh.shards()]
        stamps: dict[str, float] = {}
        clock = None
        if self.time_exchange:
            def clock(stage, last=[None]):
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                now = time.perf_counter()
                if last[0] is not None:
                    stamps[stage] = now - last[0]
                last[0] = now

            clock("start")
        sends = [_send_partial(st, fmt, self.shuffle_plan) for st in streams]
        if clock is not None:
            clock("encode")
        return self.shuffle_receive(sends, fmt, clock=clock, stamps=stamps)

    def shuffle_receive(self, sends, fmt, *, clock=None, stamps=None):
        """The reduce and sort flows after the send side: ``sends`` holds
        the send partials (:meth:`shard_partial`) of ``mesh.shards()``.
        The all-to-all of every encoded leaf, the receive side of each
        range (:func:`_recv_range`), then the range folds (the hot-split
        merge and patch under a skew plan with hot keys).  Returns the
        per-shard outputs and the all-gathered overflow counts.
        ``clock``, when given, is called after the all-to-all and the
        decode (``DistributedRun.time_exchange``)."""
        from repro_torch.distributed import wire as wirelib

        tick = clock if clock is not None else (lambda stage: None)
        mesh, app, S = self.mesh, self.app, self.mesh.size
        encs = [p["wire"] for p in sends]
        leaves = _stack_leaves(encs)
        treedef = pytree.tree_structure(encs[0])
        recv_leaves = [mesh.all_to_all([ls[i] for ls in leaves])
                       for i in range(len(leaves[0]))]
        tick("all_to_all")
        recv = [_recv_range(app, fmt,
                            pytree.tree_unflatten([r[j] for r in recv_leaves],
                                                  treedef),
                            d, num_shards=S, shuffle_plan=self.shuffle_plan)
                for j, d in enumerate(mesh.shards())]
        tick("decode")
        self.last_exchange = {"format": fmt,
                              "sent_bytes": wirelib.tree_nbytes(encs[0]),
                              "seconds": stamps if stamps is not None else {}}
        overflow = mesh.all_gather([p["overflow"].reshape(1)
                                    for p in sends])[0]
        if self.flow == "reduce":
            return [_reduce_range(app, ls, lo) for ls, lo, _ in recv], overflow
        splan = self.shuffle_plan
        hot = None
        if splan is not None and splan.hot_keys:
            parts = [_fold_hot_tables(app, self.spec, fk, fv, splan,
                                      device=self.device,
                                      use_kernels=self.use_kernels)
                     for _, _, (fk, fv) in recv]
            hot = merge_tables_collective(
                self.spec, [p[0] for p in parts], [p[1] for p in parts],
                mesh)
        outs = []
        for j, (s, (ls, lo, _)) in enumerate(zip(mesh.shards(), recv)):
            patch = None
            if hot is not None:
                def patch(t, c, j=j, s=s):
                    return _patch_hot_rows(t, c, hot[0][j], hot[1][j],
                                           splan, s)
            outs.append(_sort_range_fold(
                app, self.spec, ls, lo, device=self.device,
                use_kernels=self.use_kernels, chunk_pairs=self.chunk_pairs,
                bucket_size=self.bucket_size,
                level_fanouts=self.level_fanouts, hot_patch=patch))
        return outs, overflow

    def __call__(self, items, *, sinks=()):
        """The per-shard outputs ``(keys, values, counts)`` of
        ``mesh.shards()`` and the all-gathered overflow counts (None for
        the stream and combine flows).  ``sinks``: the plans a combine run
        records its lowering on."""
        self._routes: list[str] = []
        if self.flow in ("stream", "combine"):
            outs, overflow = self._merge_flow(items)
        else:
            outs, overflow = self._shuffle_flow(items)
        if self.flow == "combine" and self._routes:
            for plan in sinks:
                plan.lowering = (f"distributed over {self.mesh.size} shards: "
                                 f"{self._routes[0]}")
        return outs, overflow

    @property
    def sharded(self) -> bool:
        return self.flow in ("reduce", "sort") or self.scatter_output

    def postprocess(self, out, *, strict_shuffle: bool = False, sinks=()):
        """Report overflow, then assemble the global layout: stream and
        combine results replicated ``[K]`` (key-sharded with
        ``scatter_output``), reduce and sort results key-sharded
        ``[S·K_local]``, densified to ``[K]`` under a skew plan.  On a
        LocalMesh the rows are global; a ProcessGroupMesh rank keeps its
        own block (``ShardedResult.gather``), except under a skew plan,
        whose densified rows every rank gathers.  Returns ``(keys, values,
        counts, layout)``."""
        outs, overflow = out
        if overflow is not None:
            _surface_overflow(sinks, overflow, strict=strict_shuffle,
                              shuffle_capacity=self.shuffle_capacity)
        layout = ShardedResult(self.mesh, self.sharded)
        if not self.sharded:
            keys, values, counts = outs[0]
            return keys, values, counts, layout
        keys = torch.cat([o[0] for o in outs])
        values = pytree.tree_map(lambda *vs: torch.cat(vs),
                                 *[o[1] for o in outs])
        counts = torch.cat([o[2] for o in outs])
        if self.shuffle_plan is not None and self.flow in ("reduce", "sort"):
            keys, values, counts = layout.gather(keys, values, counts)
            layout = ShardedResult(self.mesh, False)
            keys, values, counts = _densify_ranges(keys, values, counts,
                                                   self.shuffle_plan)
        return keys, values, counts, layout

    def launch_plan(self, n_items: int) -> str:
        """The shard bodies' launches and the mesh's collectives."""
        S = self.mesh.size
        per = n_items // S if S else n_items
        lines = [f"distributed {self.flow} over {self.mesh.signature()}: "
                 f"{S} shards of {per} items"]
        if self.flow == "stream":
            lines.append("per shard: " + self.local_run.launch_plan(per)
                         .replace("\n", "\n  "))
            lines.append("merge: counts and integer leaves psum; float "
                         "leaves all-gathered, reduced in shard order")
        elif self.flow == "combine":
            lines.append(f"per shard: map, then the combine lowering by "
                         f"combine_impl={self.combine_impl!r}; merge as the "
                         f"stream flow's")
        else:
            lines.append(f"per shard: map, bucketize, encode ({self.wire}), "
                         f"all-to-all of every encoded leaf, decode, then "
                         + ("the reduce flow over the shard's key range"
                            if self.flow == "reduce" else
                            "the sort collector over the shard's key range "
                            "(its own radix plan)"))
        return "\n".join(lines)


def build_distributed_fn(app, plan, *, mesh, **knobs):
    """The distributed run of ``plan`` over ``mesh``: ``(run,
    postprocess)``, the reference's pair.  ``run(items)`` gives the raw
    per-shard outputs; ``postprocess(out, strict_shuffle=..., sinks=...)``
    reports overflow and returns ``(keys, values, counts, layout)``.
    ``chunk_pairs`` / ``key_block`` are the per-shard tiling
    (:func:`_distributed_tiling`)."""
    run = DistributedRun(app, plan, mesh=mesh, **knobs)
    return run, run.postprocess


def run_distributed(app, plan, items, *, mesh, combine_impl: str = "auto",
                    use_kernels: bool = False, scatter_output: bool = False,
                    shuffle_capacity: int | None = None,
                    chunk_pairs: int | None = None,
                    key_block: int | None = None,
                    bucket_size: int | None = None,
                    level_fanouts: tuple[int, ...] | None = None,
                    strict_shuffle: bool = False, shuffle_plan=None,
                    wire: str = "raw", sinks=None):
    """Run the planned flow over the shards of ``mesh`` (the engine layer;
    ``MapReduce.run_distributed`` is the user's).  Returns ``(keys, values,
    counts)`` in the global layout on a LocalMesh, and each rank's rows on
    a ProcessGroupMesh (see :meth:`DistributedRun.postprocess`).

    The reduce and sort flows' all-to-all counts the pairs past the
    per-destination capacity: a nonzero count warns
    (``LoweringFallbackWarning``) and lands in ``plan.diagnostics``, or
    raises ``ValueError`` under ``strict_shuffle``."""
    chunk_pairs, key_block = _distributed_tiling(
        app, plan, device=mesh.device, use_kernels=use_kernels,
        chunk_pairs=chunk_pairs, key_block=key_block)
    run, post = build_distributed_fn(
        app, plan, mesh=mesh, combine_impl=combine_impl,
        use_kernels=use_kernels, scatter_output=scatter_output,
        shuffle_capacity=shuffle_capacity, chunk_pairs=chunk_pairs,
        key_block=key_block, bucket_size=bucket_size,
        level_fanouts=level_fanouts, shuffle_plan=shuffle_plan, wire=wire)
    sinks = (plan,) if sinks is None else tuple(sinks)
    items = pytree.tree_map(lambda a: torch.as_tensor(a).to(mesh.device),
                            items)
    with torch.no_grad():
        keys, values, counts, _ = post(run(items, sinks=sinks),
                                       strict_shuffle=strict_shuffle,
                                       sinks=sinks)
    return keys, values, counts


# ---------------------------------------------------------------------------
# Resilience (A12): the fault-tolerant driver over the shards
# ---------------------------------------------------------------------------


def _leaf_sig(tree) -> list:
    """(shape, dtype) of each leaf, in the checkpoint's leaf order."""
    from repro_torch.checkpoint import ckpt

    return [(tuple(x.shape), x.dtype) for x in ckpt.flatten(tree)[0]]


def _partial_to(tree, device):
    """A restored partial's leaves on ``device``; the uint32 wire epoch
    stays on the host (C.47)."""
    return pytree.tree_map(
        lambda x: x if x.dtype == torch.uint32 else x.to(device), tree)


def resilient_run(app, plan, *, num_shards: int, shard_items_n: int, device,
                  combine_impl: str = "auto", use_kernels: bool = False,
                  shuffle_capacity=None, chunk_pairs=None, key_block=None,
                  bucket_size=None, level_fanouts=None, shuffle_plan=None,
                  wire: str = "raw", jit_cache: dict | None = None):
    """The prepared per-shard run of a resilient drill: a
    :class:`DistributedRun` over ``LocalMesh(num_shards, device)``, whose
    :meth:`~DistributedRun.shard_partial` computes a shard's partial and
    whose receive side (:meth:`~DistributedRun.shuffle_receive`) is phase
    B of the reduce and sort flows, with the tiling of
    :func:`_distributed_tiling`: the code and the tiling of
    ``run_distributed`` over the same shards.  ``jit_cache`` (held by the
    caller, e.g. a ``MapReduce``) keeps it across calls, keyed by every
    knob it binds."""
    from repro_torch.distributed.mesh import LocalMesh

    if plan.flow not in ("reduce", "sort"):
        shuffle_plan = None  # the stream and combine flows route nothing
    chunk_pairs, key_block = _distributed_tiling(
        app, plan, device=device, use_kernels=use_kernels,
        chunk_pairs=chunk_pairs, key_block=key_block)
    cache = jit_cache if jit_cache is not None else {}
    key = ("run", plan.flow, num_shards, shard_items_n, chunk_pairs,
           key_block, use_kernels, combine_impl, shuffle_capacity,
           bucket_size, level_fanouts, wire,
           shuffle_plan.epoch if shuffle_plan is not None else None,
           str(device))
    run = cache.get(key)
    if run is None:
        run = cache[key] = DistributedRun(
            app, plan, mesh=LocalMesh(num_shards, device),
            combine_impl=combine_impl, use_kernels=use_kernels,
            shuffle_capacity=shuffle_capacity, chunk_pairs=chunk_pairs,
            key_block=key_block, bucket_size=bucket_size,
            level_fanouts=level_fanouts, shuffle_plan=shuffle_plan,
            wire=wire)
    return run


def run_resilient(app, plan, items, *, mesh=None,
                  num_hosts: int | None = None,
                  num_shards: int | None = None, data_axis: str = "data",
                  step: int = 0, ckpt_dir: str | None = None, inject=None,
                  timeout_s: float = 60.0, straggler_lag: int = 1,
                  combine_impl: str = "auto", use_kernels: bool = False,
                  shuffle_capacity: int | None = None,
                  chunk_pairs: int | None = None,
                  key_block: int | None = None,
                  bucket_size: int | None = None,
                  level_fanouts: tuple[int, ...] | None = None,
                  strict_shuffle: bool = False, shuffle_plan=None,
                  wire: str = "raw", coord=None, retry=None, chaos=None,
                  jit_cache: dict | None = None, device=None, sinks=None):
    """Fault-tolerant distributed MapReduce driver, the counterpart of the
    reference's ``engine.run_resilient`` step for step.

    Runs ``plan.flow`` over ``items`` split into ``num_shards`` shards,
    assigned to ``num_hosts`` hosts by ``fault.shard_for``, and survives:

    * **shard loss**: a shard's partial (its holder tables in the stream
      and combine flows, its encoded all-to-all sends in the reduce and
      sort flows) is a pure function of its items, so a lost shard is
      recomputed on the deterministic backup rank
      (``fault.backup_assignment``) with the same bits;
    * **partial recovery**: with ``ckpt_dir``, each partial lands in
      ``ckpt.shard_partial_dir(ckpt_dir, shard)`` and recovery restores it
      in preference to recomputing.  A restored tree must have the
      partial's structure, leaf shapes and dtypes, and in the reduce and
      sort flows this run's wire epoch; else it is rejected
      (``log.epoch_rejects``) and the shard recomputed;
    * **stragglers**: a lagging host's shards are re-executed on the
      backup rank;
    * **elastic resize** (``inject.resize_to``): the mesh continues on
      ``elastic.best_mesh`` and only the partials lost with the removed
      hosts are rerun; the shard count, and so the key ranges, is fixed.

    Detection runs a ``fault.HeartbeatMonitor`` on a synthetic clock.
    With ``coord`` (a ``coordination.CoordinationStore``, a ``KVStore`` or
    a directory), ``retry`` or ``chaos`` the control plane moves onto a
    durable store: heartbeat records, a coordinator lease, the ledger of
    completed shards, a bounded retry for every store operation, and the
    ``chaos.ChaosPlan`` drills.  Nothing sleeps for real: the store's
    sleep advances the synthetic clock.

    Every shard runs in this process on ``device`` (``mesh.device``, else
    ``device``; ``None``: the card), as the reference's mesh-less driver
    runs them; a ``ProcessGroupMesh`` of more than one rank raises (C.48).
    A shard's partial and phase B are the code of ``run_distributed`` over
    ``LocalMesh(num_shards)`` (:func:`resilient_run`), so the result is
    that run's, bit for bit.  Returns ``(keys, values, counts, log)``,
    the log a ``fault.RecoveryLog`` whose summary lands on the
    ``recovery`` of each plan of ``sinks`` (default: ``plan``)."""
    import os

    from repro_torch.checkpoint import ckpt
    from repro_torch.device import resolve_device
    from repro_torch.distributed import chaos as chaoslib
    from repro_torch.distributed import coordination as coordlib
    from repro_torch.distributed import fault as flt

    inject = inject if inject is not None else flt.FaultInjection()
    mesh_hosts = None
    if mesh is not None:
        if mesh.kind != "local" and mesh.size > 1:
            raise NotImplementedError(
                f"run_resilient drives every shard in one process (ROADMAP "
                f"C.48); a ProcessGroupMesh of {mesh.size} ranks would run "
                f"the whole drill on each rank.  Use LocalMesh(S) or world "
                f"size 1")
        if mesh.axis_name != data_axis:
            raise ValueError(f"the mesh has no data axis {data_axis!r} (its "
                             f"axis is {mesh.axis_name!r})")
        mesh_hosts = mesh.size
        dev = mesh.device
    else:
        dev = resolve_device(device)
    H = num_hosts if num_hosts is not None else (mesh_hosts or 1)
    S = num_shards if num_shards is not None else (mesh_hosts or H)
    if H <= 0 or S <= 0:
        raise ValueError(f"need positive host/shard counts, got {H}/{S}")
    n_items = items_length(items)
    if n_items % S:
        raise ValueError(
            f"n_items={n_items} must divide into num_shards={S} (the same "
            f"contract as the mesh's data-axis split)")
    per = n_items // S
    spec, flow = plan.spec, plan.flow
    sinks = (plan,) if sinks is None else tuple(sinks)
    if flow in ("stream", "sort", "combine") and spec is None:
        raise ValueError(f"{flow} flow needs a derived combiner spec")
    if flow in ("reduce", "sort"):
        if (shuffle_plan is not None and shuffle_plan.hot_keys
                and flow != "sort"):
            raise ValueError(
                "hot-key splitting needs the sort flow's monoid tables; "
                "the reduce flow takes boundary rebalancing only")
        if shuffle_plan is not None and shuffle_plan.num_shards != S:
            raise ValueError(
                f"shuffle_plan was derived for {shuffle_plan.num_shards} "
                f"shards but run_resilient partitions into {S}")
    run = resilient_run(
        app, plan, num_shards=S, shard_items_n=per, device=dev,
        combine_impl=combine_impl, use_kernels=use_kernels,
        shuffle_capacity=shuffle_capacity, chunk_pairs=chunk_pairs,
        key_block=key_block, bucket_size=bucket_size,
        level_fanouts=level_fanouts, shuffle_plan=shuffle_plan, wire=wire,
        jit_cache=jit_cache)
    run._routes = []
    fmt = run.wire_format(per) if flow in ("reduce", "sort") else None
    items = pytree.tree_map(lambda a: torch.as_tensor(a).to(dev), items)

    def shard_slice(s: int):
        return pytree.tree_map(lambda a: a[s * per:(s + 1) * per], items)

    def remember(p) -> None:
        # the partial's layout, as meta tensors: what a restore is held to
        run.partial_example = pytree.tree_map(
            lambda x: torch.empty(tuple(x.shape), dtype=x.dtype,
                                  device="meta"), p)

    def partial_fn(s: int):
        p = run.shard_partial(s, shard_slice(s))
        if run.partial_example is None:
            remember(p)
        return p

    def save_partial(s: int, p) -> None:
        if ckpt_dir is None:
            return

        def _save():
            ckpt.save(ckpt.shard_partial_dir(ckpt_dir, s), step, p)

        if coord is not None:
            coord.retried(f"save shard {s} partial", _save, kind="ckpt")
        else:
            _save()

    def layout_reject(s: int):
        log.epoch_rejects.append(s)
        events.append(
            f"checkpoint: shard {s} partial has a different wire layout "
            f"than this run (codec/shape mismatch); discarded and the "
            f"deterministic recompute takes over")

    def try_restore(s: int):
        """Restore a shard's durable partial; a checksum failure is
        quarantined and logged, a partial of another layout or wire epoch
        rejected, and the caller recomputes the shard (the same bits)."""
        if ckpt_dir is None:
            return None
        d = ckpt.shard_partial_dir(ckpt_dir, s)
        if not ckpt.has_step(d, step):
            return None
        if run.partial_example is None:
            # nothing computed yet in this process: the layout to hold
            # the checkpoint to is that of a partial of this run
            remember(run.shard_partial(s, shard_slice(s)))
        example = run.partial_example

        def _load():
            return ckpt.restore(d, example, step=step, device="cpu")

        try:
            if coord is not None:
                tree, _ = coord.retried(f"restore shard {s} partial", _load,
                                        kind="ckpt")
            else:
                tree, _ = _load()
        except ckpt.CheckpointCorruptError as e:
            log.corrupt.append(s)
            events.append(
                f"checkpoint: shard {s} partial failed verification "
                f"({e.reason}); quarantined, falling back to "
                f"deterministic recompute")
            return None
        except (ValueError, KeyError):
            layout_reject(s)
            return None
        if flow in ("reduce", "sort"):
            got = int(tree["wire_epoch"].reshape(-1)[0])
            if got != fmt.epoch:
                log.epoch_rejects.append(s)
                events.append(
                    f"checkpoint: shard {s} partial carries wire epoch "
                    f"{got} != this run's {fmt.epoch} (the skew "
                    f"boundaries or wire codec changed between runs); "
                    f"discarded — its send buckets mean different key "
                    f"ranges or bits — and the deterministic recompute "
                    f"takes over")
                return None
        if _leaf_sig(tree) != _leaf_sig(example):
            layout_reject(s)
            return None
        return _partial_to(tree, dev)

    # -- durable control plane: coordination store + chaos resolution -------
    log = flt.RecoveryLog(num_hosts=H, num_shards=S, step=step)
    clock = flt.StepClock()
    coordinated = coord is not None or chaos is not None or retry is not None
    lease = None
    partitioned: set[int] = set()
    if coordinated:
        if isinstance(coord, coordlib.CoordinationStore):
            coord.clock = clock  # rebind onto the drill's synthetic clock
            coord.sleep = clock.advance
            if retry is not None:
                coord.retry = retry
        else:
            if isinstance(coord, coordlib.KVStore):
                kv = coord
            elif isinstance(coord, str):
                kv = coordlib.FileKVStore(coord)
            elif ckpt_dir is not None:
                kv = coordlib.FileKVStore(os.path.join(ckpt_dir, "coord"))
            else:
                kv = coordlib.MemKVStore()
            coord = coordlib.CoordinationStore(
                kv, retry=retry, lease_ttl_s=timeout_s, clock=clock,
                sleep=clock.advance)
        events = coord.events
        coordinator = coordlib.elect(range(H))
        if chaos is not None:
            inject = chaos.resolve_injection(inject, coordinator)
            partitioned = set(chaos.partition_hosts)
            if chaos.store_fail_ops:
                coord.inject_store_faults(chaos.store_fail_ops,
                                          chaos.store_fail_kinds)
            for line in chaos.describe():
                events.append(f"chaos: {line}")
        mon = coordlib.DurableHeartbeatMonitor(coord, H, timeout_s=timeout_s,
                                               clock=clock)
        for ph in partitioned:
            mon.partition(ph)
        lease = coord.adopt(coordinator, range(H))
        log.coordinator = coordinator
    else:
        coord = None
        events = []
        mon = flt.HeartbeatMonitor(H, timeout_s=timeout_s, clock=clock)

    with torch.no_grad():
        # -- phase A: primary execution under the stateless assignment ------
        dead_script = set(inject.dead_hosts)
        strag_script = set(inject.straggler_hosts)
        owner = {s: h for h in range(H) for s in flt.shard_for(step, h, H, S)}
        partials: dict = {}
        computed_by: dict[int, int] = {}
        progress = {h: 0 for h in range(H)}
        for h in range(H):
            for j, s in enumerate(flt.shard_for(step, h, H, S)):
                clock.advance(1.0)
                if h in dead_script and j >= inject.die_after_shards:
                    break  # the host crashes: no more work, no more beats
                if h in strag_script:
                    mon.beat(h, step=0)  # alive, but no progress this round
                    continue
                if h in partitioned:
                    # the host computes, but nothing it does reaches the
                    # cluster: beats, checkpoints and partials are dropped
                    partial_fn(s)
                    progress[h] = j + 1
                    mon.beat(h, step=progress[h])  # dropped by the monitor
                    continue
                p = partial_fn(s)
                if h not in dead_script or inject.checkpoint_survives:
                    save_partial(s, p)
                if h not in dead_script:
                    # a dying host's in-memory partial dies with it; only
                    # its checkpoint (if any) outlives the crash
                    partials[s] = p
                if coord is not None:
                    # the worker writes its ledger record itself, so the
                    # ledger survives a coordinator death
                    coord.record_shard(s, h, step)
                computed_by[s] = h
                log.computed.append((s, h))
                progress[h] = j + 1
                mon.beat(h, step=progress[h])

        # -- chaos: corrupt durable partials (and the memory that held them)
        if chaos is not None and chaos.corrupt_shards:
            for s in chaos.corrupt_shards:
                partials.pop(s, None)  # the holder's memory died with it
                if ckpt_dir is None:
                    continue
                if chaoslib.corrupt_shard_partial(ckpt_dir, s, step) is None:
                    continue
                d = ckpt.shard_partial_dir(ckpt_dir, s)
                try:
                    ckpt.verify_step(d, step)
                except ckpt.CheckpointCorruptError as e:
                    ckpt.quarantine_step(d, step)
                    log.corrupt.append(s)
                    events.append(
                        f"checkpoint: shard {s} partial failed verification "
                        f"({e.reason}); quarantined to *.corrupt, "
                        f"deterministic recompute scheduled")

        # -- failure detection: healthy hosts keep beating while the
        # coordinator waits out the timeout; crashed hosts stay silent.  A
        # host that finished its whole assignment beats step S: under an
        # uneven split it owns fewer shards, and is no straggler for it
        clock.advance(mon.timeout_s + mon.grace_s + 1.0)
        for h in range(H):
            if h not in dead_script:
                owned = len(flt.shard_for(step, h, H, S))
                mon.beat(h, step=(S if progress[h] >= owned else progress[h]))
                if (lease is not None and h == lease.holder
                        and h not in partitioned):
                    lease = coord.renew(lease)  # a healthy coordinator
        detected_dead = mon.dead_hosts()
        detected_strag = mon.stragglers(lag=straggler_lag)
        log.dead_hosts = list(detected_dead)
        log.straggler_hosts = list(detected_strag)
        alive = mon.alive_hosts()
        backup_pool = [a for a in alive if a not in set(detected_strag)] or alive

        # -- lease failover: when the coordinator's lease lapsed (holder
        # dead or partitioned), the lowest live rank adopts the lease and
        # the durable ledger and resumes phase B from the store's partials
        if coord is not None and alive:
            cur = coord.lease()
            now = clock()
            if cur is not None and (cur.holder not in alive
                                    or cur.expires_at <= now):
                new_holder = coordlib.elect(alive)
                lease = coord.adopt(new_holder, alive)
                ledger = coord.load_ledger(step)
                log.failover = (cur.holder, new_holder, lease.epoch)
                events.append(
                    f"failover: host {new_holder} adopted the recovery "
                    f"ledger ({len(ledger)} durable shard records) at epoch "
                    f"{lease.epoch}; resuming phase B from durable partials")

        def recover(s: int, failed_host: int, ledger: list) -> None:
            backup, _ = flt.backup_assignment(step, failed_host, H, S,
                                              alive=backup_pool)
            restored = try_restore(s)
            if restored is not None:
                partials[s] = restored
                computed_by[s] = backup  # the restoring rank holds it now
                log.restored.append(s)
                return
            p = partial_fn(s)  # deterministic re-execution
            partials[s] = p
            computed_by[s] = backup
            save_partial(s, p)
            ledger.append((s, backup))

        for h in detected_dead:
            for s in flt.shard_for(step, h, H, S):
                if s not in partials:
                    recover(s, h, log.recomputed)
        for h in detected_strag:
            for s in flt.shard_for(step, h, H, S):
                if s not in partials:
                    recover(s, h, log.speculated)

        # -- elastic host-count change: remesh, rerun only what was lost ---
        final_mesh = mesh
        if inject.resize_to is not None and inject.resize_to != H:
            new_H = inject.resize_to
            if new_H <= 0:
                raise ValueError(f"resize_to must be positive, got {new_H}")
            if mesh is not None:
                from repro_torch.distributed import elastic

                final_mesh = elastic.best_mesh(mesh, new_H)
            new_owner = {s: h for h in range(new_H)
                         for s in flt.shard_for(step, h, new_H, S)}
            log.moved = sorted(s for s in range(S)
                               if new_owner[s] != owner[s])
            removed = set(range(new_H, H))
            for s in list(partials):
                if computed_by.get(s) in removed:
                    del partials[s]  # left with the departing host's memory
            for s in range(S):
                if s in partials:
                    continue
                restored = try_restore(s)
                if restored is not None:
                    partials[s] = restored
                    computed_by[s] = new_owner[s]
                    log.restored.append(s)
                else:
                    partials[s] = partial_fn(s)
                    computed_by[s] = new_owner[s]
                    save_partial(s, partials[s])
                    log.recomputed.append((s, new_owner[s]))
            log.resized = (H, new_H)
            H = new_H
            owner = new_owner

        # -- completeness sweep: a shard still missing (an undetected loss)
        # is re-executed by its owner; no shard is ever silently absent --
        for s in range(S):
            if s not in partials:
                partials[s] = partial_fn(s)
                computed_by[s] = owner[s]
                save_partial(s, partials[s])
                log.recomputed.append((s, owner[s]))

        # -- phase B: monoid merge (tables) or the key-range folds ---------
        ordered = [partials[s] for s in range(S)]
        if flow in ("stream", "combine"):
            keys, values, counts = merge_partial_tables(
                app, spec, [p["tables"] for p in ordered],
                [p["counts"] for p in ordered])
        else:
            log.shuffle_overflow = tuple(int(p["overflow"]) for p in ordered)
            keys, values, counts, _ = run.postprocess(
                run.shuffle_receive(ordered, fmt),
                strict_shuffle=strict_shuffle, sinks=sinks)

    if shuffle_plan is not None and flow in ("reduce", "sort"):
        log.skew_plan = shuffle_plan.describe()
        log.boundary_epoch = int(shuffle_plan.epoch)
    log.final_mesh = final_mesh
    log.partitioned = sorted(partitioned)
    log.store_events = tuple(events)
    summary = tuple(log.summary())
    for p in sinks:
        p.recovery += summary
    return keys, values, counts, log

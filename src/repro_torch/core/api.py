"""Public API of the port — ``MapReduce(app).run(items)`` and its stages.

Counterpart of the local part of ``repro/core/api.py``.  The user writes
``map`` and ``reduce`` with torch ops::

    class WordCount(MapReduceApp):
        key_space = VOCAB
        value_spec = ValueSpec((), torch.int32)

        def map(self, window, emit):        # window: [16] token ids
            emit(window, torch.ones_like(window))

        def reduce(self, key, values, count):
            return values.sum()

    result = MapReduce(WordCount()).run(token_windows)

The staged path, as in the reference::

    mr = MapReduce(WordCount())           # plan stage (cached by content)
    lowered = mr.lower(items)             # bind an item spec
    optimized = lowered.optimize()        # bind execution options
    compiled = optimized.compile()        # prepare the run (cached)
    result = compiled(items)              # dispatch only

``run()`` is ``lower().optimize().compile()(items)``, and every stage
answers ``explain()``.  The card has no XLA executable: what ``compile()``
makes and caches is the prepared run (``engine.LocalRun``): the resolved
knobs, the built collector and tiling, and, on the card, the kernel
libraries loaded by one warm-up call on zeros of the bound shape.  A call
dispatches the kernels eagerly, in the order ``run()`` always did, with
no re-planning, re-tuning or rebuilding, and returns fresh tensors.
Capturing a compiled call in a CUDA graph is queued (ROADMAP): a graph
keeps its memory pool while cached, and a call still synchronizes with
the host.  ``items_bucket="pow2"`` lets the batch sizes of one power-of-two
bucket share a compiled entry; a padded call folds only its first
``n_valid`` items (``engine.fold_items_chunked``), so it gives the bits of
the exact call.

The run happens on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without ``device="cpu"`` the constructor raises.
``use_kernels`` (default: on when the device is CUDA) routes the folds
through the hand-written kernels.  All four flows run: stream, sort,
combine and reduce (the paper's baseline, also the ``flow="auto"`` choice
for a reducer the optimizer cannot turn into a combiner).

Long-lived serving: ``MapReduce(app, streaming=True).serve(...)`` stages
the plan at mode="streaming" into a
:class:`repro_torch.streaming.MapReduceService`: micro-batches fold into
persistent holder tables, with windows, live snapshots and checkpointed
warm restarts.  The distributed and resilient modes are not ported yet
(ROADMAP A11, A12).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import autotune as at
from repro_torch.core import collector as col
from repro_torch.core import combiner as C
from repro_torch.core import cost_model as cm
from repro_torch.core import engine as eng
from repro_torch.core import plan_cache as pc
from repro_torch.core.plan import (ExecutionPlan, _model_holder_bytes,
                                   plan_execution)
from repro_torch.device import resolve_device
from repro_torch.roofline import analysis as roofline


class MapReduceApp:
    """Subclass and provide map/reduce; set the class attributes.

    key_space: dense key-id capacity K (keys are int32 in [0, K)).
    value_spec: shape and dtype of one emitted value.
    emit_capacity: max pairs one ``map(item, emit)`` call may emit.
    max_values_per_key: Lmax of the reduce flow: a key's first Lmax values
    (in emission order) fill its window, padded with ``pad_value``.
    """

    key_space: int = 0
    value_spec: C.ValueSpec = C.ValueSpec((), torch.float32)
    pad_value: Any = 0
    max_values_per_key: int = 64
    emit_capacity: int = 16

    def map(self, item, emit) -> None:
        raise NotImplementedError

    def reduce(self, key, values, count):
        raise NotImplementedError

    #: a hand-written combiner that bypasses the optimizer
    manual_combiner: C.CombinerSpec | None = None


def make_app(map_fn: Callable, reduce_fn: Callable, **attrs) -> MapReduceApp:
    app = MapReduceApp()
    app.map = map_fn  # type: ignore[method-assign]
    app.reduce = reduce_fn  # type: ignore[method-assign]
    for k, v in attrs.items():
        setattr(app, k, v)
    return app


Emitter = eng.Emitter

#: the ROADMAP item that ports each mode not ported yet
MODE_ITEMS = {"distributed": "A11 (distribution)",
              "resilient": "A12 (resilience)"}


@dataclasses.dataclass(frozen=True)
class ExecutionOptions:
    """Run-time overrides of the lowering; ``None`` keeps the MapReduce
    constructor's choice.  ``combine_impl`` is the combine flow's
    (``auto``, ``onehot``, ``scatter``, ``first``, ``segment``);
    ``key_block`` the stream flow's; ``bucket_size`` (the leaf bucket) and
    ``level_fanouts`` (the radix levels) the sort flow's.
    ``items_bucket="pow2"`` lets batch sizes of one power-of-two bucket
    share a compiled entry (rows past N are never folded);
    ``cache=False`` bypasses the compiled-stage cache."""

    combine_impl: str | None = None
    use_kernels: bool | None = None
    chunk_pairs: int | None = None
    key_block: int | None = None
    bucket_size: int | None = None
    level_fanouts: tuple[int, ...] | None = None
    items_bucket: str = "exact"
    cache: bool = True


_OPTION_FIELDS = {f.name for f in dataclasses.fields(ExecutionOptions)}


def _resolve_options(options: ExecutionOptions | None, legacy: dict, *,
                     method: str) -> ExecutionOptions:
    """The options record; scattered keyword arguments raise ``TypeError``
    (the reference's rule): an option's name with a pointer at
    ``ExecutionOptions``, anything else as unexpected."""
    if legacy:
        retired = sorted(set(legacy) & _OPTION_FIELDS)
        if retired:
            raise TypeError(
                f"{method}({', '.join(retired)}=...) scattered keyword "
                f"arguments are not taken; pass "
                f"options=ExecutionOptions({retired[0]}=...) instead")
        raise TypeError(f"{method}() got unexpected keyword arguments "
                        f"{sorted(legacy)}")
    return options if options is not None else ExecutionOptions()


@dataclasses.dataclass
class MapReduceResult:
    """The result record of every entry point: ``run()``, a compiled call
    and ``MapReduceService.snapshot()``, which also sets ``batch_id``."""

    keys: torch.Tensor  # [K] = arange(K)
    values: Any  # [K, ...]
    counts: torch.Tensor  # [K]; 0 == key never emitted
    plan: ExecutionPlan | None = None
    #: micro-batches folded in, when the result is a service snapshot
    batch_id: int | None = None

    @property
    def diagnostics(self) -> tuple[str, ...]:
        return self.plan.diagnostics if self.plan is not None else ()

    def to_dict(self) -> dict:
        """Host-side {key: value} for present keys (tests, small results)."""
        counts = self.counts.cpu().numpy()
        vals = pytree.tree_map(lambda v: v.cpu().numpy(), self.values)
        return {int(k): pytree.tree_map(lambda v: v[k], vals)
                for k in np.nonzero(counts > 0)[0]}


def to_device(items, device):
    """Items (tensors or numpy arrays, or a tuple of them) on ``device``."""
    return pytree.tree_map(lambda a: torch.as_tensor(a).to(device), items)


class MapReduce:
    """``MapReduce(app).run(items)`` — the framework entry point.

    flow: "auto" (the stream flow, or the reduce flow when no combiner
    can be derived; with ``n_pairs_hint``, the emitted pairs a run is
    expected to fold, the cheaper of the stream and sort flows by the cost
    model in the device's profile: ``cuda`` on the card, ``cpu`` with
    ``device="cpu"``), "stream", "sort", "combine" or "reduce".
    Construction is the plan stage: it derives the combiner from
    ``app.reduce`` (or takes ``app.manual_combiner``) and tiles the stream
    or sort flow's fold; ``stream_chunk_pairs`` pins the chunk of either
    and ``stream_key_block`` the stream fold's key block;
    ``autotune_probe=True`` measures the stream chunk on the device (kept
    in the tune cache file that ``REPRO_TORCH_TUNE_CACHE`` names).  The
    combine and reduce flows have no tiling; ``combine_impl`` picks the
    combine flow's lowering.

    The plan stage is cached by content (``core/plan_cache.py``): a second
    MapReduce over an app with the same reduce graph, shapes, knobs and
    device takes the first one's derivation, flow and tiling without
    running the optimizer (``cache=False`` opts out).  ``explain()`` shows
    the decision, the cost model's ranking when a hint enabled it, and the
    plan cache's outcome.

    ``streaming=True`` plans for continuous ingestion: the flow is pinned
    to "stream" and a combiner must be derivable; :meth:`serve` then
    stages the plan into a long-lived ``MapReduceService``.
    """

    def __init__(self, app: MapReduceApp, *, flow: str = "auto",
                 trust_semantics: bool = False,
                 combine_impl: str = "auto",
                 use_kernels: bool | None = None,
                 stream_chunk_pairs: int | str = "auto",
                 stream_key_block: int | str | None = "auto",
                 n_pairs_hint: int | None = None,
                 autotune_probe: bool = False,
                 cache: bool = True,
                 device=None,
                 streaming: bool = False):
        if app.key_space <= 0:
            raise ValueError("app.key_space must be positive")
        self.device = resolve_device(device)
        self.app = app
        self.use_kernels = (self.device.type == "cuda" if use_kernels is None
                            else use_kernels)
        self.combine_impl = combine_impl
        self._plan_key = pc.plan_key(
            app, flow=flow, trust_semantics=trust_semantics,
            n_pairs_hint=n_pairs_hint, use_kernels=self.use_kernels,
            combine_impl=combine_impl, chunk_pairs=stream_chunk_pairs,
            key_block=stream_key_block, autotune_probe=autotune_probe,
            device=self.device, streaming=streaming)
        entry = pc.plan_get(self._plan_key) if cache else None
        if entry is not None:
            # a fresh plan instance, so that run-time diagnostics never
            # reach the cached template
            self.plan = dataclasses.replace(
                entry.plan, stage="planned", cache_key=self._plan_key,
                cache_event="hit")
            self.tiling = entry.tiling
            return
        cache_event = "miss" if cache else ""
        fentry = pc.file_get(self._plan_key, self.device) if cache else None
        if (fentry is not None and not isinstance(stream_chunk_pairs, int)
                and fentry["flow"] in ("stream", "sort")):
            # another process's tiling: pin it, skip the probe (derivation
            # still runs: closures do not serialize)
            stream_chunk_pairs = fentry["chunk_pairs"]
            if (fentry.get("key_block") is not None
                    and fentry["flow"] == "stream"
                    and not isinstance(stream_key_block, int)):
                stream_key_block = fentry["key_block"]
            cache_event = "file-hit"
        self.plan = plan_execution(app, flow=flow,
                                   trust_semantics=trust_semantics,
                                   n_pairs_hint=n_pairs_hint,
                                   device=self.device, streaming=streaming)
        self.tiling = None
        if self.plan.flow == "combine":
            self._combine_diagnostics()
        elif self.plan.flow == "sort":
            self.tiling = at.autotune_sort(
                app, self.plan.spec, device=self.device,
                use_kernels=self.use_kernels, chunk_pairs=stream_chunk_pairs)
        elif self.plan.flow == "stream":
            self.tiling = at.autotune_stream(
                app, self.plan.spec, device=self.device,
                use_kernels=self.use_kernels, chunk_pairs=stream_chunk_pairs,
                key_block=stream_key_block, probe=autotune_probe)
            if self.tiling.mode == "scatter" and self.plan.spec.sum_lowerable:
                self.plan.diagnostics += (
                    "stream fold degraded to exact scatter (dense budget "
                    "exceeded) — see tiling notes",)
        self.plan.tiling = self.tiling
        self.plan.stage = "planned"
        self.plan.cache_key = self._plan_key
        self.plan.cache_event = cache_event
        if cache:
            # a snapshot: the template must not see what a run appends
            pc.plan_put(self._plan_key, pc.PlanEntry(
                plan=dataclasses.replace(self.plan), tiling=self.tiling))
            pc.file_put(self._plan_key, pc.file_entry_from(
                self.plan, self.tiling, self.device))

    def _combine_diagnostics(self) -> None:
        """Flag, at plan time, a combine flow that the collector's rule
        (:func:`~repro_torch.core.collector.choose_combine_impl`) degrades
        to the scatter fallback once the pair count passes the fused
        contraction's (below the one-hot cutoff it holds at any count)."""
        _, reason = col.choose_combine_impl(
            self.plan.spec, self.app.key_space,
            col.ADDITIVE_FOLD_PAIRS_FUSED + 1,
            onehot_kernel=self.use_kernels)
        if reason is None:
            return
        self.plan.diagnostics += (
            f"combine flow: {reason}; the collector uses the exact scatter "
            f"fallback there (LoweringFallbackWarning at run time) — the "
            f"stream flow has no such limit",)

    def _knobs(self, opts: ExecutionOptions) -> dict:
        """The engine's knobs for this plan under ``opts``: the options'
        values, else the constructor's and the tiling's.  The sort flow's
        radix plan is the tiling's unless it has none (the engine then
        re-plans, and raises if it needs the kernels)."""
        t = self.tiling
        knobs = dict(
            combine_impl=(self.combine_impl if opts.combine_impl is None
                          else opts.combine_impl),
            use_kernels=(self.use_kernels if opts.use_kernels is None
                         else opts.use_kernels),
            chunk_pairs=(opts.chunk_pairs if opts.chunk_pairs is not None
                         else t.chunk_pairs if t is not None else None),
            key_block=None, bucket_size=None, level_fanouts=None)
        if self.plan.flow == "stream":
            knobs["key_block"] = (opts.key_block if opts.key_block is not None
                                  else t.key_block if t.blocked else None)
        elif self.plan.flow == "sort":
            knobs["bucket_size"] = (
                opts.bucket_size if opts.bucket_size is not None
                else t.key_block if t.feasible else None)
            knobs["level_fanouts"] = (
                tuple(opts.level_fanouts) if opts.level_fanouts is not None
                else t.level_fanouts if t.feasible
                and opts.bucket_size is None else None)
        return knobs

    # -- the staged path ------------------------------------------------------

    def lower(self, items, *, options: ExecutionOptions | None = None,
              mode: str | None = None) -> "Lowered":
        """Stage 1: bind this plan to an item spec (the shapes and dtypes
        of ``items``: tensors, numpy arrays or ``plan_cache.TensorSpec``
        leaves).  ``mode`` is "local" or "streaming" (the service's ingest,
        :meth:`serve`); the other modes raise, naming the ROADMAP item
        that ports them."""
        opts = options if options is not None else ExecutionOptions()
        return Lowered(self, pc.items_spec_of(items), opts,
                       mode=_infer_mode(mode))

    def run(self, items, *, options: ExecutionOptions | None = None,
            n_valid: int | None = None, **legacy) -> MapReduceResult:
        """Run the planned flow over ``items`` (the first ``n_valid`` of
        them when given) and finalize the tables:
        ``lower(items).optimize().compile()(items)``."""
        opts = _resolve_options(options, legacy, method="run")
        return self.lower(items, options=opts, mode="local").optimize(
        ).compile()(items, n_valid=n_valid)

    def serve(self, *, batch_capacity: int, window=None,
              options: ExecutionOptions | None = None, item_spec=None,
              ckpt_dir: str | None = None, ckpt_every: int = 0,
              keep_ckpts: int = 3, retry_policy=None):
        """Stage this plan into a long-lived
        :class:`repro_torch.streaming.MapReduceService`.

        The staged path runs once (``lower().optimize().compile()`` at
        mode="streaming"); each ``service.ingest(items)`` then folds a
        micro-batch of up to ``batch_capacity`` items into the persistent
        holder tables, with no re-planning, re-tuning or re-compiling.
        ``window`` (a :class:`repro_torch.streaming.Window`) bounds the
        aggregation to the trailing micro-batches; ``ckpt_dir`` /
        ``ckpt_every`` checkpoint the tables for warm restarts.
        ``item_spec`` (one item's ``plan_cache.TensorSpec`` pytree, or a
        tensor of one item) stages eagerly, which ``restore()`` on a fresh
        service needs; without it the first ingest stages."""
        from repro_torch.streaming import MapReduceService

        return MapReduceService(
            self, batch_capacity=batch_capacity, window=window,
            options=options, item_spec=item_spec, ckpt_dir=ckpt_dir,
            ckpt_every=ckpt_every, keep_ckpts=keep_ckpts,
            retry_policy=retry_policy)

    def explain(self) -> str:
        return self.plan.explain()


def _infer_mode(mode: str | None) -> str:
    if mode is None or mode == "local":
        return "local"
    if mode == "streaming":
        return mode
    if mode in MODE_ITEMS:
        raise NotImplementedError(
            f"mode={mode!r} is not ported to repro_torch yet (ROADMAP "
            f"{MODE_ITEMS[mode]}); the port runs mode='local'")
    raise ValueError(f"unknown execution mode {mode!r}")


def _value_bytes(app) -> int:
    vs = app.value_spec
    return vs.dtype.itemsize * max(1, int(np.prod(vs.shape)))


class Lowered:
    """Stage 1: plan × item spec.  ``optimize(...)`` binds or overrides
    execution options; ``compile()`` is ``optimize().compile()``."""

    def __init__(self, mr: MapReduce, items_spec, options: ExecutionOptions,
                 *, mode: str = "local"):
        self.mr = mr
        self.items_spec = items_spec
        self.options = options
        self.mode = _infer_mode(mode)

    def optimize(self, options: ExecutionOptions | None = None,
                 **hints) -> "Optimized":
        """Stage 2: fix the execution options.  ``hints`` are single
        ``ExecutionOptions`` fields (``items_bucket="pow2"``); an unknown
        hint raises ``TypeError``."""
        opts = options if options is not None else self.options
        if hints:
            unknown = sorted(set(hints) - _OPTION_FIELDS)
            if unknown:
                raise TypeError(f"optimize() got unknown hints {unknown}")
            opts = dataclasses.replace(opts, **hints)
        return Optimized(self.mr, self.items_spec, opts, mode=self.mode)

    def compile(self) -> "Compiled":
        return self.optimize().compile()

    def explain(self) -> str:
        plan = dataclasses.replace(self.mr.plan, stage="lowered")
        return plan.explain() + f"\nitems: {pc.spec_sig_of(self.items_spec)}"


class Optimized:
    """Stage 2: plan × item spec × execution options."""

    def __init__(self, mr: MapReduce, items_spec, options: ExecutionOptions,
                 *, mode: str):
        self.mr = mr
        self.items_spec = items_spec
        self.options = options
        self.mode = mode
        self.n_items = int(pytree.tree_leaves(items_spec)[0].shape[0])
        self.n_bucket = pc.bucket_items(self.n_items, options.items_bucket)
        self.cache_key = self._cache_key()

    def _cache_key(self) -> str:
        opts = self.options
        knobs = self.mr._knobs(opts)
        spec = self.items_spec
        padded = self.n_bucket != self.n_items
        if padded:  # every N of the bucket maps to one key
            spec = pytree.tree_map(
                lambda a: pc.TensorSpec((self.n_bucket,) + tuple(a.shape[1:]),
                                        a.dtype), spec)
        return pc.compiled_key(
            self.mr.app, spec, plan_key=self.mr._plan_key,
            flow=self.mr.plan.flow, n_bucket=self.n_bucket,
            device=self.mr.device, mode=self.mode,
            extra=(f"padded={padded}", f"bucket={opts.items_bucket}",
                   *(f"{k}={v}" for k, v in sorted(knobs.items()))))

    def compile(self) -> "Compiled":
        """Stage 3: the prepared run.  A warm hit in the compiled cache
        prepares nothing: no derivation, tuning or warm-up."""
        use_cache = self.options.cache
        if use_cache:
            ent = pc.compiled_get(self.cache_key)
            if ent is not None:
                return Compiled(self, ent, cache_event="hit")
        ent = self._build()
        if use_cache:
            pc.compiled_put(self.cache_key, ent)
        return Compiled(self, ent, cache_event="miss" if use_cache else "")

    def _build(self) -> pc.CompiledEntry:
        mr = self.mr
        if self.mode == "streaming":
            return self._build_streaming()
        pc.STATS.compiles += 1
        run = eng.LocalRun(mr.app, mr.plan.flow, mr.plan.spec,
                           device=mr.device, plan=mr.plan,
                           **mr._knobs(self.options))
        peak = None
        if mr.device.type == "cuda":
            # the warm-up: loads the kernels' libraries, and measures the
            # bound shape's peak (the process's peak counter is reset)
            zeros = pytree.tree_map(
                lambda a: torch.zeros(tuple(a.shape), dtype=a.dtype,
                                      device=mr.device), self.items_spec)
            torch.cuda.synchronize(mr.device)
            torch.cuda.reset_peak_memory_stats(mr.device)
            with torch.no_grad():
                run(zeros, sinks=(mr.plan,))
            torch.cuda.synchronize(mr.device)
            peak = int(torch.cuda.max_memory_allocated(mr.device))
        return pc.CompiledEntry(executable=run, mode=self.mode,
                                warmup_peak_bytes=peak)

    def _build_streaming(self) -> pc.CompiledEntry:
        """The ingest of micro-batches of up to ``n_bucket`` items
        (``engine.build_stream_ingest``) and its collector; on the card,
        one warm-up ingest of zeros loads the kernels' libraries."""
        mr = self.mr
        if mr.plan.flow != "stream":
            raise ValueError(
                f"streaming mode requires the stream flow (plan chose "
                f"{mr.plan.flow!r}); construct MapReduce(app, "
                f"streaming=True) or flow='stream'")
        knobs = mr._knobs(self.options)
        ingest = eng.build_stream_ingest(
            mr.app, mr.plan.spec, batch_items=self.n_bucket,
            chunk_pairs=knobs["chunk_pairs"], device=mr.device,
            use_kernels=knobs["use_kernels"], key_block=knobs["key_block"])
        comb = ingest.combiner
        peak = None
        if mr.device.type == "cuda":
            zeros = pytree.tree_map(
                lambda a: torch.zeros(tuple(a.shape), dtype=a.dtype,
                                      device=mr.device), self.items_spec)
            torch.cuda.synchronize(mr.device)
            torch.cuda.reset_peak_memory_stats(mr.device)
            with torch.no_grad():
                ingest(comb.init_state(), zeros)
            torch.cuda.synchronize(mr.device)
            peak = int(torch.cuda.max_memory_allocated(mr.device))
        pc.STATS.compiles += 1
        return pc.CompiledEntry(executable=ingest, mode="streaming",
                                warmup_peak_bytes=peak)

    def explain(self) -> str:
        plan = dataclasses.replace(self.mr.plan, stage="optimized")
        return "\n".join([
            plan.explain(), f"mode: {self.mode}",
            f"items: {pc.spec_sig_of(self.items_spec)} (N={self.n_items} "
            f"bucket={self.n_bucket} policy={self.options.items_bucket})",
            f"compiled-cache key: {self.cache_key}"])


class Compiled:
    """Stage 3: the prepared run (``engine.LocalRun``).  ``compiled(items)``
    dispatches it.  The XLA introspection of the reference has no
    counterpart on the card; here ``as_text()`` is the launch plan of the
    bound shape, ``memory_analysis()`` the modelled peak (and, on the card,
    the warm-up call's), ``cost_analysis()`` the modelled bytes and the
    cost model's estimate."""

    def __init__(self, opt: Optimized, entry: pc.CompiledEntry, *,
                 cache_event: str):
        self.options = opt.options
        self.mode = entry.mode
        self.items_spec = opt.items_spec
        self.n_items = opt.n_items
        self.n_bucket = opt.n_bucket
        self.cache_key = opt.cache_key
        self.cache_event = cache_event
        self._mr = opt.mr
        self._entry = entry
        # this call's own copy of the plan: run-time diagnostics land here
        # and on the MapReduce's plan, not on the cached template
        self.plan = dataclasses.replace(opt.mr.plan, stage="compiled")

    def __call__(self, items, n_valid: int | None = None) -> MapReduceResult:
        """Run over ``items``: N rows (the bound count), or the bucket's
        rows padded by the caller, of which the first N (or ``n_valid``)
        are folded."""
        if self.mode == "streaming":
            raise TypeError(
                "a streaming-mode Compiled is an incremental ingest, not a "
                "batch job — drive it through MapReduceService "
                "(MapReduce.serve(...)) or via init_state()/ingest_state()")
        items = to_device(items, self._mr.device)
        n = eng.items_length(items)
        if n not in (self.n_items, self.n_bucket):
            raise ValueError(
                f"this Compiled is bound to N={self.n_items} items (bucket "
                f"{self.n_bucket}), got {n}; lower the new items")
        if n_valid is None and n != self.n_items:
            n_valid = self.n_items
        with torch.no_grad():
            keys, values, counts = self._entry.executable(
                items, n_valid, sinks=(self._mr.plan, self.plan))
        return MapReduceResult(keys, values, counts, plan=self.plan)

    # -- the streaming-mode surface (driven by MapReduceService) -------------

    @property
    def collector(self):
        """The streaming ingest's collector (``StreamCombiner``), which
        makes, reads and finalizes the carried state (streaming mode)."""
        if self.mode != "streaming":
            raise TypeError(f"a {self.mode}-mode Compiled carries no "
                            f"streaming state")
        return self._entry.executable.combiner

    def init_state(self):
        """A fresh carried collector state (streaming mode)."""
        return self.collector.init_state()

    def ingest_state(self, state, items, n_valid: int | None = None):
        """The state after folding the first ``n_valid`` of ``items`` (at
        most ``n_bucket`` rows, none padded) into ``state``, which is left
        as it was (streaming mode).  Grad mode is thread-local, so this
        enters ``torch.no_grad()`` itself: an ingestion worker thread
        records no graph either."""
        items = to_device(items, self._mr.device)
        with torch.no_grad():
            return self._entry.executable(state, items, n_valid)

    def state_tables(self, state):
        """Un-finalized ``(tables, counts)`` of a carried state."""
        return self.collector.tables_counts(state)

    def finalize_state(self, state):
        """Finalized ``Grouped(keys, values, counts)`` of a carried state."""
        with torch.no_grad():
            return self.collector.finalize(state)

    def _shape(self) -> dict:
        app, t, spec = self._mr.app, self._mr.tiling, self._mr.plan.spec
        holder = (_model_holder_bytes(spec, app.value_spec)
                  if spec is not None else None)
        return dict(n_pairs=self.n_items * app.emit_capacity,
                    key_space=app.key_space, value_bytes=_value_bytes(app),
                    holder_bytes=holder,
                    chunk_pairs=t.chunk_pairs if t is not None else None,
                    max_values_per_key=app.max_values_per_key)

    def as_text(self) -> str:
        """The launch plan of the bound shape: the chunk loop and each
        kernel with its plan (``ops.fold_plan``,
        ``radix_partition.partition_passes``); in streaming mode, that of
        one full micro-batch (the batch run's over ``n_bucket`` items)."""
        if self.mode == "streaming":
            return self._entry.executable.launch_plan()
        return self._entry.executable.launch_plan(self.n_items)

    def memory_analysis(self) -> dict:
        """``model_peak_bytes`` (``roofline.mapreduce_flow_peak_bytes`` at
        the bound shape) and ``warmup_peak_bytes``: on the card, the
        warm-up call's ``torch.cuda.max_memory_allocated``; None on the
        CPU."""
        return {"model_peak_bytes": roofline.mapreduce_flow_peak_bytes(
                    self._mr.plan.flow, **self._shape()),
                "warmup_peak_bytes": self._entry.warmup_peak_bytes}

    def cost_analysis(self) -> dict:
        """The modelled bytes of the bound shape and the cost model's
        estimate of its flow in the device's profile."""
        mr, s = self._mr, self._shape()
        spec = mr.plan.spec
        backend = cm.default_backend(mr.device)
        d = spec.holder_width(mr.app.value_spec)[0] if spec is not None else 1
        fc = cm.estimate_flow_cost(
            mr.plan.flow, d=d, backend=backend,
            fold_op="add" if spec is None or spec.sum_lowerable else "max",
            **s)
        return {"flow": mr.plan.flow, "backend": backend,
                "n_pairs": s["n_pairs"],
                "model_bytes": roofline.mapreduce_flow_bytes(
                    mr.plan.flow, **s),
                "est_s": fc.est_s, "terms": dict(fc.terms)}

    def explain(self) -> str:
        lines = [self.plan.explain(), f"mode: {self.mode}",
                 f"compiled-cache: {self.cache_event or 'off'} "
                 f"key={self.cache_key}"]
        if self.n_bucket != self.n_items:
            lines.append(f"items: N={self.n_items} in bucket={self.n_bucket} "
                         f"(rows past N are never folded)")
        return "\n".join(lines)

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
dispatches the kernels in the order ``run()`` always did, with no
re-planning, re-tuning or rebuilding, and returns fresh tensors.  On the
card a stream-flow call over the same items as the call before it
captures the chunk loop as one CUDA graph, and later calls over those
items replay it (``engine.CapturedLoop``; ``explain()``'s ``loop:``
line); a first or one-shot call stays eager.  The compiled run holds one
graph's memory pool until it captures another or is dropped, and the
process at most ``engine.GRAPH_POOL_BYTES`` of pools over all runs.
``items_bucket="pow2"`` lets the batch sizes of one power-of-two bucket
share a compiled entry; a padded call folds only its first ``n_valid``
items (``engine.fold_items_chunked``), so it gives the bits of the exact
call.

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
warm restarts.

Distribution: ``MapReduce(app).run_distributed(items, mesh=...)`` (or
``lower(items, options=ExecutionOptions(mesh=...))``, which infers
mode="distributed") runs the planned flow over the shards of a mesh
(``repro_torch.distributed.mesh``): ``LocalMesh(S)`` runs the S shards in
turn on one device, ``ProcessGroupMesh()`` one shard a
``torch.distributed`` rank.  The stream and combine flows fold each
shard's items and merge the tables; the reduce and sort flows route the
pairs through a key-partitioned all-to-all under a wire codec
(``ShuffleOptions(wire=...)``), balanced by the skew planner under
``ShuffleOptions(skew="auto")`` (``core/skew.py``).  The resilient mode is
not ported yet (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
import warnings as _warnings
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import spans
from repro_torch.core import autotune as at
from repro_torch.core import collector as col
from repro_torch.core import combiner as C
from repro_torch.core import cost_model as cm
from repro_torch.core import engine as eng
from repro_torch.core import plan_cache as pc
from repro_torch.core import skew as sk
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
MODE_ITEMS: dict[str, str] = {}


@dataclasses.dataclass(frozen=True)
class ExecutionOptions:
    """Run-time overrides of the lowering; ``None`` keeps the MapReduce
    constructor's choice.  ``combine_impl`` is the combine flow's
    (``auto``, ``onehot``, ``scatter``, ``first``, ``segment``);
    ``key_block`` the stream flow's; ``bucket_size`` (the leaf bucket) and
    ``level_fanouts`` (the radix levels) the sort flow's.
    ``items_bucket="pow2"`` lets batch sizes of one power-of-two bucket
    share a compiled entry (rows past N are never folded; local runs
    only); ``cache=False`` bypasses the compiled-stage cache.

    Distribution: ``mesh`` (a ``distributed.mesh`` mesh) and its
    ``data_axis``; ``scatter_output`` key-shards the stream and combine
    flows' results; ``shuffle`` (a :class:`~repro_torch.core.skew.
    ShuffleOptions`) is the all-to-all's capacity, strictness, skew
    planner and wire codec.  The flat ``shuffle_capacity`` /
    ``strict_shuffle`` are its deprecated spelling: set without
    ``shuffle`` they forward into one with a ``DeprecationWarning``; with
    ``shuffle`` set they mirror it.

    Resilience (``run_resilient``): ``num_hosts`` / ``num_shards`` (default:
    the mesh's size), ``ckpt_dir`` / ``step`` (the shard partials'
    checkpoints), ``inject`` (a ``fault.FaultInjection``), ``timeout_s`` /
    ``straggler_lag`` (the heartbeat monitor's), and the durable control
    plane: ``coord`` (a ``coordination.CoordinationStore``, ``KVStore`` or
    directory), ``retry`` (a ``coordination.RetryPolicy``) and ``chaos``
    (a ``chaos.ChaosPlan``)."""

    mesh: Any = None
    data_axis: str = "data"
    scatter_output: bool = False
    shuffle_capacity: int | None = None
    strict_shuffle: bool = False
    shuffle: sk.ShuffleOptions | None = None
    num_hosts: int | None = None
    num_shards: int | None = None
    ckpt_dir: str | None = None
    step: int = 0
    inject: Any = None
    timeout_s: float = 60.0
    straggler_lag: int = 1
    coord: Any = None
    retry: Any = None
    chaos: Any = None
    combine_impl: str | None = None
    use_kernels: bool | None = None
    chunk_pairs: int | None = None
    key_block: int | None = None
    bucket_size: int | None = None
    level_fanouts: tuple[int, ...] | None = None
    items_bucket: str = "exact"
    cache: bool = True

    def __post_init__(self):
        sh = self.shuffle
        if sh is None:
            if self.shuffle_capacity is not None or self.strict_shuffle:
                _warnings.warn(
                    "ExecutionOptions(shuffle_capacity=..., "
                    "strict_shuffle=...) are deprecated; pass "
                    "shuffle=ShuffleOptions(capacity=..., strict=...) "
                    "instead", DeprecationWarning, stacklevel=3)
                object.__setattr__(self, "shuffle", sk.ShuffleOptions(
                    capacity=self.shuffle_capacity,
                    strict=self.strict_shuffle))
            return
        if not isinstance(sh, sk.ShuffleOptions):
            raise TypeError(
                f"ExecutionOptions.shuffle must be a skew.ShuffleOptions, "
                f"got {type(sh).__name__}")
        object.__setattr__(self, "shuffle_capacity", sh.capacity)
        object.__setattr__(self, "strict_shuffle", sh.strict)


_OPTION_FIELDS = {f.name for f in dataclasses.fields(ExecutionOptions)}


def _resolve_options(options: ExecutionOptions | None, legacy: dict, *,
                     method: str, mesh=None) -> ExecutionOptions:
    """The options record; scattered keyword arguments raise ``TypeError``
    (the reference's rule): an option's name with a pointer at
    ``ExecutionOptions``, anything else as unexpected.  ``mesh``, the
    distributed entry point's own argument, goes onto the record."""
    if legacy:
        retired = sorted(set(legacy) & _OPTION_FIELDS)
        if retired:
            raise TypeError(
                f"{method}({', '.join(retired)}=...) scattered keyword "
                f"arguments are not taken; pass "
                f"options=ExecutionOptions({retired[0]}=...) instead")
        raise TypeError(f"{method}() got unexpected keyword arguments "
                        f"{sorted(legacy)}")
    opts = options if options is not None else ExecutionOptions()
    if mesh is not None:
        opts = dataclasses.replace(opts, mesh=mesh)
    return opts


@dataclasses.dataclass
class MapReduceResult:
    """The result record of every entry point: ``run()``,
    ``run_distributed()``, ``run_resilient()``, which also sets
    ``recovery``, a compiled call and ``MapReduceService.snapshot()``,
    which also sets ``batch_id``."""

    keys: torch.Tensor  # [K] = arange(K)
    values: Any  # [K, ...]
    counts: torch.Tensor  # [K]; 0 == key never emitted
    plan: ExecutionPlan | None = None
    #: micro-batches folded in, when the result is a service snapshot
    batch_id: int | None = None
    #: where a distributed result's rows live (``engine.ShardedResult``)
    layout: Any = None
    #: the ``fault.RecoveryLog`` of a resilient run
    recovery: Any = None

    def gather_result(self) -> "MapReduceResult":
        """The global layout of a distributed result: a ProcessGroupMesh
        rank holds its own block of a key-sharded result, and this gathers
        every rank's (a collective: every rank calls it).  Any other
        result is returned as it is."""
        if self.layout is None or not self.layout.local:
            return self
        keys, values, counts = self.layout.gather(self.keys, self.values,
                                                  self.counts)
        return dataclasses.replace(self, keys=keys, values=values,
                                   counts=counts, layout=None)

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
        with spans.span("plan"):
            if app.key_space <= 0:
                raise ValueError("app.key_space must be positive")
            self.device = resolve_device(device)
            self.app = app
            self.use_kernels = (self.device.type == "cuda"
                                if use_kernels is None else use_kernels)
            self.combine_impl = combine_impl
            with spans.span("plan.key"):
                self._plan_key = pc.plan_key(
                    app, flow=flow, trust_semantics=trust_semantics,
                    n_pairs_hint=n_pairs_hint, use_kernels=self.use_kernels,
                    combine_impl=combine_impl,
                    chunk_pairs=stream_chunk_pairs,
                    key_block=stream_key_block,
                    autotune_probe=autotune_probe, device=self.device,
                    streaming=streaming)
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
            fentry = (pc.file_get(self._plan_key, self.device) if cache
                      else None)
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
            with spans.span("plan.derive"):
                self.plan = plan_execution(app, flow=flow,
                                           trust_semantics=trust_semantics,
                                           n_pairs_hint=n_pairs_hint,
                                           device=self.device,
                                           streaming=streaming)
            self.tiling = None
            if self.plan.flow == "combine":
                self._combine_diagnostics()
            elif self.plan.flow == "sort":
                with spans.span("plan.tune"):
                    self.tiling = at.autotune_sort(
                        app, self.plan.spec, device=self.device,
                        use_kernels=self.use_kernels,
                        chunk_pairs=stream_chunk_pairs)
            elif self.plan.flow == "stream":
                with spans.span("plan.tune"):
                    self.tiling = at.autotune_stream(
                        app, self.plan.spec, device=self.device,
                        use_kernels=self.use_kernels,
                        chunk_pairs=stream_chunk_pairs,
                        key_block=stream_key_block, probe=autotune_probe)
                if (self.tiling.mode == "scatter"
                        and self.plan.spec.sum_lowerable):
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
        rmode = _infer_mode(mode, opts)
        if rmode in ("distributed", "resilient"):
            opts = self._resolve_shuffle(opts, items, rmode)
        return Lowered(self, pc.items_spec_of(items), opts, mode=rmode)

    def _resolve_shuffle(self, opts: ExecutionOptions, items,
                         mode: str) -> ExecutionOptions:
        """lower()-time skew resolution: sample (or recall) the key
        histogram and return options whose ``shuffle`` holds the decision;
        its provenance lands on ``plan.skew``.  A codec other than raw puts
        its modelled bytes on ``plan.wire``."""
        sh = opts.shuffle
        if sh is not None and sh.wire != "raw":
            self.plan.wire = self._wire_provenance(opts, items, mode)
        if sh is None or (sh.skew != "auto" and sh.boundaries is None):
            return opts
        if _spec_only(items):
            return opts  # nothing to sample
        S = _shard_count(opts, mode)
        if S <= 1:
            return opts
        resolved, profile = sk.resolve_shuffle_options(
            self.app, self.plan, items, num_shards=S, options=sh,
            device=self.device)
        lines: list[str] = []
        if profile is not None:
            lines.extend(profile.describe())
        splan = sk.plan_from_options(
            self.app.key_space, S, resolved, flow=self.plan.flow,
            spec=self.plan.spec, value_spec=self.app.value_spec)
        if splan is not None:
            lines.extend(splan.describe())
        elif profile is not None and resolved.boundaries is None:
            lines.append(
                f"plan: fixed-width ranges kept (imbalance at/under the "
                f"{sk.SNAP_IMBALANCE}x snap threshold)")
        if lines:
            self.plan.skew = tuple(lines)
        if resolved is sh:
            return opts
        return dataclasses.replace(opts, shuffle=resolved)

    def _wire_provenance(self, opts: ExecutionOptions, items,
                         mode: str) -> tuple[str, ...]:
        """``explain()`` lines for a codec other than raw: the codec, and
        the modelled encoded and raw bytes a shard when the item count is
        known."""
        from repro_torch.distributed.wire import dtype_name

        sh = opts.shuffle
        lines = [f"codec {sh.wire} on the all-to-all "
                 f"(repro_torch/distributed/wire.py)"]
        S = _shard_count(opts, mode)
        leaves = pytree.tree_leaves(items)
        if S > 1 and leaves:
            vs = self.app.value_spec
            n_pairs = int(leaves[0].shape[0]) * self.app.emit_capacity
            kw = dict(n_pairs=n_pairs, key_space=self.app.key_space,
                      num_shards=S, value_bytes=_value_bytes(self.app),
                      value_dtype=dtype_name(vs.dtype),
                      capacity=sh.capacity)
            enc_b = roofline.shuffle_wire_bytes(sh.wire, **kw)
            raw_b = roofline.shuffle_wire_bytes("raw", **kw)
            if raw_b > 0:
                lines.append(
                    f"modeled wire bytes/shard: {enc_b / 1e3:.1f}kB "
                    f"({enc_b / raw_b:.2f}x raw {raw_b / 1e3:.1f}kB) "
                    f"at S={S}")
        return tuple(lines)

    def run(self, items, *, options: ExecutionOptions | None = None,
            n_valid: int | None = None, **legacy) -> MapReduceResult:
        """Run the planned flow over ``items`` (the first ``n_valid`` of
        them when given) and finalize the tables:
        ``lower(items).optimize().compile()(items)``."""
        opts = _resolve_options(options, legacy, method="run")
        with spans.job():
            return self.lower(items, options=opts, mode="local").optimize(
            ).compile()(items, n_valid=n_valid)

    def run_distributed(self, items, *, mesh=None,
                        options: ExecutionOptions | None = None,
                        **legacy) -> MapReduceResult:
        """Run the planned flow over the shards of ``mesh`` (or
        ``options.mesh``): ``lower(items, mode="distributed").optimize()
        .compile()(items)``.  The items are the global batch; the mesh
        splits them into S equal contiguous blocks.  A LocalMesh gives the
        global layout; a ProcessGroupMesh rank gets its own rows
        (``result.gather_result()`` assembles them)."""
        opts = _resolve_options(options, legacy, method="run_distributed",
                                mesh=mesh)
        if opts.mesh is None:
            raise TypeError("run_distributed requires a mesh (pass mesh=... "
                            "or options=ExecutionOptions(mesh=...))")
        return self.lower(items, options=opts, mode="distributed"
                          ).optimize().compile()(items)

    def run_resilient(self, items, *, mesh=None,
                      options: ExecutionOptions | None = None,
                      **legacy) -> MapReduceResult:
        """Fault-tolerant distributed run (``engine.run_resilient``):
        deterministic re-execution of lost shards, checkpointed partial
        recovery (``ckpt_dir``), straggler speculation and elastic remesh,
        scripted by the options.  The result is the fault-free
        :meth:`run_distributed` answer bit for bit; the recovery ledger is
        ``result.recovery`` and, summarized, in :meth:`explain`.  Every
        shard runs in this process on the mesh's device (a LocalMesh, or
        a ProcessGroupMesh at world size 1; C.48)."""
        opts = _resolve_options(options, legacy, method="run_resilient",
                                mesh=mesh)
        return self.lower(items, options=opts, mode="resilient"
                          ).optimize().compile()(items)

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


def _spec_only(items) -> bool:
    return any(isinstance(a, pc.TensorSpec)
               for a in pytree.tree_leaves(items))


def _shard_count(opts: ExecutionOptions, mode: str) -> int:
    """The shards a run in ``mode`` sees: a distributed run's, the mesh's
    size; a resilient run's, as ``engine.run_resilient`` resolves them
    (``num_shards``, else the mesh's size, else ``num_hosts``)."""
    mesh_hosts = int(opts.mesh.size) if opts.mesh is not None else None
    if mode != "resilient":
        return mesh_hosts or 1
    hosts = opts.num_hosts if opts.num_hosts is not None else (mesh_hosts
                                                               or 1)
    return int(opts.num_shards if opts.num_shards is not None
               else (mesh_hosts or hosts))


def _infer_mode(mode: str | None, opts: ExecutionOptions | None = None
                ) -> str:
    """The execution mode: ``mode``, else "distributed" when the options
    carry a mesh, else "local".  The distributed mode needs the mesh."""
    if mode is None:
        mode = ("distributed" if opts is not None and opts.mesh is not None
                else "local")
    if mode == "distributed":
        if opts is None or opts.mesh is None:
            raise TypeError(
                "mode='distributed' requires a mesh: pass "
                "options=ExecutionOptions(mesh=LocalMesh(S) or "
                "ProcessGroupMesh())")
        if opts.data_axis != opts.mesh.axis_name:
            raise ValueError(
                f"the mesh has no data axis {opts.data_axis!r} (its axis is "
                f"{opts.mesh.axis_name!r})")
        return mode
    if mode in ("local", "streaming", "resilient"):
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
        self.mode = _infer_mode(mode, options)

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

    def traced_cost(self, items, n_valid: int | None = None):
        """``compile().traced_cost(items, n_valid)``."""
        return self.compile().traced_cost(items, n_valid)

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
        if mode in ("distributed", "resilient"):
            # the shards split the exact batch: no padded buckets
            self.n_bucket = self.n_items
        else:
            self.n_bucket = pc.bucket_items(self.n_items,
                                            options.items_bucket)
        self.cache_key = self._cache_key()

    def _cache_key(self) -> str | None:
        if self.mode == "resilient":
            return None  # a drill a call: its driver is never cached
        opts = self.options
        knobs = self.mr._knobs(opts)
        spec = self.items_spec
        padded = self.n_bucket != self.n_items
        if padded:  # every N of the bucket maps to one key
            spec = pytree.tree_map(
                lambda a: pc.TensorSpec((self.n_bucket,) + tuple(a.shape[1:]),
                                        a.dtype), spec)
        extra = (f"padded={padded}", f"bucket={opts.items_bucket}",
                 *(f"{k}={v}" for k, v in sorted(knobs.items())))
        if self.mode == "distributed":
            # the resolved shuffle record's repr names the capacity, the
            # strictness, the skew planner's boundaries and hot splits and
            # the codec: two layouts never share an entry
            extra += (f"scatter={opts.scatter_output}",
                      f"shuffle={opts.shuffle!r}")
        return pc.compiled_key(
            self.mr.app, spec, plan_key=self.mr._plan_key,
            flow=self.mr.plan.flow, n_bucket=self.n_bucket,
            device=self.mr.device, mode=self.mode,
            mesh=opts.mesh if self.mode == "distributed" else None,
            extra=extra)

    def compile(self) -> "Compiled":
        """Stage 3: the prepared run.  A warm hit in the compiled cache
        prepares nothing: no derivation, tuning or warm-up."""
        use_cache = self.options.cache and self.cache_key is not None
        if use_cache:
            ent = pc.compiled_get(self.cache_key)
            if ent is not None:
                return Compiled(self, ent, cache_event="hit")
        with spans.span("compile"):
            ent = self._build()
        if use_cache:
            pc.compiled_put(self.cache_key, ent)
        return Compiled(self, ent, cache_event="miss" if use_cache else "")

    def _build(self) -> pc.CompiledEntry:
        mr = self.mr
        if self.mode == "streaming":
            return self._build_streaming()
        if self.mode == "distributed":
            return self._build_distributed()
        if self.mode == "resilient":
            return self._build_resilient()
        pc.STATS.compiles += 1
        run = eng.LocalRun(mr.app, mr.plan.flow, mr.plan.spec,
                           device=mr.device, plan=mr.plan,
                           **mr._knobs(self.options))
        peak = None
        if mr.device.type == "cuda":
            # the warm-up: loads the kernels' libraries, and measures the
            # bound shape's peak (the process's peak counter is reset); a
            # first call over its items is eager, so it holds no graph
            zeros = pytree.tree_map(
                lambda a: torch.zeros(tuple(a.shape), dtype=a.dtype,
                                      device=mr.device), self.items_spec)
            torch.cuda.synchronize(mr.device)
            torch.cuda.reset_peak_memory_stats(mr.device)
            with spans.span("compile.warmup"), torch.no_grad():
                run(zeros, sinks=(mr.plan,))
                torch.cuda.synchronize(mr.device)
            peak = int(torch.cuda.max_memory_allocated(mr.device))
        return pc.CompiledEntry(executable=run, mode=self.mode,
                                warmup_peak_bytes=peak)

    def _build_distributed(self) -> pc.CompiledEntry:
        """The distributed run (``engine.DistributedRun``) over the
        options' mesh, with the per-shard tiling and the shuffle plan of
        the resolved ``ShuffleOptions``.  No warm-up call: zeros would
        route every pair to one destination, and the kernels' libraries
        load at the first call."""
        mr, opts = self.mr, self.options
        mesh = opts.mesh
        self._check_mesh_device()
        knobs = mr._knobs(opts)
        plan = mr.plan
        chunk_pairs, key_block = eng._distributed_tiling(
            mr.app, plan, device=mesh.device,
            use_kernels=knobs["use_kernels"],
            chunk_pairs=knobs["chunk_pairs"], key_block=knobs["key_block"])
        shuffle_plan = sk.plan_from_options(
            mr.app.key_space, mesh.size, opts.shuffle, flow=plan.flow,
            spec=plan.spec, value_spec=mr.app.value_spec)
        run, _ = eng.build_distributed_fn(
            mr.app, plan, mesh=mesh, combine_impl=knobs["combine_impl"],
            use_kernels=knobs["use_kernels"],
            scatter_output=opts.scatter_output,
            shuffle_capacity=opts.shuffle_capacity,
            chunk_pairs=chunk_pairs, key_block=key_block,
            # the shards re-plan their radix levels for their own key
            # range; only explicit options pin them
            bucket_size=opts.bucket_size,
            level_fanouts=(tuple(opts.level_fanouts)
                           if opts.level_fanouts is not None else None),
            shuffle_plan=shuffle_plan,
            wire=opts.shuffle.wire if opts.shuffle is not None else "raw")
        pc.STATS.compiles += 1
        return pc.CompiledEntry(executable=run, mode="distributed")

    def _check_mesh_device(self) -> None:
        mesh, mr = self.options.mesh, self.mr
        if mesh is not None and mesh.device.type != mr.device.type:
            raise ValueError(
                f"the mesh runs on {mesh.device} but this MapReduce on "
                f"{mr.device}; construct MapReduce(app, device=...) on the "
                f"mesh's device")

    def _build_resilient(self) -> pc.CompiledEntry:
        """The resilient driver (:class:`ResilientDriver`) with this plan's
        knobs and the resolved shuffle plan.  It is built on every
        ``compile()`` and never cached by content; what it prepares (the
        per-shard run, its wire format and tiling) is kept on the
        MapReduce, so a repeat call derives, tunes and compiles
        nothing."""
        mr, opts = self.mr, self.options
        self._check_mesh_device()
        shuffle_plan = sk.plan_from_options(
            mr.app.key_space, _shard_count(opts, "resilient"), opts.shuffle,
            flow=mr.plan.flow, spec=mr.plan.spec,
            value_spec=mr.app.value_spec)
        return pc.CompiledEntry(
            executable=ResilientDriver(mr, opts, shuffle_plan),
            mode="resilient")

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
        lines = [
            plan.explain(), f"mode: {self.mode}",
            f"items: {pc.spec_sig_of(self.items_spec)} (N={self.n_items} "
            f"bucket={self.n_bucket} policy={self.options.items_bucket})"]
        if self.cache_key is not None:
            lines.append(f"compiled-cache key: {self.cache_key}")
        return "\n".join(lines)


class ResilientDriver:
    """A resilient-mode ``Compiled``'s executable: ``engine.run_resilient``
    bound to a MapReduce's knobs, the options' script and the resolved
    shuffle plan.  The prepared per-shard run
    (``engine.resilient_run``) is kept on the MapReduce across calls
    (the reference's ``_resilient_jits``); preparing one counts a
    compile."""

    def __init__(self, mr: "MapReduce", opts: ExecutionOptions,
                 shuffle_plan):
        self.mr = mr
        self.options = opts
        self.shuffle_plan = shuffle_plan
        self.runs = mr.__dict__.setdefault("_resilient_runs", {})
        knobs = mr._knobs(opts)
        # the knobs of the distributed run over the same shards
        # (``Optimized._build_distributed``): its tiling, hence its bits
        self.knobs = dict(
            combine_impl=knobs["combine_impl"],
            use_kernels=knobs["use_kernels"],
            shuffle_capacity=opts.shuffle_capacity,
            chunk_pairs=knobs["chunk_pairs"], key_block=knobs["key_block"],
            bucket_size=opts.bucket_size,
            level_fanouts=(tuple(opts.level_fanouts)
                           if opts.level_fanouts is not None else None),
            wire=opts.shuffle.wire if opts.shuffle is not None else "raw")

    @property
    def device(self) -> torch.device:
        mesh = self.options.mesh
        return mesh.device if mesh is not None else self.mr.device

    def prepared(self, n_items: int):
        """The per-shard run (``engine.resilient_run``) for ``n_items``
        items; None for shard counts ``engine.run_resilient`` refuses."""
        S = _shard_count(self.options, "resilient")
        if S <= 0 or n_items % S:
            return None
        before = len(self.runs)
        run = eng.resilient_run(
            self.mr.app, self.mr.plan, num_shards=S,
            shard_items_n=n_items // S, device=self.device,
            shuffle_plan=self.shuffle_plan, jit_cache=self.runs,
            **self.knobs)
        if len(self.runs) > before:
            pc.STATS.compiles += 1
        return run

    def __call__(self, items, *, sinks=()):
        opts = self.options
        self.prepared(eng.items_length(items))
        return eng.run_resilient(
            self.mr.app, self.mr.plan, items, mesh=opts.mesh,
            num_hosts=opts.num_hosts, num_shards=opts.num_shards,
            data_axis=opts.data_axis, step=opts.step, ckpt_dir=opts.ckpt_dir,
            inject=opts.inject, timeout_s=opts.timeout_s,
            straggler_lag=opts.straggler_lag,
            strict_shuffle=opts.strict_shuffle,
            shuffle_plan=self.shuffle_plan, coord=opts.coord,
            retry=opts.retry, chaos=opts.chaos, jit_cache=self.runs,
            device=self.device, sinks=sinks, **self.knobs)

    def launch_plan(self, n_items: int) -> str:
        """The per-shard run's launches (the distributed run's over the
        same shards); phase A runs a shard partial a shard the drill
        computes, phase B merges or folds the key ranges."""
        S = _shard_count(self.options, "resilient")
        return (f"resilient driver: {S} shards in one process, a partial a "
                f"shard the drill computes, then phase B\n"
                + self.prepared(n_items).launch_plan(n_items))


class Compiled:
    """Stage 3: the prepared run (``engine.LocalRun``).  ``compiled(items)``
    dispatches it.  The card has no XLA executable to introspect: here
    ``as_text()`` is the launch plan of the bound shape,
    ``memory_analysis()`` the modelled peak (and, on the card, the warm-up
    call's), ``cost_analysis()`` the modelled bytes and the cost model's
    estimate, and ``traced_cost(items)`` the FLOPs, bytes, wire bytes and
    peak of one traced call (``roofline.op_trace``: the counterpart of the
    reference's ``hlo_parser.analyze_text(compiled.as_text())``)."""

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
        are folded; one ``job`` span (``spans.job``)."""
        with spans.job():
            return self._call(items, n_valid)

    def _call(self, items, n_valid: int | None) -> MapReduceResult:
        if self.mode == "streaming":
            raise TypeError(
                "a streaming-mode Compiled is an incremental ingest, not a "
                "batch job — drive it through MapReduceService "
                "(MapReduce.serve(...)) or via init_state()/ingest_state()")
        items = to_device(items, self._mr.device)
        n = eng.items_length(items)
        if self.mode == "resilient":
            keys, values, counts, log = self._entry.executable(
                items, sinks=(self._mr.plan, self.plan))
            return MapReduceResult(keys, values, counts, plan=self.plan,
                                   recovery=log)
        if self.mode == "distributed":
            if n != self.n_items:
                raise ValueError(
                    f"this Compiled is bound to N={self.n_items} items, got "
                    f"{n}; lower the new items")
            run = self._entry.executable
            sinks = (self._mr.plan, self.plan)
            with torch.no_grad():
                keys, values, counts, layout = run.postprocess(
                    run(items, sinks=sinks),
                    strict_shuffle=self.options.strict_shuffle, sinks=sinks)
            return MapReduceResult(keys, values, counts, plan=self.plan,
                                   layout=layout)
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

    @property
    def num_shards(self) -> int:
        if self.mode in ("distributed", "resilient"):
            return _shard_count(self.options, self.mode)
        return 1

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

    def traced_cost(self, items, n_valid: int | None = None):
        """An ``op_trace.OpCost`` of one traced call over ``items`` (the
        bound shape), run on this run's device: FLOPs, bytes accessed,
        each collective's wire bytes a shard, where the bytes live
        (``top_bytes()``) and the peak of what the call allocated.  Each
        kernel counts as one op, its tensors read and written once, so the
        count does not depend on how a kernel is written; on a
        ``LocalMesh`` the bytes are the process's (every shard's), the wire
        bytes a shard's."""
        from repro_torch.roofline import op_trace

        _, tr = op_trace.trace(self, items, n_valid)
        return op_trace.analyze_trace(tr, default_group=self.num_shards)

    def cost_analysis(self) -> dict:
        """The modelled bytes of the bound shape and the cost model's
        estimate of its flow in the device's profile; a model, which runs
        no call (:meth:`traced_cost` counts one)."""
        mr, s = self._mr, self._shape()
        spec = mr.plan.spec
        backend = cm.default_backend(mr.device)
        d = spec.holder_width(mr.app.value_spec)[0] if spec is not None else 1
        dist = {}
        if self.mode == "distributed":
            from repro_torch.distributed.wire import dtype_name

            sh = self.options.shuffle
            dist = dict(num_shards=self.num_shards,
                        wire=sh.wire if sh is not None else "raw",
                        shuffle_capacity=self.options.shuffle_capacity,
                        value_dtype=dtype_name(mr.app.value_spec.dtype))
        fc = cm.estimate_flow_cost(
            mr.plan.flow, d=d, backend=backend,
            fold_op="add" if spec is None or spec.sum_lowerable else "max",
            **s, **dist)
        return {"flow": mr.plan.flow, "backend": backend,
                "n_pairs": s["n_pairs"],
                "model_bytes": roofline.mapreduce_flow_bytes(
                    mr.plan.flow, **s),
                "est_s": fc.est_s, "terms": dict(fc.terms)}

    def explain(self) -> str:
        lines = [self.plan.explain(), f"mode: {self.mode}"]
        if self.cache_key is not None:
            lines.append(f"compiled-cache: {self.cache_event or 'off'} "
                         f"key={self.cache_key}")
        if self.n_bucket != self.n_items:
            lines.append(f"items: N={self.n_items} in bucket={self.n_bucket} "
                         f"(rows past N are never folded)")
        return "\n".join(lines)

"""Multi-job pipelines: chained MapReduce jobs with semantic fusion.

Counterpart of ``repro/core/pipeline.py``.  Chained jobs (map→reduce→
map→reduce, word count → histogram) hand the producer's dense ``[K]``
table to the consumer as ``(key, value, count)`` items.  The framework
reads the user's map to skip work the semantics make dead, MANIMAL's
static analysis recast on the torch graph of the consumer's map:

* **one dispatch** — ``run`` runs every stage in a row with no host
  synchronization between them; ``run_unfused`` synchronizes with the
  host and hands the finalized table over between stages.
* **dead-column elimination** — the consumer map's graph is dependence
  sliced; when its pairs never read the value column, ``run`` does not
  finalize the producer's values at all and feeds zeros in their place
  (broadcast from one element).
* **filter pushdown** — an edge predicate (``then(job, where=...)``) and
  the empty-row guard (``count == 0``) mask rows at the consumer's map,
  so their pairs never reach its fold.

What this does not do on the card (ROADMAP C.33): eager PyTorch has no
compiler that keeps a table in registers, so on both paths the producer
writes its ``[K]`` keys and counts (and, when read, its values) to device
memory and the consumer reads them back.  ``fusion_report`` says so, and
``model_bytes(fused=True)`` counts ``roofline.pipeline_handoff_bytes``
for every edge, without the value column on a dead edge;
``model_bytes(fused=False)`` is the reference's count.

Both paths run the same prepared stage runs (``engine.LocalRun``) with
the same knobs, so their results are equal bit for bit.  A consumer map
is written for one live row ``(key, value, count)`` (int32 key, the
producer's reduce output, int32 count) and must be total: it is mapped
over every row, the empty ones masked.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import engine as eng
from repro_torch.core import plan_cache as pc
from repro_torch.core.api import (ExecutionOptions, MapReduce, MapReduceApp,
                                  MapReduceResult, to_device)
from repro_torch.roofline import analysis as roofline


@dataclasses.dataclass(frozen=True)
class StageSemantics:
    """What a consumer map does with its ``(key, value, count)`` item, from
    a forward dependence walk over the graph of its map: ``reads_*`` say
    which columns the emitted pairs depend on (``reads_value=False``: the
    value column is dead); ``key_passthrough`` that the emitted key
    depends on the input key alone; ``select_guard`` that the key channel
    runs through a data-dependent ``where`` (a filter below the
    shuffle)."""

    reads_key: bool
    reads_value: bool
    reads_count: bool
    key_passthrough: bool
    select_guard: bool

    def describe(self) -> str:
        cols = [n for n, r in (("key", self.reads_key),
                               ("value", self.reads_value),
                               ("count", self.reads_count)) if r]
        out = f"reads [{', '.join(cols) or 'nothing'}]"
        if self.key_passthrough:
            out += ", key pass-through"
        if self.select_guard:
            out += ", select-guarded key channel"
        return out


def _deps_of(gm: torch.fx.GraphModule):
    """Forward dependence over the graph: each output leaf's set of input
    (placeholder) indices, and the output leaves."""
    dep: dict[torch.fx.Node, set] = {}
    n_in = 0
    outs = []
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            dep[node] = {n_in}
            n_in += 1
        elif node.op == "output":
            outs = pytree.tree_leaves(node.args[0])
        else:
            s: set = set()
            for inp in node.all_input_nodes:
                s |= dep.get(inp, set())
            dep[node] = s
    return [dep.get(o, set()) if isinstance(o, torch.fx.Node) else set()
            for o in outs], outs, n_in


def _is_where(node: torch.fx.Node) -> bool:
    packet = getattr(node.target, "overloadpacket", None)
    return packet is torch.ops.aten.where


def _key_channel_slice(gm: torch.fx.GraphModule, key_out) -> set:
    """Backward slice: the nodes the key output channel depends on."""
    if not isinstance(key_out, torch.fx.Node):
        return set()
    need, seen = [key_out], {key_out}
    while need:
        node = need.pop()
        for inp in node.all_input_nodes:
            if inp not in seen:
                seen.add(inp)
                need.append(inp)
    return seen


def extract_semantics(app, item_spec) -> StageSemantics:
    """Dependence-slice ``app.map`` over one item of ``item_spec``: a
    ``(key, value, count)`` tuple of ``plan_cache.TensorSpec``."""
    gm = pc.map_graph(app, item_spec)
    out_deps, outs, n_in = _deps_of(gm)
    key_idx, count_idx = {0}, {n_in - 1}
    value_idx = set(range(1, n_in - 1))
    # Emitter.pairs() returns (keys, values): the first output leaf is the
    # key channel, the rest the values
    keys_deps = out_deps[0] if out_deps else set()
    vals_deps: set = set()
    for d in out_deps[1:]:
        vals_deps |= d
    all_deps = keys_deps | vals_deps
    key_slice = _key_channel_slice(gm, outs[0] if outs else None)
    select_guard = any(
        _is_where(node) and isinstance(node.args[0], torch.fx.Node)
        and node.args[0].op != "get_attr" for node in key_slice)
    return StageSemantics(
        reads_key=bool(all_deps & key_idx),
        reads_value=bool(all_deps & value_idx),
        reads_count=bool(all_deps & count_idx),
        key_passthrough=bool(keys_deps) and keys_deps <= key_idx,
        select_guard=select_guard)


class _GuardedEmitter:
    """Emitter proxy that conjoins every emission with the row guard."""

    def __init__(self, inner: eng.Emitter, live: torch.Tensor):
        self._inner = inner
        self._live = live
        self.capacity = inner.capacity
        self.key_space = inner.key_space
        self.value_spec = inner.value_spec

    def __call__(self, keys, values, valid=None):
        return self.emit(keys, values, valid)

    def emit(self, keys, values, valid=None):
        live = self._live
        if valid is not None:
            live = torch.as_tensor(valid, device=live.device).to(
                torch.bool) & live
        self._inner.emit(keys, values, valid=live)


def _guarded_app(app: MapReduceApp, where: Callable | None) -> MapReduceApp:
    """The consumer app whose map sees live rows only: empty producer rows
    (count == 0) and rows failing the edge predicate emit nothing."""
    g = MapReduceApp()
    for attr in ("key_space", "value_spec", "pad_value", "max_values_per_key",
                 "emit_capacity", "manual_combiner"):
        setattr(g, attr, getattr(app, attr))
    g.reduce = app.reduce  # type: ignore[method-assign]

    def gmap(item, emit):
        key, value, count = item[0], item[1], item[2]
        live = count > 0
        if where is not None:
            live = live & torch.as_tensor(where(key, value, count),
                                          device=count.device).to(torch.bool)
        app.map(item, _GuardedEmitter(emit, live))

    g.map = gmap  # type: ignore[method-assign]
    return g


@dataclasses.dataclass
class _Stage:
    mr: MapReduce
    where: Callable | None = None  # the edge predicate into this stage
    guarded: MapReduceApp | None = None  # the wrapped app (stages > 0)
    semantics: StageSemantics | None = None
    dead_value: bool = False

    @property
    def app(self) -> MapReduceApp:
        return self.guarded if self.guarded is not None else self.mr.app


def _value_bytes(app) -> int:
    vs = app.value_spec
    n = 1
    for s in vs.shape:
        n *= int(s)
    return vs.dtype.itemsize * max(1, n)


def _row_spec(app):
    """The one-row item spec of a consumer of ``app``'s table."""
    vs = app.value_spec
    return (pc.TensorSpec((), torch.int32),
            pc.TensorSpec(tuple(vs.shape), vs.dtype),
            pc.TensorSpec((), torch.int32))


class _FusedRun:
    """The prepared runs of a pipeline's stages, dispatched in a row."""

    def __init__(self, stages: list[_Stage]):
        self.runs = [stage_run(st) for st in stages]
        # a producer finalizes its values unless the next stage's value
        # column is dead
        self.values = [not nxt.dead_value for nxt in stages[1:]] + [True]

    def __call__(self, items):
        out = items
        for run, values in zip(self.runs, self.values):
            out = run(out, values=values)
        return out


def stage_run(st: _Stage) -> eng.LocalRun:
    """The stage's prepared run (the first stage: the app; later stages:
    the guarded consumer), shared by the fused and unfused paths."""
    mr = st.mr
    return eng.LocalRun(st.app, mr.plan.flow, mr.plan.spec, device=mr.device,
                        plan=mr.plan, **mr._knobs(ExecutionOptions()))


def _as_mr(job, device) -> MapReduce:
    return job if isinstance(job, MapReduce) else MapReduce(job,
                                                            device=device)


class Pipeline:
    """``Pipeline(job1).then(job2).run(items)`` — a linear MapReduce DAG.

    Each ``then`` edge hands the producer's ``[K]`` table to the consumer
    as ``(key, value, count)`` items.  ``run`` dispatches every stage in a
    row (the fused path: no host round trip, dead value columns never
    finalized); ``run_unfused`` synchronizes and hands the finalized table
    over between stages; both give the same bits.  ``where=`` declares an
    edge filter applied at the consumer's map.  Jobs are apps or
    ``MapReduce`` objects; apps are planned on ``device`` (None: the
    card), and every stage must share one device.  The prepared fused run
    is cached by content like a single job's."""

    def __init__(self, first, *rest, device=None):
        self.stages: list[_Stage] = [_Stage(mr=_as_mr(first, device))]
        self.device = self.stages[0].mr.device
        self._runs: list[eng.LocalRun] | None = None
        for job in rest:
            self.then(job)

    def then(self, job, *, where: Callable | None = None) -> "Pipeline":
        mr = _as_mr(job, self.device)
        if mr.device != self.device:
            raise ValueError(f"a pipeline runs on one device: stage 0 on "
                             f"{self.device}, this job on {mr.device}")
        st = _Stage(mr=mr, where=where, guarded=_guarded_app(mr.app, where))
        try:
            st.semantics = extract_semantics(mr.app,
                                             _row_spec(self.stages[-1].mr.app))
        except Exception:  # a map the tracer refuses: no fusion extras
            st.semantics = None
        # the edge predicate lies outside the consumer map's graph and may
        # read the value column: any where= keeps it live
        st.dead_value = (st.semantics is not None and where is None
                         and not st.semantics.reads_value)
        self.stages.append(st)
        self._runs = None
        return self

    # -- the fusion report ----------------------------------------------------

    def fusion_report(self) -> tuple[str, ...]:
        lines: list[str] = []
        for i, st in enumerate(self.stages[1:], start=1):
            prev = self.stages[i - 1].mr.app
            edge = f"edge {i - 1}->{i}"
            moved = roofline.pipeline_handoff_bytes(
                prev.key_space, value_bytes=_value_bytes(prev),
                dead_value=st.dead_value)
            lines.append(
                f"{edge}: fused handoff — one dispatch, no host round trip; "
                f"the intermediate table [K={prev.key_space}] still crosses "
                f"device memory ({moved / 1e6:.2f} MB written and read back"
                f"{', without the value column' if st.dead_value else ''})")
            if st.semantics is not None:
                lines.append(f"{edge}: consumer map "
                             f"{st.semantics.describe()}")
            if st.dead_value:
                lines.append(
                    f"{edge}: dead column eliminated — consumer never reads "
                    f"the value column; the producer's [K={prev.key_space}] "
                    f"values are not finalized on the fused path (zeros "
                    f"broadcast from one element in their place)")
            if st.where is not None:
                lines.append(f"{edge}: filter pushed below the shuffle — "
                             f"edge predicate masks rows at the consumer map "
                             f"side")
            lines.append(f"{edge}: empty-row guard — producer rows with "
                         f"count==0 auto-masked")
        return tuple(lines)

    def explain(self) -> str:
        out: list[str] = []
        for i, st in enumerate(self.stages):
            plan = dataclasses.replace(st.mr.plan, stage="pipeline",
                                       fusion=())
            out.append(f"[stage {i}] " + plan.explain().replace("\n", "\n  "))
        out.extend(self.fusion_report())
        return "\n".join(out)

    # -- execution ------------------------------------------------------------

    def _cache_key(self, items_spec) -> str:
        parts = ["pipeline", pc.spec_sig_of(items_spec), str(self.device)]
        for i, st in enumerate(self.stages):
            parts.append(st.mr._plan_key)
            spec = (pc.item_spec_of(items_spec) if i == 0
                    else _row_spec(self.stages[i - 1].mr.app))
            parts.append(pc.map_fingerprint(st.app, spec))
            parts.append(f"dead={st.dead_value}")
        return pc._digest(*parts)

    def compile(self, items, *, cache: bool = True) -> _FusedRun:
        """The prepared fused run for the item spec of ``items`` (cached by
        content: an equal pipeline at the same shapes prepares nothing).
        On the card a warm-up call on zeros loads the kernels."""
        if len(self.stages) < 2:
            raise ValueError("a Pipeline needs at least two stages")
        items_spec = pc.items_spec_of(items)
        key = self._cache_key(items_spec)
        if cache:
            ent = pc.compiled_get(key)
            if ent is not None:
                self._note_cache(key, "hit")
                return ent.executable
        pc.STATS.compiles += 1
        fused = _FusedRun(self.stages)
        if self.device.type == "cuda":
            zeros = pytree.tree_map(
                lambda a: torch.zeros(tuple(a.shape), dtype=a.dtype,
                                      device=self.device), items_spec)
            with torch.no_grad():
                fused(zeros)
        if cache:
            pc.compiled_put(key, pc.CompiledEntry(executable=fused,
                                                  mode="pipeline"))
        self._note_cache(key, "miss" if cache else "")
        return fused

    def _note_cache(self, key: str, event: str) -> None:
        plan = self.stages[-1].mr.plan
        plan.cache_key = key
        plan.cache_event = event
        plan.stage = "pipeline"
        plan.fusion = self.fusion_report()

    def run(self, items, *, options: ExecutionOptions | None = None
            ) -> MapReduceResult:
        """The fused path: every stage dispatched in a row."""
        opts = options if options is not None else ExecutionOptions()
        fused = self.compile(items, cache=opts.cache)
        with torch.no_grad():
            keys, values, counts = fused(to_device(items, self.device))
        return MapReduceResult(keys, values, counts,
                               plan=self.stages[-1].mr.plan)

    def run_unfused(self, items) -> MapReduceResult:
        """The reference path: each stage's finalized table handed over
        after a host synchronization.  The same prepared stage runs with
        the same knobs as :meth:`run`, so the same bits."""
        if self._runs is None:
            self._runs = [stage_run(st) for st in self.stages]
        out = to_device(items, self.device)
        with torch.no_grad():
            for i, run in enumerate(self._runs):
                if i and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                out = run(out)
        keys, values, counts = out
        return MapReduceResult(keys, values, counts,
                               plan=self.stages[-1].mr.plan)

    # -- analytics ------------------------------------------------------------

    def model_bytes(self, n_items: int, *, fused: bool) -> float:
        """Modelled device-memory bytes of the pipeline at ``n_items``
        inputs: each stage's flow bytes plus each edge's handoff.  Unfused
        the handoff is the reference's full table; fused, the port still
        moves the table, without the value column on a dead edge
        (ROADMAP C.33)."""
        total = 0.0
        for i, st in enumerate(self.stages):
            app, t = st.mr.app, st.mr.tiling
            n_pairs = ((n_items if i == 0
                        else self.stages[i - 1].mr.app.key_space)
                       * app.emit_capacity)
            total += roofline.mapreduce_flow_bytes(
                st.mr.plan.flow, n_pairs=n_pairs, key_space=app.key_space,
                value_bytes=_value_bytes(app),
                chunk_pairs=t.chunk_pairs if t is not None else None,
                key_block=(t.key_block if st.mr.plan.flow == "stream"
                           and t.blocked else None),
                max_values_per_key=app.max_values_per_key)
        for i, st in enumerate(self.stages[1:], start=1):
            prev = self.stages[i - 1].mr.app
            total += roofline.pipeline_handoff_bytes(
                prev.key_space, value_bytes=_value_bytes(prev),
                dead_value=fused and st.dead_value)
        return total

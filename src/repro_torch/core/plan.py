"""Execution planning: run the optimizer, pick the flow, record the decision.

Counterpart of ``repro/core/plan.py``.  The port runs all four flows:
``flow="auto"`` picks the stream flow for a combinable reducer and the
reduce flow (the paper's baseline) for one the optimizer cannot turn into
a combiner; ``"stream"``, ``"sort"`` and ``"combine"`` force an optimized
flow (an error without a combiner), ``"reduce"`` the baseline.  With a
workload hint (``n_pairs_hint``) ``flow="auto"`` ranks the stream flow
against the sort flow with the cost model (``core/cost_model.py``), in the
profile of the run's device, and records the report on the plan.
``streaming=True`` pins the stream flow for the streaming service.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import combiner as C
from repro_torch.core import cost_model as cm
from repro_torch.core.optimizer import KEY_SPEC, Derivation, derive_combiner

FLOWS = ("auto", "stream", "sort", "combine", "reduce")


@dataclasses.dataclass
class ExecutionPlan:
    flow: str  # "stream" | "sort" | "combine" | "reduce"
    derivation: Derivation | None
    spec: C.CombinerSpec | None
    reason: str = ""
    #: the StreamTiling / SortTiling of the flow (set by the API layer)
    tiling: object | None = None
    #: the cost model's ranking when a workload hint enabled it
    cost: cm.CostReport | None = None
    diagnostics: tuple[str, ...] = ()
    #: the lowering and kernels the combine flow's last run took (set by
    #: the collector at run time; empty before the first run)
    lowering: str = ""
    #: the path the stream or sort flow's last run took through its chunk
    #: loop (``engine.LocalRun``): a CUDA graph captured or replayed, or
    #: the eager loop and why; empty before the first run
    loop: str = ""
    #: the staged path's bookkeeping (``api.Lowered``/``Optimized``/
    #: ``Compiled``): the furthest stage this plan reached, the content key
    #: it was stored or looked up under, and how the lookup went ("hit" |
    #: "miss" | "file-hit"; "" when the cache was bypassed)
    stage: str = ""
    cache_key: str | None = None
    cache_event: str = ""
    #: pipeline fusion decisions (``core/pipeline.py``), one line each
    fusion: tuple[str, ...] = ()
    #: the skew planner's provenance (``core/skew.py``): the sampled
    #: histogram, the balanced boundaries and the hot-key splits
    skew: tuple[str, ...] = ()
    #: the shuffle codec's provenance (``distributed/wire.py``): the codec
    #: and its modelled encoded and raw bytes a shard
    wire: tuple[str, ...] = ()
    #: what a resilient run did to produce its answer
    #: (``fault.RecoveryLog.summary``): restores, recomputes, speculation,
    #: resizes and the control plane's events, one line each
    recovery: tuple[str, ...] = ()

    @property
    def optimized(self) -> bool:
        """True when a derived or manual combiner replaced the baseline
        reduce flow."""
        return self.flow in ("stream", "sort", "combine")

    def explain(self) -> str:
        """What the optimizer decided and why: flow, the staged path's
        stage and plan-cache outcome, combiner, the cost model's ranking,
        tiling, pipeline fusion; after a resilient run, its recovery."""
        lines = [f"flow: {self.flow} ({self.reason})"]
        if self.stage:
            lines.append(f"stage: {self.stage}")
        if self.cache_key is not None:
            lines.append(f"plan-cache: {self.cache_event or 'off'} "
                         f"key={self.cache_key}")
        d = self.derivation
        if d is not None:
            v = "validated" if d.validated else "trusted"
            lines.append(f"combiner: {d.strategy}"
                         + (f" [{self.spec.describe}] ({v})"
                            if self.spec is not None else "")
                         + (f" — {d.failure}" if d.failure else ""))
            lines.append(f"optimizer: detect={d.detect_s * 1e6:.0f}us "
                         f"transform={d.transform_s * 1e3:.2f}ms "
                         f"validate={d.validate_s * 1e3:.2f}ms")
        if self.cost is not None:
            lines.append(self.cost.describe())
        if self.tiling is not None:
            lines.append(f"tiling: {self.tiling.describe()}")
            for note in self.tiling.notes:
                lines.append(f"  - {note}")
        elif self.flow in ("combine", "reduce"):
            lines.append("tiling: none (one map over every item, then one "
                         "pass over the whole pair buffer)")
        if self.lowering:
            lines.append(f"lowering: {self.lowering}")
        if self.loop:
            lines.append(f"loop: {self.loop}")
        for decision in self.fusion:
            lines.append(f"fusion: {decision}")
        for line in self.skew:
            lines.append(f"skew: {line}")
        for line in self.wire:
            lines.append(f"wire: {line}")
        for diag in self.diagnostics:
            lines.append(f"diagnostic: {diag}")
        for event in self.recovery:
            lines.append(f"recovery: {event}")
        return "\n".join(lines)


def _cost_candidates(spec: C.CombinerSpec) -> tuple[str, ...]:
    """Flows the cost model may choose for this combiner: the sort flow
    needs scatter monoids (or the first/size idioms, whose run layout it
    takes directly); coupled holders would fold one pair at a time there,
    with no edge over the stream flow."""
    if (spec.scatter_lowerable
            or spec.strategy in (C.STRATEGY_FIRST, C.STRATEGY_SIZE)):
        return ("stream", "sort")
    return ("stream",)


def _model_holder_bytes(spec: C.CombinerSpec, value_spec: C.ValueSpec) -> int:
    """Holder bytes a key as the cost model prices them: an int64 leaf
    counts 4 bytes, the reference's int32 table (torch sums int32 into
    int64, C.5 in ROADMAP; the tables hold the same values)."""
    return sum(l.numel() * (4 if l.dtype == torch.int64
                            else l.element_size())
               for l in pytree.tree_leaves(spec.init(value_spec)))


def flow_cost_report(app, spec: C.CombinerSpec, n_pairs_hint: int, *,
                     device, skew_factor: float = 1.0, num_shards: int = 1,
                     wire: str = "raw",
                     shuffle_capacity: int | None = None) -> cm.CostReport:
    """Rank the eligible flows for ``app``/``spec`` at a workload size, in
    the profile of ``device`` (``cost_model.default_backend``).

    The planner calls this under ``flow="auto"``; ``chip_smoke.py`` uses it
    directly to hold the model's verdict against measured winners.
    ``num_shards > 1`` prices the shuffled flows' all-to-all under the
    ``wire`` codec."""
    from repro_torch.distributed.wire import dtype_name

    vs = app.value_spec
    value_bytes = vs.dtype.itemsize * max(1, int(np.prod(vs.shape)))
    d, _ = spec.holder_width(vs)
    return cm.choose_flow(
        n_pairs=n_pairs_hint, key_space=app.key_space, d=d,
        value_bytes=value_bytes,
        holder_bytes=_model_holder_bytes(spec, vs),
        max_values_per_key=getattr(app, "max_values_per_key", None),
        candidates=_cost_candidates(spec),
        backend=cm.default_backend(device), skew_factor=skew_factor,
        fold_op="add" if spec.sum_lowerable else "max",
        num_shards=num_shards, wire=wire, shuffle_capacity=shuffle_capacity,
        value_dtype=dtype_name(vs.dtype))


def plan_execution(app, *, flow: str = "auto",
                   trust_semantics: bool = False,
                   n_pairs_hint: int | None = None,
                   device="cuda", streaming: bool = False) -> ExecutionPlan:
    """Pick the execution flow: derive (or take the manual) combiner and
    run the stream flow with it, the forced optimized flow, or the reduce
    flow when forced or when no combiner can be derived.  Under
    ``flow="auto"`` with ``n_pairs_hint`` the cost model ranks the stream
    and sort flows in the profile of ``device`` and the cheapest wins; the
    report lands on ``plan.cost``.

    ``streaming=True`` plans for continuous ingestion (the
    ``MapReduceService`` path): the flow is pinned to "stream", the only
    flow whose carried tables take micro-batches one at a time, and a
    combiner must be derivable (an unbounded stream cannot be buffered
    for the reduce flow); ``n_pairs_hint`` does not move it."""
    if flow not in FLOWS:
        raise ValueError(f"unknown flow {flow!r}")
    if streaming:
        if flow not in ("auto", "stream"):
            raise ValueError(
                f"streaming execution requires the stream flow (its carried "
                f"holder tables are what micro-batches fold into); got "
                f"flow={flow!r}")
        flow = "stream"
    if flow == "reduce":
        return ExecutionPlan("reduce", None, None, reason="forced by user")
    spec = getattr(app, "manual_combiner", None)
    if spec is not None:
        derived = Derivation(spec=spec, strategy=C.STRATEGY_MANUAL,
                             reapply_ok=False, validated=False, detect_s=0.0,
                             transform_s=0.0)
        reason = "manual combiner"
    else:
        derived = derive_combiner(app.reduce, KEY_SPEC, app.value_spec,
                                  trust_semantics=trust_semantics)
        if not derived.combinable:
            if streaming:
                raise ValueError(
                    f"streaming execution needs a derived combiner (an "
                    f"unbounded stream cannot be buffered for the reduce "
                    f"flow) but derivation failed: {derived.failure}")
            if flow != "auto":
                raise ValueError(f"{flow} flow forced but derivation "
                                 f"failed: {derived.failure}")
            return ExecutionPlan("reduce", derived, None,
                                 reason=f"not combinable: {derived.failure}")
        reason = f"derived ({derived.strategy})"
    spec = derived.spec
    if streaming:
        reason += "; streaming pins the stream flow"
    if flow != "auto":
        return ExecutionPlan(flow, derived, spec, reason=reason)
    if n_pairs_hint is not None:
        report = flow_cost_report(app, spec, n_pairs_hint, device=device)
        return ExecutionPlan(
            report.chosen, derived, spec, cost=report,
            reason=f"{reason}; cost model [{report.backend}] at "
                   f"N={n_pairs_hint}")
    return ExecutionPlan("stream", derived, spec, reason=reason)

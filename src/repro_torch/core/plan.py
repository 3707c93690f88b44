"""Execution planning: run the optimizer, pick the flow, record the decision.

Counterpart of ``repro/core/plan.py``.  The port runs all four flows:
``flow="auto"`` picks the stream flow for a combinable reducer and the
reduce flow (the paper's baseline) for one the optimizer cannot turn into
a combiner; ``"stream"``, ``"sort"`` and ``"combine"`` force an optimized
flow (an error without a combiner), ``"reduce"`` the baseline.  There is
no cost model yet, so ``n_pairs_hint`` (with which the reference ranks
stream against sort) raises: the reference's cost-model profiles were
measured for a TPU and a CPU, not for this card.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import combiner as C
from repro_torch.core.optimizer import KEY_SPEC, Derivation, derive_combiner

FLOWS = ("auto", "stream", "sort", "combine", "reduce")

#: the ROADMAP item that ports the cost model behind ``n_pairs_hint``
COST_MODEL_ITEM = "A6 (cost model and flow=auto ranking)"


@dataclasses.dataclass
class ExecutionPlan:
    flow: str  # "stream" | "sort" | "combine" | "reduce"
    derivation: Derivation | None
    spec: C.CombinerSpec | None
    reason: str = ""
    #: the StreamTiling / SortTiling of the flow (set by the API layer)
    tiling: object | None = None
    diagnostics: tuple[str, ...] = ()
    #: the lowering and kernels the combine flow's last run took (set by
    #: the collector at run time; empty before the first run)
    lowering: str = ""

    @property
    def optimized(self) -> bool:
        """True when a derived or manual combiner replaced the baseline
        reduce flow."""
        return self.flow in ("stream", "sort", "combine")

    def explain(self) -> str:
        """What the optimizer decided and why: flow, combiner, tiling."""
        lines = [f"flow: {self.flow} ({self.reason})"]
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
        if self.tiling is not None:
            lines.append(f"tiling: {self.tiling.describe()}")
            for note in self.tiling.notes:
                lines.append(f"  - {note}")
        elif self.flow in ("combine", "reduce"):
            lines.append("tiling: none (one map over every item, then one "
                         "pass over the whole pair buffer)")
        if self.lowering:
            lines.append(f"lowering: {self.lowering}")
        for diag in self.diagnostics:
            lines.append(f"diagnostic: {diag}")
        return "\n".join(lines)


def plan_execution(app, *, flow: str = "auto",
                   trust_semantics: bool = False,
                   n_pairs_hint: int | None = None) -> ExecutionPlan:
    """Pick the execution flow: derive (or take the manual) combiner and
    run the stream flow with it, the forced optimized flow, or the reduce
    flow when forced or when no combiner can be derived."""
    if flow not in FLOWS:
        raise ValueError(f"unknown flow {flow!r}")
    if n_pairs_hint is not None:
        raise NotImplementedError(
            f"n_pairs_hint={n_pairs_hint}: the cost model that ranks the "
            f"flows for a workload size is not ported to repro_torch yet "
            f"(ROADMAP {COST_MODEL_ITEM}); pass flow='stream' or "
            f"flow='sort'")
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
            if flow != "auto":
                raise ValueError(f"{flow} flow forced but derivation "
                                 f"failed: {derived.failure}")
            return ExecutionPlan("reduce", derived, None,
                                 reason=f"not combinable: {derived.failure}")
        reason = f"derived ({derived.strategy})"
    return ExecutionPlan("stream" if flow == "auto" else flow, derived,
                         derived.spec, reason=reason)

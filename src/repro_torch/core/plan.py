"""Execution planning: run the optimizer, pick the flow, record the decision.

Counterpart of ``repro/core/plan.py``.  The port runs the stream flow only;
every other flow, and a reducer the optimizer cannot turn into a combiner
(the reference would run it in the reduce flow), raises
``NotImplementedError`` naming the ROADMAP item that ports it.  There is no
cost model and no ``n_pairs_hint`` yet: the reference's cost-model profiles
were measured for a TPU and a CPU, not for this card.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import combiner as C
from repro_torch.core.optimizer import KEY_SPEC, Derivation, derive_combiner

FLOWS = ("auto", "stream", "sort", "combine", "reduce")

#: ROADMAP items that port the flows the port cannot run yet
NOT_PORTED = {
    "sort": "A7 (sort flow)",
    "combine": "A8 (combine and reduce flows)",
    "reduce": "A8 (combine and reduce flows)",
}


@dataclasses.dataclass
class ExecutionPlan:
    flow: str  # "stream"
    derivation: Derivation | None
    spec: C.CombinerSpec | None
    reason: str = ""
    #: the StreamTiling chosen for the stream flow (set by the API layer)
    tiling: object | None = None
    diagnostics: tuple[str, ...] = ()

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
        for diag in self.diagnostics:
            lines.append(f"diagnostic: {diag}")
        return "\n".join(lines)


def _not_ported(flow: str, why: str) -> NotImplementedError:
    return NotImplementedError(
        f"{why}: the {flow} flow is not ported to repro_torch yet "
        f"(ROADMAP {NOT_PORTED[flow]})")


def plan_execution(app, *, flow: str = "auto",
                   trust_semantics: bool = False) -> ExecutionPlan:
    """Pick the execution flow: derive (or take the manual) combiner and
    run the stream flow with it."""
    if flow not in FLOWS:
        raise ValueError(f"unknown flow {flow!r}")
    if flow in NOT_PORTED:
        raise _not_ported(flow, f"flow={flow!r} requested")
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
            if flow == "stream":
                raise ValueError(f"stream flow forced but derivation "
                                 f"failed: {derived.failure}")
            raise _not_ported("reduce", f"not combinable "
                                        f"({derived.failure})")
        reason = f"derived ({derived.strategy})"
    return ExecutionPlan("stream", derived, derived.spec, reason=reason)

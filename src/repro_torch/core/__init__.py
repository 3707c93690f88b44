"""The port's core: combiner derivation, planning, tiling and the four
local flows (stream, sort, combine and reduce)."""

from repro_torch.core.api import (ExecutionOptions, MapReduce, MapReduceApp,
                                  MapReduceResult, make_app)
from repro_torch.core.autotune import (StreamTiling, autotune_sort,
                                       autotune_stream)
from repro_torch.core.collector import LoweringFallbackWarning, StreamCombiner
from repro_torch.core.combiner import (CombinerSpec, Monoid, ValueSpec,
                                       count_spec, logsumexp_spec, max_spec,
                                       mean_spec, min_spec, monoid_spec,
                                       product_spec, sum_spec)
from repro_torch.core.cost_model import (CostReport, FlowCost, choose_flow,
                                         estimate_flow_cost)
from repro_torch.core.engine import Emitter
from repro_torch.core.optimizer import Derivation, derive_combiner
from repro_torch.core.plan import FLOWS, ExecutionPlan, plan_execution

__all__ = [
    "FLOWS", "CombinerSpec", "CostReport", "Derivation", "Emitter",
    "ExecutionOptions", "ExecutionPlan", "FlowCost",
    "LoweringFallbackWarning", "MapReduce", "MapReduceApp",
    "MapReduceResult", "Monoid", "StreamCombiner", "StreamTiling",
    "ValueSpec", "autotune_sort", "autotune_stream", "choose_flow",
    "count_spec", "derive_combiner", "estimate_flow_cost", "logsumexp_spec",
    "make_app", "max_spec", "mean_spec", "min_spec", "monoid_spec",
    "plan_execution", "product_spec", "sum_spec",
]

"""The port's core: combiner derivation, planning, tiling, the four flows
(stream, sort, combine and reduce) on one device and over a shard mesh,
the resilient driver over the shards, the skew planner of the shuffle,
the staged API with its plan cache, and multi-job pipelines."""

from repro_torch.core.api import (Compiled, ExecutionOptions, Lowered,
                                  MapReduce, MapReduceApp, MapReduceResult,
                                  Optimized, make_app)
from repro_torch.core.autotune import (StreamTiling, autotune_sort,
                                       autotune_stream)
from repro_torch.core.collector import LoweringFallbackWarning, StreamCombiner
from repro_torch.core.combiner import (CombinerSpec, Monoid, ValueSpec,
                                       count_spec, logsumexp_spec, max_spec,
                                       mean_spec, min_spec, monoid_spec,
                                       product_spec, sum_spec)
from repro_torch.core.cost_model import (CostReport, FlowCost, choose_flow,
                                         estimate_flow_cost)
from repro_torch.core.engine import Emitter, run_resilient
from repro_torch.core.optimizer import Derivation, derive_combiner
from repro_torch.core.pipeline import (Pipeline, StageSemantics,
                                       extract_semantics)
from repro_torch.core.plan import FLOWS, ExecutionPlan, plan_execution
from repro_torch.core.plan_cache import CacheStats, stats_snapshot
from repro_torch.core.skew import ShuffleOptions, ShufflePlan, SkewProfile

__all__ = [
    "FLOWS", "CacheStats", "CombinerSpec", "Compiled", "CostReport",
    "Derivation", "Emitter", "ExecutionOptions", "ExecutionPlan", "FlowCost",
    "LoweringFallbackWarning", "Lowered", "MapReduce", "MapReduceApp",
    "MapReduceResult", "Monoid", "Optimized", "Pipeline", "ShuffleOptions",
    "ShufflePlan", "SkewProfile", "StageSemantics",
    "StreamCombiner", "StreamTiling", "ValueSpec", "autotune_sort",
    "autotune_stream", "choose_flow", "count_spec", "derive_combiner",
    "estimate_flow_cost", "extract_semantics", "logsumexp_spec", "make_app",
    "max_spec", "mean_spec", "min_spec", "monoid_spec", "plan_execution",
    "product_spec", "run_resilient", "stats_snapshot", "sum_spec",
]

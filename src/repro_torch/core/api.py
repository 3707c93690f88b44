"""Public API of the port — ``MapReduce(app).run(items)``.

Counterpart of the local-run part of ``repro/core/api.py``.  The user
writes ``map`` and ``reduce`` with torch ops::

    class WordCount(MapReduceApp):
        key_space = VOCAB
        value_spec = ValueSpec((), torch.int32)

        def map(self, window, emit):        # window: [16] token ids
            emit(window, torch.ones_like(window))

        def reduce(self, key, values, count):
            return values.sum()

    result = MapReduce(WordCount()).run(token_windows)

The run happens on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without ``device="cpu"`` the constructor raises.
``use_kernels`` (default: on when the device is CUDA) routes the folds
through the hand-written kernels.  Staging (``lower/optimize/compile``),
the plan cache, distributed, resilient and served runs are not ported yet
(ROADMAP A9, A11–A13).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import autotune as at
from repro_torch.core import combiner as C
from repro_torch.core import engine as eng
from repro_torch.core.plan import ExecutionPlan, plan_execution


class MapReduceApp:
    """Subclass and provide map/reduce; set the class attributes.

    key_space: dense key-id capacity K (keys are int32 in [0, K)).
    value_spec: shape and dtype of one emitted value.
    emit_capacity: max pairs one ``map(item, emit)`` call may emit.
    max_values_per_key: Lmax of the reduce flow (kept for parity; the port
    has no reduce flow yet).
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


@dataclasses.dataclass(frozen=True)
class ExecutionOptions:
    """Run-time overrides of the stream flow's lowering; ``None`` keeps
    the MapReduce constructor's choice."""

    use_kernels: bool | None = None
    chunk_pairs: int | None = None
    key_block: int | None = None


@dataclasses.dataclass
class MapReduceResult:
    keys: torch.Tensor  # [K] = arange(K)
    values: Any  # [K, ...]
    counts: torch.Tensor  # [K]; 0 == key never emitted
    plan: ExecutionPlan | None = None

    @property
    def diagnostics(self) -> tuple[str, ...]:
        return self.plan.diagnostics if self.plan is not None else ()

    def to_dict(self) -> dict:
        """Host-side {key: value} for present keys (tests, small results)."""
        counts = self.counts.cpu().numpy()
        vals = pytree.tree_map(lambda v: v.cpu().numpy(), self.values)
        return {int(k): pytree.tree_map(lambda v: v[k], vals)
                for k in np.nonzero(counts > 0)[0]}


def resolve_device(device) -> torch.device:
    """``None`` means the card; a CUDA device needs one to be present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def to_device(items, device):
    """Items (tensors or numpy arrays, or a tuple of them) on ``device``."""
    return pytree.tree_map(lambda a: torch.as_tensor(a).to(device), items)


class MapReduce:
    """``MapReduce(app).run(items)`` — the framework entry point.

    flow: "auto" or "stream" (the only flow ported so far).  Construction
    plans: derives the combiner from ``app.reduce`` (or takes
    ``app.manual_combiner``) and tiles the stream fold;
    ``stream_chunk_pairs`` / ``stream_key_block`` pin the tiling.
    """

    def __init__(self, app: MapReduceApp, *, flow: str = "auto",
                 trust_semantics: bool = False,
                 use_kernels: bool | None = None,
                 stream_chunk_pairs: int | str = "auto",
                 stream_key_block: int | str | None = "auto",
                 device=None):
        if app.key_space <= 0:
            raise ValueError("app.key_space must be positive")
        self.device = resolve_device(device)
        self.app = app
        self.use_kernels = (self.device.type == "cuda" if use_kernels is None
                            else use_kernels)
        self.plan = plan_execution(app, flow=flow,
                                   trust_semantics=trust_semantics)
        self.tiling = at.autotune_stream(
            app, self.plan.spec, device=self.device,
            use_kernels=self.use_kernels, chunk_pairs=stream_chunk_pairs,
            key_block=stream_key_block)
        self.plan.tiling = self.tiling
        if self.tiling.mode == "scatter" and self.plan.spec.sum_lowerable:
            self.plan.diagnostics += (
                "stream fold degraded to exact scatter (dense budget "
                "exceeded) — see tiling notes",)

    def run(self, items, *, options: ExecutionOptions | None = None,
            n_valid: int | None = None) -> MapReduceResult:
        """Run the stream flow over ``items`` (the first ``n_valid`` of
        them when given) and finalize the tables."""
        opts = options if options is not None else ExecutionOptions()
        use_kernels = (self.use_kernels if opts.use_kernels is None
                       else opts.use_kernels)
        chunk = (self.tiling.chunk_pairs if opts.chunk_pairs is None
                 else opts.chunk_pairs)
        key_block = (opts.key_block if opts.key_block is not None else
                     self.tiling.key_block if self.tiling.blocked else None)
        items = to_device(items, self.device)
        with torch.no_grad():
            keys, values, counts = eng.run_local_stream(
                self.app, self.plan.spec, items, chunk_pairs=chunk,
                device=self.device, use_kernels=use_kernels,
                key_block=key_block, n_valid=n_valid)
        return MapReduceResult(keys, values, counts, self.plan)

    def explain(self) -> str:
        return self.plan.explain()

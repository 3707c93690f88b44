"""The semantic-aware optimizer: derive a CombinerSpec from a torch reduce.

Counterpart of ``repro/core/optimizer.py``.  The steps are the same:

  1. trace the reducer and slice its aten graph   -> ``semantics.analyze``
  2. the dim-0 reductions are the loop over values -> the frontier
  3-5. synthesize init / combine / finalize       -> :func:`_synthesize`
  6. validate numerically (unless trusted), then flip the flow.

Strategies: monoid extraction, the first-element and size-only idioms.  The
reference's scan-fold strategy has no aten counterpart (see
``semantics``); such reducers get no spec, and the port has no reduce flow
to run them yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import numerics
from repro_torch.core import combiner as C
from repro_torch.core import plan_cache as pc
from repro_torch.core import semantics as S

KEY_SPEC = C.ValueSpec((), torch.int32)


@dataclasses.dataclass
class Derivation:
    """Result of running the optimizer on one reducer."""

    spec: C.CombinerSpec | None
    strategy: str
    #: reduce may be re-applied to its own partial results
    reapply_ok: bool
    validated: bool
    detect_s: float
    transform_s: float
    validate_s: float = 0.0
    failure: str = ""

    @property
    def combinable(self) -> bool:
        return self.spec is not None

    @property
    def recommended_flow(self) -> str:
        return "stream" if self.spec is not None else "reduce"

    @property
    def mergeable_partials(self) -> bool:
        """Whether two partial tables folded apart can be merged exactly
        afterwards: ``spec.merge`` or the Hadoop reapply contract.  A
        windowed streaming service merges its window slots' partials at
        query time, so it needs this; without it a service can still
        aggregate globally (one carried table)."""
        return self.spec is not None and (self.spec.merge is not None
                                          or self.spec.reapply_ok)


def derive_combiner(reduce_fn: Callable, key_spec: C.ValueSpec,
                    value_spec: C.ValueSpec, *, max_len: int = 8,
                    trust_semantics: bool = False, validate_trials: int = 3,
                    rtol: float = 1e-4, atol: float = 1e-4) -> Derivation:
    """Run the optimizer on one reduce function."""
    pc.STATS.derives += 1
    t0 = time.perf_counter()
    try:
        an = S.analyze(reduce_fn, key_spec, value_spec, max_len=max_len)
        failure = ""
    except S.ExtractionFailure as e:
        an = None
        failure = str(e)
    detect_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    spec = None
    strategy = "none"
    if an is not None:
        try:
            spec, strategy = _synthesize(an)
        except S.ExtractionFailure as e:
            failure = str(e)
    transform_s = time.perf_counter() - t1

    t2 = time.perf_counter()
    validated = False
    ksamp = key_spec.zeros(device="cpu")
    if spec is not None and not trust_semantics:
        try:
            ok = C.validate_combiner(spec, reduce_fn, value_spec,
                                     key_sample=ksamp, trials=validate_trials,
                                     rtol=rtol, atol=atol)
            why = "numeric validation probe failed"
        except RuntimeError as e:  # e.g. a reducer written for L values only
            ok, why = False, f"validation probe raised {e}"
        if ok:
            validated = True
        else:
            failure = f"{strategy}: {why}"
            spec, strategy = None, "none"
    reapply_ok = (False if trust_semantics else
                  _probe_reapply(reduce_fn, ksamp, value_spec, rtol=rtol,
                                 atol=atol))
    if spec is not None and spec.merge is None and reapply_ok:
        spec = dataclasses.replace(spec, reapply_ok=True)
    validate_s = time.perf_counter() - t2

    return Derivation(spec=spec, strategy=strategy, reapply_ok=reapply_ok,
                      validated=validated, detect_s=detect_s,
                      transform_s=transform_s, validate_s=validate_s,
                      failure=failure)


def _synthesize(an: S.Analysis) -> tuple[C.CombinerSpec, str]:
    if not an.frontiers:
        return _size_only(an), C.STRATEGY_SIZE
    return _monoid_or_first(an)


def _size_only(an: S.Analysis) -> C.CombinerSpec:
    """Paper idiom 2: the reducer uses only the count (and key)."""
    fin = S.build_finalize(an)
    return C.CombinerSpec(
        strategy=C.STRATEGY_SIZE, init=lambda value_spec: (),
        premap=lambda values: (), combine=lambda h, m, n: (),
        merge=lambda a, b, na, nb: (),
        finalize=lambda key, holder, count: fin(key, (), count), monoids=(),
        describe="idiom:size-only")


def _monoid_or_first(an: S.Analysis) -> tuple[C.CombinerSpec, str]:
    fronts = an.frontiers
    premap = S.build_premap(an)

    def init(value_spec):
        mapped = premap(value_spec.zeros(1, device="cpu"))
        return tuple(
            f.monoid.identity_like(m.shape[1:], m.dtype, device="cpu")
            if f.kind == "monoid"
            else torch.zeros(m.shape[1:], dtype=m.dtype)
            for f, m in zip(fronts, mapped))

    def combine(holder, mapped, n):
        return tuple(
            f.monoid.op(h, m) if f.kind == "monoid"
            else torch.where(n == 0, m, h)
            for f, h, m in zip(fronts, holder, mapped))

    def merge(a, b, na, nb):
        return tuple(
            f.monoid.op(x, y) if f.kind == "monoid"
            else torch.where(na > 0, x, y)
            for f, x, y in zip(fronts, a, b))

    finalize = S.build_finalize(an)
    all_monoid = all(f.kind == "monoid" for f in fronts)
    strategy = C.STRATEGY_MONOID if all_monoid else C.STRATEGY_FIRST
    desc = "+".join(f"monoid<{f.monoid.name}>" if f.kind == "monoid"
                    else "first" for f in fronts)
    return C.CombinerSpec(
        strategy=strategy, init=init, premap=premap, combine=combine,
        merge=merge, finalize=finalize,
        monoids=tuple(f.monoid for f in fronts) if all_monoid else None,
        describe=f"extracted:{desc}"), strategy


def _probe_reapply(reduce_fn, key_sample, value_spec: C.ValueSpec, *, rtol,
                   atol, trials: int = 3, seed: int = 1) -> bool:
    """Check reduce(key, [reduce(A), reduce(B)], 2) == reduce(key, A++B),
    under ``numerics``' half-precision rule."""
    rng = np.random.default_rng(seed)

    def count(n):
        return torch.tensor(n, dtype=torch.int32)

    with torch.no_grad(), numerics.HalfAccumulation():
        for _ in range(trials):
            # an UNEQUAL split: equal halves would let mean-like reducers pass
            vals = C.rand_values(rng, value_spec, 8)
            try:
                whole = reduce_fn(key_sample, vals, count(8))
                ra = reduce_fn(key_sample, vals[:3], count(3))
                rb = reduce_fn(key_sample, vals[3:], count(5))
            except RuntimeError:
                return False
            # the partial result must be re-consumable as a value
            if not all(isinstance(r, torch.Tensor)
                       and tuple(r.shape) == tuple(value_spec.shape)
                       and r.dtype == value_spec.dtype for r in (ra, rb)):
                return False
            again = reduce_fn(key_sample, torch.stack([ra, rb]), count(2))
            if not np.allclose(whole.double().numpy(), again.double().numpy(),
                               rtol=rtol, atol=atol):
                return False
    return True

"""CombinerSpec: initialize/combine/merge/finalize plus a premap, in PyTorch.

Counterpart of ``repro/core/combiner.py``: the optimizer rewrites a user
``reduce`` into this record and the stream collector folds pair chunks
through it.  Two differences in idiom:

* ``premap`` takes a BATCH of values ``[n, *value_shape]`` and returns its
  channels batched the same way (the reference vmaps a per-value premap);
* holders are pytrees of tensors (``torch.utils._pytree``), and a value's
  shape and dtype travel as a :class:`ValueSpec` (the reference's
  ``jax.ShapeDtypeStruct``).

Max and min monoids follow JAX's NaN and signed-zero rules
(``repro_torch.numerics``), so folds agree with the reference bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import numerics
from repro_torch.device import resolve_device

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ValueSpec:
    """Shape and dtype of one value (the reference's ShapeDtypeStruct)."""

    shape: tuple[int, ...]
    dtype: torch.dtype

    def zeros(self, n: int | None = None, device=None) -> torch.Tensor:
        """Zeros of ``n`` values (one value when ``n`` is None); ``device``
        None means the card, as everywhere in the port."""
        lead = () if n is None else (n,)
        return torch.zeros(lead + tuple(self.shape), dtype=self.dtype,
                           device=resolve_device(device))

    @classmethod
    def of(cls, t: torch.Tensor) -> "ValueSpec":
        return cls(tuple(t.shape), t.dtype)


# ---------------------------------------------------------------------------
# Monoids
# ---------------------------------------------------------------------------


def _min_identity(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).max


def _max_identity(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("-inf")
    if dtype == torch.bool:
        return False
    return torch.iinfo(dtype).min


def _sum(x, dim):
    return torch.sum(x, dim=dim, dtype=x.dtype)


def _prod(x, dim):
    for d in sorted((dim,) if isinstance(dim, int) else dim, reverse=True):
        x = torch.prod(x, dim=d, dtype=x.dtype)
    return x


def _all(x, dim):
    return numerics.amin(x.to(torch.bool), dim)


def _any(x, dim):
    return numerics.amax(x.to(torch.bool), dim)


def _valid_pairs(table, keys, chan):
    valid = (keys >= 0) & (keys < table.shape[0])
    return keys[valid].long(), chan[valid].to(table.dtype)


def _scatter_add(table, keys, chan):
    k, v = _valid_pairs(table, keys, chan)
    if table.is_floating_point():
        # sort-based accumulation: the same bits on every run, on the card too
        return table.index_put((k,), v, accumulate=True)
    return table.index_add(0, k, v)  # integer atomics: exact in any order


def _scatter_mul(table, keys, chan):
    k, v = _valid_pairs(table, keys, chan)
    idx = k.view((-1,) + (1,) * (v.ndim - 1)).expand_as(v)
    return table.scatter_reduce(0, idx, v, "prod", include_self=True)


@dataclasses.dataclass(frozen=True)
class Monoid:
    """A binary associative operation with identity, on one tensor leaf."""

    name: str
    op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    identity: Callable[[torch.dtype], Any]  # dtype -> scalar identity
    #: ``scatter(table, keys, chan)``: ``table.at[keys].<op>(chan)`` with
    #: keys outside ``[0, K)`` dropped
    scatter: Callable | None = None
    #: ``dense_reduce(masked, dim)``: reduction of an identity-masked
    #: expansion along ``dim`` (an int or a tuple of ints)
    dense_reduce: Callable | None = None
    #: whether ``op`` is a plain sum (one-hot contraction / onehot_fold)
    is_additive: bool = False

    def identity_like(self, shape, dtype, device=None) -> torch.Tensor:
        return torch.full(tuple(shape), self.identity(dtype), dtype=dtype,
                          device=resolve_device(device))


ADD = Monoid("add", torch.add, lambda dt: False if dt == torch.bool else 0,
             _scatter_add, _sum, is_additive=True)
MUL = Monoid("mul", torch.mul, lambda dt: True if dt == torch.bool else 1,
             _scatter_mul, _prod)
MAX = Monoid("max", numerics.maximum, _max_identity,
             lambda t, k, c: numerics.scatter_extremum(t, k, c, "max"),
             numerics.amax)
MIN = Monoid("min", numerics.minimum, _min_identity,
             lambda t, k, c: numerics.scatter_extremum(t, k, c, "min"),
             numerics.amin)
AND = Monoid("and", torch.logical_and, lambda dt: True,
             lambda t, k, c: numerics.scatter_extremum(t, k, c, "min"), _all)
OR = Monoid("or", torch.logical_or, lambda dt: False,
            lambda t, k, c: numerics.scatter_extremum(t, k, c, "max"), _any)

MONOIDS = {m.name: m for m in (ADD, MUL, MAX, MIN, AND, OR)}


# ---------------------------------------------------------------------------
# CombinerSpec
# ---------------------------------------------------------------------------

STRATEGY_MONOID = "monoid"  # premap . monoid-reduce . finalize, from the graph
STRATEGY_FIRST = "idiom_first"  # the reducer uses only values[0]
STRATEGY_SIZE = "idiom_size"  # the reducer uses only the count
STRATEGY_MANUAL = "manual"  # user-supplied spec
#: the reference's fifth strategy; the port derives no spec of this kind
#: (a fold over values has no aten counterpart), but product_spec of
#: non-monoid parts still reports it, as in the reference.
STRATEGY_SCAN = "scan_fold"


@dataclasses.dataclass(frozen=True)
class CombinerSpec:
    """initialize/combine/finalize plus cross-shard merge and premap.

    * ``init(value_spec) -> holder``            identity holder (on the CPU)
    * ``premap(values[n, ...]) -> mapped``      batched pre-map (map side)
    * ``combine(holder, mapped, n) -> holder``  fold ONE mapped value; ``n``
                                                is the number already folded
    * ``merge(a, b, na, nb) -> holder``         merge of partial holders
    * ``finalize(key, holder, count) -> value`` holder to the final value
    """

    strategy: str
    init: Callable[[ValueSpec], PyTree]
    premap: Callable[[torch.Tensor], PyTree]
    combine: Callable[[PyTree, PyTree, torch.Tensor], PyTree]
    merge: Callable[[PyTree, PyTree, torch.Tensor, torch.Tensor], PyTree] | None
    finalize: Callable[[Any, PyTree, torch.Tensor], PyTree]
    #: per-holder-leaf monoids when the combine is leafwise
    monoids: tuple[Monoid, ...] | None = None
    describe: str = ""
    reapply_ok: bool = False

    @property
    def scatter_lowerable(self) -> bool:
        """True if every holder leaf folds by a monoid scatter."""
        return self.monoids is not None and all(
            m.scatter is not None for m in self.monoids)

    @property
    def sum_lowerable(self) -> bool:
        """True if the combine is a pure sum (the reference's
        ``mxu_lowerable``): one-hot contraction / ``onehot_fold``."""
        return self.monoids is not None and all(m.is_additive
                                                for m in self.monoids)

    def holder_specs(self, value_spec: ValueSpec) -> PyTree:
        return pytree.tree_map(ValueSpec.of, self.init(value_spec))

    def holder_width(self, value_spec: ValueSpec) -> tuple[int, int]:
        """(holder elements per key, holder bytes per key)."""
        leaves = pytree.tree_leaves(self.init(value_spec))
        elems = sum(int(np.prod(l.shape)) for l in leaves)
        nbytes = sum(l.numel() * l.element_size() for l in leaves)
        return max(elems, 1), nbytes

    def kernel_additive_ok(self, value_spec: ValueSpec) -> bool:
        """Whether the fused additive kernel (one f32 accumulator) can carry
        the holders: float holders only, as in the reference."""
        return self.sum_lowerable and all(
            l.is_floating_point()
            for l in pytree.tree_leaves(self.init(value_spec)))

    def kernel_int_additive_ok(self, value_spec: ValueSpec) -> bool:
        """Whether the integer fold kernel (``int_fold``) can carry the
        holders: a pure sum whose every holder leaf is an integer table.
        Like the fused kernel it expands no ``[chunk, K]`` one-hot, so the
        dense fold budget does not bind it."""
        leaves = pytree.tree_leaves(self.init(value_spec))
        return self.sum_lowerable and len(leaves) > 0 and all(
            not l.is_floating_point() and not l.is_complex()
            and l.dtype != torch.bool for l in leaves)

    def kernel_monoid_ok(self, value_spec: ValueSpec) -> bool:
        """Whether chunk_monoid_fold can carry the holders: f32 tables and
        add/max/min on every leaf."""
        return (self.monoids is not None and len(self.monoids) > 0
                and all(m.name in ("add", "max", "min") for m in self.monoids)
                and all(l.dtype == torch.float32
                        for l in pytree.tree_leaves(self.init(value_spec))))

    def init_tables(self, key_space: int, value_spec: ValueSpec,
                    device=None) -> tuple[PyTree, torch.Tensor]:
        """Identity-initialized holder tables ``[K, *holder]`` and counts."""
        device = resolve_device(device)
        tables = pytree.tree_map(
            lambda l: l.to(device).expand((key_space,) + tuple(l.shape))
            .clone(), self.init(value_spec))
        counts = torch.zeros((key_space,), dtype=torch.int32, device=device)
        return tables, counts


def _identity(v):
    return v


def monoid_spec(monoid: Monoid | str, *, premap: Callable = _identity,
                finalize: Callable | None = None,
                describe: str = "") -> CombinerSpec:
    """Single-monoid combiner (sum, max, ...); ``premap`` is batched."""
    m = MONOIDS[monoid] if isinstance(monoid, str) else monoid

    def init(value_spec):
        mapped = premap(value_spec.zeros(1, device="cpu"))
        return pytree.tree_map(
            lambda x: m.identity_like(x.shape[1:], x.dtype, device="cpu"),
            mapped)

    def combine(holder, mapped, n):
        del n
        return pytree.tree_map(m.op, holder, mapped)

    def merge(a, b, na, nb):
        del na, nb
        return pytree.tree_map(m.op, a, b)

    def default_finalize(key, holder, count):
        del key, count
        return holder

    return CombinerSpec(
        strategy=STRATEGY_MONOID, init=init, premap=premap, combine=combine,
        merge=merge, finalize=finalize or default_finalize, monoids=(m,),
        describe=describe or f"monoid<{m.name}>")


def product_spec(specs: Sequence[CombinerSpec], finalize,
                 describe="") -> CombinerSpec:
    """Product of combiners: the holder is the tuple of component holders."""
    specs = tuple(specs)

    def init(value_spec):
        return tuple(s.init(value_spec) for s in specs)

    def premap(values):
        return tuple(s.premap(values) for s in specs)

    def combine(holder, mapped, n):
        return tuple(s.combine(h, m, n)
                     for s, h, m in zip(specs, holder, mapped))

    def merge(a, b, na, nb):
        return tuple(s.merge(x, y, na, nb) for s, x, y in zip(specs, a, b))

    mono: tuple[Monoid, ...] | None = ()
    for s in specs:
        if s.monoids is None:
            mono = None
            break
        mono = mono + s.monoids  # type: ignore[operator]

    return CombinerSpec(
        strategy=STRATEGY_MONOID if mono is not None else STRATEGY_SCAN,
        init=init, premap=premap, combine=combine,
        merge=merge if all(s.merge is not None for s in specs) else None,
        finalize=finalize, monoids=mono,
        describe=describe or "product(" + ",".join(s.describe for s in specs)
        + ")")


def sum_spec(**kw) -> CombinerSpec:
    return monoid_spec(ADD, describe="sum", **kw)


def max_spec(**kw) -> CombinerSpec:
    return monoid_spec(MAX, describe="max", **kw)


def min_spec(**kw) -> CombinerSpec:
    return monoid_spec(MIN, describe="min", **kw)


def mean_spec() -> CombinerSpec:
    def finalize(key, holder, count):
        del key
        return holder / torch.clamp(count, min=1).to(holder.dtype)

    return monoid_spec(ADD, finalize=finalize, describe="mean")


def count_spec() -> CombinerSpec:
    """The size-only idiom: the result is a function of the count alone."""
    return CombinerSpec(
        strategy=STRATEGY_SIZE, init=lambda value_spec: (),
        premap=lambda values: (), combine=lambda h, m, n: (),
        merge=lambda a, b, na, nb: (),
        finalize=lambda key, holder, count: count, monoids=(),
        describe="count")


def logsumexp_spec() -> CombinerSpec:
    """(m, l) running-max / rescaled-sum combiner; coupled holders, so it
    folds through the sequential path."""

    def init(value_spec):
        return (torch.full(value_spec.shape, float("-inf"),
                           dtype=value_spec.dtype),
                torch.zeros(value_spec.shape, dtype=value_spec.dtype))

    def premap(values):
        return (values, torch.ones_like(values))

    def _merge2(a, b):
        ma, la = a
        mb, lb = b
        m = numerics.maximum(ma, mb)
        zero = torch.zeros_like(la)
        sa = torch.where(torch.isneginf(ma), zero, la * torch.exp(ma - m))
        sb = torch.where(torch.isneginf(mb), zero, lb * torch.exp(mb - m))
        return (m, sa + sb)

    def finalize(key, holder, count):
        del key, count
        m, l = holder
        return m + torch.log(l)

    return CombinerSpec(
        strategy=STRATEGY_MONOID, init=init, premap=premap,
        combine=lambda h, m, n: _merge2(h, m),
        merge=lambda a, b, na, nb: _merge2(a, b), finalize=finalize,
        monoids=None, describe="logsumexp")


# ---------------------------------------------------------------------------
# Algebraic validation probes
# ---------------------------------------------------------------------------


def rand_values(rng: np.random.Generator, value_spec: ValueSpec,
                n: int) -> torch.Tensor:
    shape = (n,) + tuple(value_spec.shape)
    dt = value_spec.dtype
    if dt.is_floating_point:
        return torch.from_numpy(rng.standard_normal(shape)).to(dt)
    if dt == torch.bool:
        return torch.from_numpy(rng.integers(0, 2, size=shape).astype(bool))
    return torch.from_numpy(rng.integers(-4, 5, size=shape)).to(dt)


def fold_values(spec: CombinerSpec, values: torch.Tensor) -> PyTree:
    """Reference fold of ``values[0..n)`` through the spec, one at a time."""
    holder = spec.init(ValueSpec(tuple(values.shape[1:]), values.dtype))
    mapped = spec.premap(values)
    for i in range(values.shape[0]):
        holder = spec.combine(holder, pytree.tree_map(lambda c: c[i], mapped),
                              torch.tensor(i, dtype=torch.int32))
    return holder


def finalize_fold(spec: CombinerSpec, values: torch.Tensor, key) -> PyTree:
    return spec.finalize(key, fold_values(spec, values),
                         torch.tensor(values.shape[0], dtype=torch.int32))


def _close(a, b, rtol, atol) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    if len(la) != len(lb):
        return False
    return all(
        np.allclose(np.asarray(torch.as_tensor(x).double()),
                    np.asarray(torch.as_tensor(y).double()),
                    rtol=rtol, atol=atol)
        for x, y in zip(la, lb))


def validate_combiner(spec: CombinerSpec, reduce_fn: Callable,
                      value_spec: ValueSpec, *, key_sample: Any = 0,
                      trials: int = 4, n_values: int = 9, rtol: float = 1e-4,
                      atol: float = 1e-4, seed: int = 0) -> bool:
    """Numeric probes that the combiner reproduces the user reduce, on
    random values made with numpy: fold equivalence, split-merge, and
    permutation invariance of the reduce (skipped for the first-element
    idiom, whose contract is "any representative value").  The reduce runs
    under ``numerics``' half-precision rule, as the combiner does."""
    rng = np.random.default_rng(seed)
    n = torch.tensor(n_values, dtype=torch.int32)

    def reduce(vals):
        with numerics.HalfAccumulation():
            return reduce_fn(key_sample, vals, n)

    with torch.no_grad():
        for _ in range(trials):
            vals = rand_values(rng, value_spec, n_values)
            want = reduce(vals)
            if not _close(finalize_fold(spec, vals, key_sample), want,
                          rtol, atol):
                return False
            if spec.strategy != STRATEGY_FIRST:
                perm = torch.from_numpy(rng.permutation(n_values))
                if not _close(want, reduce(vals[perm]), rtol, atol):
                    return False
            if spec.merge is not None:
                k = n_values // 2
                hm = spec.merge(fold_values(spec, vals[:k]),
                                fold_values(spec, vals[k:]),
                                torch.tensor(k, dtype=torch.int32),
                                torch.tensor(n_values - k, dtype=torch.int32))
                if not _close(spec.finalize(key_sample, hm, n), want,
                              rtol, atol):
                    return False
    return True

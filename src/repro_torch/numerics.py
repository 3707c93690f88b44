"""JAX's float rules for max and min, written in PyTorch.

``jnp.maximum``/``jnp.max`` propagate NaN and return ``+0`` for a pair of
signed zeros in either order; ``jnp.minimum``/``jnp.min`` return ``-0``.
``torch.maximum``, ``torch.amax`` and ``scatter_reduce_`` return whichever
zero comes first, so the port applies the rule itself wherever a max or min
monoid folds values.  Integer and bool tensors have no signed zero or NaN
and take the plain operators.

A NaN keeps its bits (sign and payload), as in the JAX package on the CPU.
Between two NaNs, ``maximum(a, b)`` keeps ``a`` when ``a`` is negative and
``b`` otherwise; ``minimum(a, b)`` keeps ``a`` when ``a`` is positive and
``b`` otherwise.  A fold applies that rule in index order, so a max keeps
the first negative NaN it meets, else the last NaN, and a min the first
positive NaN, else the last: every reduction of the JAX package (``.at[]``
scatters, ``jnp.max``, the Pallas kernels in interpret mode) gives that
NaN, whatever its tiling.  The rule is associative, so a fold may split the
pairs into ranges as long as it joins them in order.

Sums and products over bf16 or f16 accumulate in f32 and round once at the
end, as the JAX package's jaxpr does (convert, ``reduce_sum`` or
``reduce_prod``, convert back).  Torch's CPU kernel for a half-precision
product rounds every step, so the port applies the rule itself:
:func:`call` wherever the optimizer evaluates a traced op, and
:class:`HalfAccumulation` around a user reducer run as the validation
probes' oracle.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

#: dtypes whose sums and products accumulate in f32
HALF_DTYPES = (torch.bfloat16, torch.float16)
#: the sum and product overloads the rule applies to
ACCUMULATING_OPS = frozenset((aten.sum.default, aten.sum.dim_IntList,
                              aten.prod.default, aten.prod.dim_int))


def call(func, args, kwargs):
    """``func(*args, **kwargs)``, with a sum or product over a half-precision
    tensor (and no explicit ``dtype``) accumulated in f32 and cast back."""
    if (func in ACCUMULATING_OPS and kwargs.get("dtype") is None
            and isinstance(args[0], torch.Tensor)
            and args[0].dtype in HALF_DTYPES):
        return func(args[0].float(), *args[1:], **kwargs).to(args[0].dtype)
    return func(*args, **kwargs)


class HalfAccumulation(TorchDispatchMode):
    """Within it every aten op runs through :func:`call`."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return call(func, args, kwargs or {})


def _signed_zero(prefer_negative: bool, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(-0.0 if prefer_negative else 0.0, dtype=like.dtype,
                        device=like.device)


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum``: NaN propagates, ``+0`` beats ``-0`` in either order."""
    if a.dtype == torch.bool:
        return torch.logical_or(a, b)
    if not a.is_floating_point():
        return torch.maximum(a, b)
    # select, never compute: a NaN operand comes out with its own bits
    # (torch.maximum may return another NaN pattern)
    out = torch.where(a > b, a, b)  # b when either is NaN
    a_nan = torch.isnan(a) & (~torch.isnan(b) | torch.signbit(a))
    out = torch.where(a_nan, a, out)
    both_zero = (a == 0) & (b == 0)
    return torch.where(both_zero, torch.where(torch.signbit(a), b, a), out)


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum``: NaN propagates, ``-0`` beats ``+0`` in either order."""
    if a.dtype == torch.bool:
        return torch.logical_and(a, b)
    if not a.is_floating_point():
        return torch.minimum(a, b)
    out = torch.where(a < b, a, b)  # b when either is NaN
    a_nan = torch.isnan(a) & (~torch.isnan(b) | ~torch.signbit(a))
    out = torch.where(a_nan, a, out)
    both_zero = (a == 0) & (b == 0)
    return torch.where(both_zero, torch.where(torch.signbit(a), a, b), out)


def _nan_index(nan: torch.Tensor, sticky: torch.Tensor, pos: torch.Tensor,
               n: int, reduce) -> torch.Tensor:
    """Index of the NaN a fold in index order keeps (-1 where none): the
    first ``sticky`` one, else the last.  ``pos`` holds each element's
    index, below ``n``; ``reduce(values, how, fill)`` folds along the pair
    axis."""
    first = reduce(torch.where(sticky, pos, n), "amin", n)
    last = reduce(torch.where(nan, pos, -1), "amax", -1)
    return torch.where(first < n, first, last)


def _fix_extremum(r: torch.Tensor, pick: torch.Tensor, picked: torch.Tensor,
                  has_preferred_zero: torch.Tensor,
                  prefer_negative: bool) -> torch.Tensor:
    """Apply the rule to a reduced tensor: a zero result takes the preferred
    sign when any reduced element had it, and where ``pick >= 0`` the NaN
    of that index (``picked``) wins over everything."""
    zero = torch.where(has_preferred_zero,
                       _signed_zero(prefer_negative, r),
                       _signed_zero(not prefer_negative, r))
    r = torch.where(r == 0, zero, r)
    return torch.where(pick >= 0, picked, r)


def _preferred_zero(x: torch.Tensor, prefer_negative: bool) -> torch.Tensor:
    return (x == 0) & (torch.signbit(x) == prefer_negative)


def _extremum(x: torch.Tensor, dim, is_max: bool) -> torch.Tensor:
    r = torch.amax(x, dim=dim) if is_max else torch.amin(x, dim=dim)
    if not x.is_floating_point():
        return r
    dims = sorted(d % x.ndim for d in ((dim,) if isinstance(dim, int)
                                       else dim)) or list(range(x.ndim))
    rest = x.ndim - len(dims)
    # the reduced axes last, in order, flattened: the fold's index order
    flat = x.movedim(dims, list(range(rest, x.ndim))).reshape(
        r.shape + (-1,))
    nan = torch.isnan(flat)
    pos = torch.arange(flat.shape[-1], device=x.device)
    pick = _nan_index(nan, nan & (torch.signbit(flat) == is_max), pos,
                      flat.shape[-1], lambda v, how, fill: getattr(v, how)(-1))
    picked = torch.gather(flat, -1, pick.clamp(min=0)[..., None])[..., 0]
    return _fix_extremum(r, pick, picked,
                         _preferred_zero(flat, not is_max).any(-1),
                         not is_max)


def amax(x: torch.Tensor, dim) -> torch.Tensor:
    """``jnp.max(x, axis=dim)``."""
    if x.dtype == torch.bool:
        return _any(x, dim)
    return _extremum(x, dim, True)


def amin(x: torch.Tensor, dim) -> torch.Tensor:
    """``jnp.min(x, axis=dim)``."""
    if x.dtype == torch.bool:
        return _all(x, dim)
    return _extremum(x, dim, False)


def _any(x: torch.Tensor, dim) -> torch.Tensor:
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    return x.to(torch.int32).amax(dim=dims) > 0 if dims else x


def _all(x: torch.Tensor, dim) -> torch.Tensor:
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    return x.to(torch.int32).amin(dim=dims) > 0 if dims else x


def scatter_extremum(table: torch.Tensor, keys: torch.Tensor,
                     values: torch.Tensor, op: str) -> torch.Tensor:
    """``table.at[keys].max(values, mode="drop")`` (``op="max"``) or
    ``.min`` as JAX computes it: keys outside ``[0, K)`` are dropped, and
    the pairs fold in index order (which decides only between NaNs)."""
    k_space = table.shape[0]
    valid = (keys >= 0) & (keys < k_space)
    k = keys[valid].long()
    v = values[valid].to(table.dtype)
    idx = k.view((-1,) + (1,) * (v.ndim - 1)).expand_as(v)
    if table.dtype == torch.bool:
        red = "amax" if op == "max" else "amin"
        chunk = table.to(torch.uint8).scatter_reduce(
            0, idx, v.to(torch.uint8), red, include_self=True).to(torch.bool)
        return chunk
    ident = (float("-inf") if op == "max" else float("inf")
             ) if table.is_floating_point() else (
        torch.iinfo(table.dtype).min if op == "max"
        else torch.iinfo(table.dtype).max)
    chunk = torch.full_like(table, ident).scatter_reduce(
        0, idx, v, "amax" if op == "max" else "amin", include_self=True)
    if table.is_floating_point() and v.shape[0]:
        def hits(mask):
            return torch.zeros(table.shape, dtype=torch.int32,
                               device=table.device).index_add_(
                0, k, mask.to(torch.int32)) > 0

        def by_key(vals, how, fill):
            return torch.full(table.shape, fill, dtype=torch.int64,
                              device=table.device).scatter_reduce(
                0, idx, vals, how, include_self=True)

        nan = torch.isnan(v)
        pos = torch.arange(v.shape[0], device=v.device).view(
            (-1,) + (1,) * (v.ndim - 1)).expand_as(v)
        pick = _nan_index(nan, nan & (torch.signbit(v) == (op == "max")),
                          pos, v.shape[0], by_key)
        picked = torch.gather(v, 0, pick.clamp(min=0))
        chunk = _fix_extremum(chunk, pick, picked,
                              hits(_preferred_zero(v, op == "min")),
                              op == "min")
    return (maximum if op == "max" else minimum)(table, chunk)

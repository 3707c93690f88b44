"""JAX's float rules for max and min, written in PyTorch.

``jnp.maximum``/``jnp.max`` propagate NaN and return ``+0`` for a pair of
signed zeros in either order; ``jnp.minimum``/``jnp.min`` return ``-0``.
``torch.maximum``, ``torch.amax`` and ``scatter_reduce_`` return whichever
zero comes first, so the port applies the rule itself wherever a max or min
monoid folds values.  Integer and bool tensors have no signed zero or NaN
and take the plain operators.
"""

from __future__ import annotations

import torch

_NAN = float("nan")


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
    out = torch.where(a > b, a, b)
    out = torch.where(torch.isnan(a), a, out)
    both_zero = (a == 0) & (b == 0)
    return torch.where(both_zero, torch.where(torch.signbit(a), b, a), out)


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum``: NaN propagates, ``-0`` beats ``+0`` in either order."""
    if a.dtype == torch.bool:
        return torch.logical_and(a, b)
    if not a.is_floating_point():
        return torch.minimum(a, b)
    out = torch.where(a < b, a, b)
    out = torch.where(torch.isnan(a), a, out)
    both_zero = (a == 0) & (b == 0)
    return torch.where(both_zero, torch.where(torch.signbit(a), a, b), out)


def _fix_extremum(r: torch.Tensor, has_nan: torch.Tensor,
                  has_preferred_zero: torch.Tensor,
                  prefer_negative: bool) -> torch.Tensor:
    """Apply the rule to a reduced tensor: a zero result takes the preferred
    sign when any reduced element had it, and NaN wins over everything."""
    zero = torch.where(has_preferred_zero,
                       _signed_zero(prefer_negative, r),
                       _signed_zero(not prefer_negative, r))
    r = torch.where(r == 0, zero, r)
    return torch.where(has_nan, torch.tensor(_NAN, dtype=r.dtype,
                                             device=r.device), r)


def _preferred_zero(x: torch.Tensor, prefer_negative: bool) -> torch.Tensor:
    return (x == 0) & (torch.signbit(x) == prefer_negative)


def amax(x: torch.Tensor, dim) -> torch.Tensor:
    """``jnp.max(x, axis=dim)``."""
    if x.dtype == torch.bool:
        return _any(x, dim)
    r = torch.amax(x, dim=dim)
    if not x.is_floating_point():
        return r
    return _fix_extremum(r, _any(torch.isnan(x), dim),
                         _any(_preferred_zero(x, False), dim), False)


def amin(x: torch.Tensor, dim) -> torch.Tensor:
    """``jnp.min(x, axis=dim)``."""
    if x.dtype == torch.bool:
        return _all(x, dim)
    r = torch.amin(x, dim=dim)
    if not x.is_floating_point():
        return r
    return _fix_extremum(r, _any(torch.isnan(x), dim),
                         _any(_preferred_zero(x, True), dim), True)


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
    the result is exact and independent of the order of the pairs."""
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
    if table.is_floating_point():
        def hits(mask):
            return torch.zeros(table.shape, dtype=torch.int32,
                               device=table.device).index_add_(
                0, k, mask.to(torch.int32)) > 0
        chunk = _fix_extremum(chunk, hits(torch.isnan(v)),
                              hits(_preferred_zero(v, op == "min")),
                              op == "min")
    return (maximum if op == "max" else minimum)(table, chunk)

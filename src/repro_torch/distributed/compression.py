"""int8 quantization: the ``packed`` wire codec's value path, a compressed
sum over a mesh, and error feedback.

Counterpart of ``repro/distributed/compression.py``.  :func:`quant_int8`
is the reference's rule to the bit: the scale is the largest magnitude
over 127 (at least 1e-12 / 127), computed in f32; ``x / s`` is divided
in f32 and rounded half to even, then clipped to [-127, 127].

:func:`compressed_psum` moves int8 and one f32 scale a shard through the
mesh's all-gather and sums the dequantized tensors in shard order.
:class:`ErrorFeedback` carries the quantization residual into the next
step.
"""

from __future__ import annotations

import torch


def _scale_of(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x.abs().amax(), min=1e-12) / 127.0


def quant_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, s f32 scalar)`` with ``q * s`` within ``s / 2`` of ``x``."""
    x = x.to(torch.float32)
    s = _scale_of(x)
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s.to(torch.float32)


def quant_int8_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`quant_int8` of each row along the leading axis (the
    reference's ``jax.vmap(quant_int8)``): ``(q [R, ...], s [R])``."""
    x = x.to(torch.float32)
    flat = x.reshape(x.shape[0], -1)
    s = torch.clamp(flat.abs().amax(dim=1), min=1e-12) / 127.0
    sb = s.reshape((-1,) + (1,) * (x.ndim - 1))
    q = torch.clamp(torch.round(x / sb), -127, 127).to(torch.int8)
    return q, s


def dequant_int8(q: torch.Tensor, s: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    return q.to(dtype) * s


def fake_quant_int8(x: torch.Tensor) -> torch.Tensor:
    q, s = quant_int8(x.to(torch.float32))
    return dequant_int8(q, s, torch.float32)


def compressed_psum(xs, mesh):
    """int8 on the wire: each shard's tensor quantized, the int8 tensors
    and the scales all-gathered, the dequantized ``[S, ...]`` summed in
    shard order.  ``xs`` holds one tensor per shard of ``mesh.shards()``;
    so does the result."""
    qs, ss = zip(*(quant_int8(x) for x in xs))
    gq = mesh.all_gather(list(qs))
    gs = mesh.all_gather([s.reshape(1) for s in ss])
    out = []
    for q, s in zip(gq, gs):
        deq = q.to(torch.float32) * s.reshape((-1,) + (1,) * (q.ndim - 1))
        total = deq[0]
        for row in deq[1:]:
            total = total + row
        out.append(total)
    return out


class ErrorFeedback:
    """``e_t = g_t + e_{t-1} - Q(g_t + e_{t-1})``, carried as extra state
    over a dict (or list) of tensors."""

    @staticmethod
    def init(grads):
        from torch.utils import _pytree as pytree

        return pytree.tree_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), grads)

    @staticmethod
    def apply(grads, residual):
        """``(compressed grads to transmit, new residual)``."""
        from torch.utils import _pytree as pytree

        def one(g, e):
            x = g.to(torch.float32) + e
            c = fake_quant_int8(x)
            return c, x - c

        pairs = pytree.tree_map(one, grads, residual)
        is_pair = lambda t: isinstance(t, tuple)  # noqa: E731
        comp = pytree.tree_map(lambda t: t[0], pairs, is_leaf=is_pair)
        res = pytree.tree_map(lambda t: t[1], pairs, is_leaf=is_pair)
        return comp, res

"""Shared layers: norms, rotary embeddings, MLPs, embedding/unembedding.

Counterpart of ``repro/models/layers.py``.  Parameters are dicts of
tensors under the reference's names.  ``init_*`` draw from an explicit
``torch.Generator`` and place the tensors on its device; the draws are
not JAX's, so tests carry the reference's parameters across with
:func:`repro_torch.interop.params_from_repro`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.utils import _pytree as pytree


def normal(rng: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in f32 on ``rng``'s device, cast to
    ``dtype``."""
    return (torch.randn(shape, generator=rng, device=rng.device) * scale
            ).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, device=None):
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(p, x, eps: float):
    """``x / rms(x) * (1 + scale)`` in f32, cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + p["scale"])
    return y.to(x.dtype)


def init_layernorm(d: int, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(p, x, eps: float):
    """``(x - mean) / std * scale + bias`` in f32, cast back to x's dtype;
    the population variance, as ``jnp.var``."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-rotation convention)
# ---------------------------------------------------------------------------


def rope_table(positions: torch.Tensor, hd: int, theta: float):
    """positions [S] -> (cos, sin) [S, hd/2] in f32."""
    exps = torch.arange(0, hd, 2, dtype=torch.float32,
                        device=positions.device) / hd
    freqs = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [..., S, H, hd]; cos/sin [S, hd/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    shape = (1,) * (x.ndim - 3) + (cos.shape[0], 1, half)
    c = cos.reshape(shape).to(x.dtype)
    s = sin.reshape(shape).to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

#: JAX's ``nn.gelu`` defaults to the tanh approximation
_ACT = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu}


def init_swiglu(rng: torch.Generator, d: int, f: int, dtype):
    return {
        "w_gate": normal(rng, (d, f), d ** -0.5, dtype),
        "w_up": normal(rng, (d, f), d ** -0.5, dtype),
        "w_down": normal(rng, (f, d), f ** -0.5, dtype),
    }


def swiglu(p, x, act: str = "silu"):
    g = _ACT[act](x @ p["w_gate"])
    return (g * (x @ p["w_up"])) @ p["w_down"]


def init_mlp(rng: torch.Generator, d: int, f: int, dtype):
    dev = rng.device
    return {
        "w1": normal(rng, (d, f), d ** -0.5, dtype),
        "b1": torch.zeros((f,), dtype=dtype, device=dev),
        "w2": normal(rng, (f, d), f ** -0.5, dtype),
        "b2": torch.zeros((d,), dtype=dtype, device=dev),
    }


def mlp(p, x, act: str = "gelu"):
    h = _ACT[act](x @ p["w1"] + p["b1"])
    return h @ p["w2"] + p["b2"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embed(rng: torch.Generator, vocab: int, d: int, dtype):
    return {"table": normal(rng, (vocab, d), d ** -0.5, dtype)}


def embed(p, tokens):
    return p["table"][tokens]


def unembed(p_embed, p_head, x, *, tie: bool):
    w = p_embed["table"] if tie else p_head["w"]
    return x @ w.T


def init_unembed(rng: torch.Generator, vocab: int, d: int, dtype, *,
                 tie: bool):
    if tie:
        return {}
    return {"w": normal(rng, (vocab, d), d ** -0.5, dtype)}


# ---------------------------------------------------------------------------
# Stacked layers
# ---------------------------------------------------------------------------


def stack_init(make, n: int):
    """``n`` draws of ``make()`` (a tree of tensors) stacked ``[n, ...]``
    leaf by leaf, each draw written into its slice, so that only one
    draw is live at once.  Nested, it gives the reference's ``[G, k,
    ...]`` groups."""
    first = make()
    stacked = pytree.tree_map(
        lambda t: torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                              device=t.device), first)
    for dst, src in zip(pytree.tree_leaves(stacked),
                        pytree.tree_leaves(first)):
        dst[0] = src
    del first
    for i in range(1, n):
        for dst, src in zip(pytree.tree_leaves(stacked),
                            pytree.tree_leaves(make())):
            dst[i] = src
    return stacked


def tree_index(tree, i: int):
    """Slice ``i`` of every stacked leaf: views, in the tree's layout (a
    tree of dicts; a plain walk, since it runs for every layer of every
    decode step)."""
    return {k: tree_index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def checkpointed(block, remat: bool):
    """``block`` run under ``torch.utils.checkpoint`` (non-reentrant) when
    ``remat`` is set and gradients are recorded, else ``block`` itself:
    the reference's per-layer ``jax.checkpoint``."""
    if not (remat and torch.is_grad_enabled()):
        return block
    return lambda *a: torch.utils.checkpoint.checkpoint(
        block, *a, use_reentrant=False)

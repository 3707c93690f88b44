"""Zamba2-style hybrid: a Mamba2 backbone and one SHARED attention block.

Counterpart of ``repro/models/hybrid.py``: ``G`` groups of
``hybrid_attn_every`` Mamba2 layers, each group followed by one
application of a single shared transformer block (shared weights, a KV
cache of its own for each call site); leftover Mamba2 layers close the
stack.  Parameters are the reference's pytree: ``groups`` stacked ``[G, k,
...]``, ``shared``, and ``tail`` ``[leftover, ...]`` where there are
leftover layers.

Serving differs on purpose in one place (ROADMAP C.66, C.21 extended):
the reference's ``decode_step`` attends with ``deferred_write=True`` and
writes every call site's K/V after its scan.  Here each call site writes
its K/V into its cache in place at ``pos`` and then attends with valid
length ``pos + 1``: the same function, and the one the ``flash_decode``
kernel computes, so under ``use_kernels`` the shared attention runs on
it.  The decode state is updated in place, so a state passed to
:func:`decode_step` or :func:`prefill` must not be used again; ``pos`` is
a Python int.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mamba
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import (apply_rope, checkpointed, embed,
                                       init_embed, init_rmsnorm,
                                       init_swiglu, init_unembed, rmsnorm,
                                       rope_table, stack_init, swiglu,
                                       tree_index)
# the output projection is the transformer's (the registry's facade
# reaches it through here)
from repro_torch.models.transformer import (  # noqa: F401
    logits_of_hidden, unembed_matrix)


def _layout(cfg: ModelConfig):
    k = cfg.hybrid_attn_every
    groups = cfg.num_layers // k
    leftover = cfg.num_layers - groups * k
    return groups, k, leftover


def init_params(cfg: ModelConfig, rng: torch.Generator):
    """Random parameters drawn from ``rng``, on its device."""
    groups, k, leftover = _layout(cfg)
    dev = rng.device
    mamba_layer = functools.partial(mamba.init_layer, rng, cfg)
    p = {
        "embed": init_embed(rng, cfg.vocab_size, cfg.d_model, cfg.dtype),
        "groups": stack_init(lambda: stack_init(mamba_layer, k), groups),
        "shared": {
            "ln_attn": init_rmsnorm(cfg.d_model, dev),
            "attn": attn.init_attn(rng, cfg),
            "ln_ffn": init_rmsnorm(cfg.d_model, dev),
            "ffn": init_swiglu(rng, cfg.d_model, cfg.d_ff, cfg.dtype),
        },
        "ln_f": init_rmsnorm(cfg.d_model, dev),
        "head": init_unembed(rng, cfg.vocab_size, cfg.d_model, cfg.dtype,
                             tie=cfg.tie_embeddings),
    }
    if leftover:
        p["tail"] = stack_init(mamba_layer, leftover)
    return p


def _shared_ffn(cfg, sh, x):
    h = rmsnorm(sh["ln_ffn"], x, cfg.norm_eps)
    return x + swiglu(sh["ffn"], h, cfg.act)


def _shared_block_train(cfg, p, x):
    h = rmsnorm(p["ln_attn"], x, cfg.norm_eps)
    return _shared_ffn(cfg, p, x + attn.attn_train(cfg, p["attn"], h))


def forward(cfg: ModelConfig, params, batch, *, remat: bool = True, **_):
    """The training forward: (hidden [B, S, E], aux).  ``remat``, as the
    reference, checkpoints each grouped Mamba2 layer and each application
    of the shared block (not the tail) when gradients are recorded."""
    groups, k, _ = _layout(cfg)
    x = embed(params["embed"], batch["tokens"])
    layer = checkpointed(mamba.block, remat)
    shared = checkpointed(_shared_block_train, remat)
    for g in range(groups):
        gp = tree_index(params["groups"], g)
        for j in range(k):
            x = layer(cfg, tree_index(gp, j), x)
        x = shared(cfg, params["shared"], x)
    if "tail" in params:
        for j in range(params["tail"]["ln"]["scale"].shape[0]):
            x = mamba.block(cfg, tree_index(params["tail"], j), x)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return x, {"load_balance_loss": 0.0}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      kv_dtype=None, device=None):
    groups, k, leftover = _layout(cfg)
    state = {
        "ssm_groups": ssm_mod.init_ssm_state(cfg, batch, groups * k, device),
        # one cache per call site of the shared block
        "cache": attn.init_kv_cache(cfg, batch, max_len, kv_dtype=kv_dtype,
                                    layers=groups, device=device),
        "pos": 0,
    }
    if leftover:
        state["ssm_tail"] = ssm_mod.init_ssm_state(cfg, batch, leftover,
                                                   device)
    return state


def decode_step(cfg: ModelConfig, params, state, tokens, *,
                use_kernels: bool | None = None):
    """tokens [B] -> (logits [B, V], state), the state updated in place.
    Each call site of the shared block writes the token's K/V into its
    cache at ``pos`` and attends over positions ``<= pos``; under
    ``use_kernels`` (``None``: on when the tokens lie on a CUDA device)
    that attention is the ``flash_decode`` kernel."""
    if use_kernels is None:
        use_kernels = tokens.device.type == "cuda"
    groups, k, leftover = _layout(cfg)
    pos = int(state["pos"])
    cache = state["cache"]
    sh = params["shared"]
    x = embed(params["embed"], tokens[:, None])
    for g in range(groups):
        gp = tree_index(params["groups"], g)
        for j in range(k):
            x = mamba.decode_layer(cfg, tree_index(gp, j), x,
                              state["ssm_groups"], g * k + j)
        h = rmsnorm(sh["ln_attn"], x, cfg.norm_eps)
        site = {name: t[g] for name, t in cache.items()}
        a, _ = attn.attn_decode(cfg, sh["attn"], h, site, pos,
                                use_kernels=use_kernels)
        x = _shared_ffn(cfg, sh, x + a)
    for j in range(leftover):
        x = mamba.decode_layer(cfg, tree_index(params["tail"], j), x,
                          state["ssm_tail"], j)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = logits_of_hidden(cfg, params, x[:, 0])
    return logits, {**state, "pos": pos + 1}


def prefill(cfg: ModelConfig, params, batch, state, **_):
    """Chunked-SSD prefill of the Mamba2 layers (their decode states
    written into ``state`` in place) and the shared block's full-sequence
    attention, whose rotated K and V fill each call site's cache at
    positions ``[0, S)``.  Returns (last-position logits, state)."""
    groups, k, leftover = _layout(cfg)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    cache = state["cache"]
    sh = params["shared"]
    x = embed(params["embed"], tokens)
    cos, sin = rope_table(torch.arange(S, device=x.device), cfg.hd,
                          cfg.rope_theta)

    for g in range(groups):
        gp = tree_index(params["groups"], g)
        for j in range(k):
            x = mamba.prefill_layer(cfg, tree_index(gp, j), x,
                                    state["ssm_groups"], g * k + j)
        h = rmsnorm(sh["ln_attn"], x, cfg.norm_eps)
        kk, vv = attn._project_kv(cfg, sh["attn"], h)
        attn.cache_fill(cache, g, apply_rope(kk, cos, sin), vv)
        x = _shared_ffn(cfg, sh, x + attn.attn_train(cfg, sh["attn"], h))
    for j in range(leftover):
        x = mamba.prefill_layer(cfg, tree_index(params["tail"], j), x,
                                state["ssm_tail"], j)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = logits_of_hidden(cfg, params, x[:, -1])
    return logits, {**state, "pos": S}

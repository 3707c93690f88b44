"""Decoder-only transformer LM covering the dense, moe and vlm families.

Counterpart of ``repro/models/transformer.py``: GQA with optional QKV
bias (qwen), softcaps, local/global windows and post-norms (gemma2), the
MoE FFN (llama4-scout 16e top-1, qwen3 128e top-8) with the combiner or
materialize combine-back (``models/moe.py``), and the VLM stub
(internvl2): precomputed patch embeddings are concatenated in front of
the text embeddings.  The registry routes the other families (ssm,
hybrid, audio) to their own modules.

Parameters are the reference's pytree, key for key, as dicts of tensors:
``{"embed": {"table"}, "layers": {...}, "ln_f": {"scale"}, "head": {"w"}}``,
with every layer leaf stacked ``[L, ...]``.  The reference scans the
stacked layers with ``lax.scan``; here the layers are a Python loop over
views ``leaf[i]``.

Serving differs on purpose in one place (ROADMAP C.21): the reference's
``decode_step`` attends with ``deferred_write=True`` and writes all layers'
new K/V as one token column after the scan, so that ``lax.scan`` does not
double-buffer the cache through its xs/ys.  A Python loop has no such
cost, so :func:`decode_step` writes each layer's new K/V into the cache in
place at ``pos`` and then attends with valid length ``pos + 1``: the same
function, and the one the ``flash_decode`` kernel computes.  The decode
state's cache is updated in place, so a state passed to
:func:`decode_step` or :func:`prefill` must not be used again; ``pos`` is a
Python int.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import (apply_rope, checkpointed, embed,
                                       init_embed, init_rmsnorm,
                                       init_swiglu, init_unembed, rmsnorm,
                                       rope_table, stack_init, swiglu,
                                       tree_index)


def _layer_windows(cfg: ModelConfig):
    """Per-layer sliding window sizes (0 = global). gemma2 alternates."""
    if cfg.sliding_window and cfg.local_global_alternate:
        return [cfg.sliding_window if i % 2 == 0 else 0
                for i in range(cfg.num_layers)]
    if cfg.sliding_window:
        return [cfg.sliding_window] * cfg.num_layers
    return [0] * cfg.num_layers


def init_layer(rng: torch.Generator, cfg: ModelConfig):
    dev = rng.device
    p = {
        "ln_attn": init_rmsnorm(cfg.d_model, dev),
        "attn": attn.init_attn(rng, cfg),
        "ln_ffn": init_rmsnorm(cfg.d_model, dev),
    }
    if cfg.num_experts:
        p["moe"] = moe_mod.init_moe(rng, cfg)
    else:
        p["ffn"] = init_swiglu(rng, cfg.d_model, cfg.d_ff, cfg.dtype)
    if cfg.post_norms:
        p["ln_post_attn"] = init_rmsnorm(cfg.d_model, dev)
        p["ln_post_ffn"] = init_rmsnorm(cfg.d_model, dev)
    return p


def init_params(cfg: ModelConfig, rng: torch.Generator):
    """Random parameters drawn from ``rng``, on its device."""
    return {
        "embed": init_embed(rng, cfg.vocab_size, cfg.d_model, cfg.dtype),
        "layers": stack_init(lambda: init_layer(rng, cfg),
                             cfg.num_layers),  # stacked [L, ...]
        "ln_f": init_rmsnorm(cfg.d_model, rng.device),
        "head": init_unembed(rng, cfg.vocab_size, cfg.d_model, cfg.dtype,
                             tie=cfg.tie_embeddings),
    }


def layer_params(params, i: int):
    """Layer ``i``'s parameters: views into the stacked leaves."""
    return tree_index(params["layers"], i)


def _embed_in(cfg: ModelConfig, params, tokens, patches=None):
    """The embedded tokens, behind ``patches`` (vlm: the stub frontend's
    output) where given."""
    x = embed(params["embed"], tokens)
    if patches is not None:
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _patches(cfg: ModelConfig, batch):
    return batch["patches"] if cfg.family == "vlm" else None


def _ffn(cfg: ModelConfig, p, x, moe_mode: str | None):
    """The block's second half: ``(x + ffn(norm(x)), load-balance loss)``
    (post-norm aside).  An MoE layer runs ``moe_ffn`` in ``moe_mode``, or
    ``moe_ffn_decode`` where ``moe_mode`` is ``None``; a dense layer's loss
    is 0.0."""
    h = rmsnorm(p["ln_ffn"], x, cfg.norm_eps)
    lb = 0.0
    if not cfg.num_experts:
        f = swiglu(p["ffn"], h, cfg.act)
    elif moe_mode is None:
        f = moe_mod.moe_ffn_decode(cfg, p["moe"], h)
    else:
        f, aux = moe_mod.moe_ffn(cfg, p["moe"], h, mode=moe_mode)
        lb = aux["load_balance_loss"]
    if cfg.post_norms:
        f = rmsnorm(p["ln_post_ffn"], f, cfg.norm_eps)
    return x + f, lb


def _block_train(cfg: ModelConfig, p, x, window: int, moe_mode: str):
    h = rmsnorm(p["ln_attn"], x, cfg.norm_eps)
    a = attn.attn_train(cfg, p["attn"], h, window=window)
    if cfg.post_norms:
        a = rmsnorm(p["ln_post_attn"], a, cfg.norm_eps)
    return _ffn(cfg, p, x + a, moe_mode)


def forward(cfg: ModelConfig, params, batch, *, moe_mode: str = "combiner",
            remat: bool = True):
    """The training forward. batch: {"tokens": [B,S]} (+ "patches":
    [B,Pn,E] for vlm).

    Returns (hidden [B,S,E], aux dict), as the reference (for vlm, S
    counts the patches too); aux's load-balance loss is the mean over the
    layers for MoE, 0.0 for the others.  ``remat`` runs each layer under
    ``torch.utils.checkpoint`` (non-reentrant) when gradients are
    recorded, so that only the layers' inputs are kept for the backward,
    as the reference's per-layer ``jax.checkpoint``.  ``moe_mode`` selects
    the MoE combine-back (``combiner`` or ``materialize``); the other
    families ignore it, as the reference does."""
    x = _embed_in(cfg, params, batch["tokens"], _patches(cfg, batch))
    block = checkpointed(_block_train, remat)
    lbs = []
    for i, window in enumerate(_layer_windows(cfg)):
        x, lb = block(cfg, layer_params(params, i), x, window, moe_mode)
        lbs.append(lb)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    lb = torch.stack(lbs).mean() if cfg.num_experts else 0.0
    return x, {"load_balance_loss": lb}


def unembed_matrix(cfg: ModelConfig, params):
    """[V, E] output projection (tied or untied)."""
    return (params["embed"]["table"] if cfg.tie_embeddings
            else params["head"]["w"])


def logits_of_hidden(cfg: ModelConfig, params, hidden):
    w = unembed_matrix(cfg, params)
    logits = (hidden @ w.T).to(torch.float32)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      kv_dtype=None, device=None):
    return {
        "cache": attn.init_kv_cache(cfg, batch, max_len, kv_dtype=kv_dtype,
                                    device=device),
        "pos": 0,
    }


def decode_step(cfg: ModelConfig, params, state, tokens, *,
                use_kernels: bool | None = None):
    """tokens [B] -> (logits [B,V], new state). One generated token.

    Each layer writes the token's K/V into the cache at ``pos`` (in place)
    and attends over positions ``<= pos``; under ``use_kernels`` (``None``:
    on when the tokens lie on a CUDA device) that attention is the
    ``flash_decode`` kernel."""
    if use_kernels is None:
        use_kernels = tokens.device.type == "cuda"
    pos = int(state["pos"])
    cache = state["cache"]
    x = _embed_in(cfg, params, tokens[:, None])
    for i, window in enumerate(_layer_windows(cfg)):
        p = layer_params(params, i)
        layer_cache = {name: t[i] for name, t in cache.items()}
        h = rmsnorm(p["ln_attn"], x, cfg.norm_eps)
        a, _ = attn.attn_decode(cfg, p["attn"], h, layer_cache, pos,
                                window=window, use_kernels=use_kernels)
        if cfg.post_norms:
            a = rmsnorm(p["ln_post_attn"], a, cfg.norm_eps)
        x, _ = _ffn(cfg, p, x + a, None)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = logits_of_hidden(cfg, params, x[:, 0])
    return logits, {"cache": cache, "pos": pos + 1}


def prefill(cfg: ModelConfig, params, batch, state, *,
            moe_mode: str = "combiner"):
    """Teacher-forced prefill: run the train forward AND fill the KV cache.

    Returns (last-position logits [B,V], state).  Each layer's prompt K/V
    (rotated K) are written into the state's cache at positions ``[0, S)``,
    in place; for vlm S counts the patches in front of the tokens.  MoE
    layers combine back in ``moe_mode``."""
    x = _embed_in(cfg, params, batch["tokens"], _patches(cfg, batch))
    S = x.shape[1]
    cache = state["cache"]
    cos, sin = rope_table(torch.arange(S, device=x.device), cfg.hd,
                          cfg.rope_theta)
    for i, window in enumerate(_layer_windows(cfg)):
        p = layer_params(params, i)
        h = rmsnorm(p["ln_attn"], x, cfg.norm_eps)
        k, v = attn._project_kv(cfg, p["attn"], h)
        attn.cache_fill(cache, i, apply_rope(k, cos, sin), v)
        a = attn.attn_train(cfg, p["attn"], h, window=window)
        if cfg.post_norms:
            a = rmsnorm(p["ln_post_attn"], a, cfg.norm_eps)
        x, _ = _ffn(cfg, p, x + a, moe_mode)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = logits_of_hidden(cfg, params, x[:, -1])
    return logits, {"cache": cache, "pos": S}

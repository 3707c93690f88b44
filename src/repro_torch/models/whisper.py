"""Whisper-style encoder-decoder backbone, the ``audio`` family.

Counterpart of ``repro/models/whisper.py``.  The conv/mel frontend is a
stub: the batch's ``frames`` are precomputed frame embeddings [B, S_frames,
d_model].  Encoder: bidirectional attention with no rotary embedding and a
GELU MLP, pre-norm LayerNorm, sinusoidal positions.  Decoder: causal
self-attention, cross-attention over the encoder's output, learned
positions, at most ``dec_len`` target positions.  Parameters are the
reference's pytree (``enc_layers`` and ``dec_layers`` stacked ``[L,
...]``).

Serving differs on purpose in one place (ROADMAP C.66, C.21 extended):
the reference's decode attends its self-attention with
``deferred_write=True`` at ``pos_c = min(pos, dec_len - 1)`` and writes
every layer's K/V after its scan.  Here each layer writes its K/V into the
self cache in place at ``pos_c`` first and then attends with valid length
``pos_c + 1``: the same function, also past ``dec_len`` (where both
overwrite the last position), and the one the ``flash_decode`` kernel
computes.  The cross-attention over the prefill's per-layer cross K/V runs
on the kernel too (every encoder position valid).  The decode state is
updated in place; ``pos`` is a Python int.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import (checkpointed, embed, init_embed,
                                       init_layernorm, init_mlp,
                                       init_unembed, layernorm, mlp, normal,
                                       stack_init, tree_index)
# the output projection is the transformer's (the registry's facade
# reaches it through here)
from repro_torch.models.transformer import (  # noqa: F401
    logits_of_hidden, unembed_matrix)


def _sinusoid(S: int, d: int, device=None):
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_enc_layer(rng: torch.Generator, cfg: ModelConfig):
    dev = rng.device
    return {
        "ln_attn": init_layernorm(cfg.d_model, dev),
        "attn": attn.init_attn(rng, cfg),
        "ln_ffn": init_layernorm(cfg.d_model, dev),
        "ffn": init_mlp(rng, cfg.d_model, cfg.d_ff, cfg.dtype),
    }


def init_dec_layer(rng: torch.Generator, cfg: ModelConfig):
    dev = rng.device
    return {
        "ln_self": init_layernorm(cfg.d_model, dev),
        "self": attn.init_attn(rng, cfg),
        "ln_cross": init_layernorm(cfg.d_model, dev),
        "cross": attn.init_attn(rng, cfg, cross=True),
        "ln_ffn": init_layernorm(cfg.d_model, dev),
        "ffn": init_mlp(rng, cfg.d_model, cfg.d_ff, cfg.dtype),
    }


def init_params(cfg: ModelConfig, rng: torch.Generator):
    """Random parameters drawn from ``rng``, on its device."""
    dev = rng.device
    return {
        "embed": init_embed(rng, cfg.vocab_size, cfg.d_model, cfg.dtype),
        "pos_dec": normal(rng, (cfg.dec_len, cfg.d_model), 0.01, cfg.dtype),
        "enc_layers": stack_init(lambda: init_enc_layer(rng, cfg),
                                 cfg.enc_layers or cfg.num_layers),
        "ln_enc_f": init_layernorm(cfg.d_model, dev),
        "dec_layers": stack_init(lambda: init_dec_layer(rng, cfg),
                                 cfg.num_layers),
        "ln_dec_f": init_layernorm(cfg.d_model, dev),
        "head": init_unembed(rng, cfg.vocab_size, cfg.d_model, cfg.dtype,
                             tie=cfg.tie_embeddings),
    }


def _enc_block(cfg, p, x):
    h = layernorm(p["ln_attn"], x, cfg.norm_eps)
    x = x + attn.attn_train(cfg, p["attn"], h, causal=False, rope=False)
    h = layernorm(p["ln_ffn"], x, cfg.norm_eps)
    return x + mlp(p["ffn"], h, "gelu")


def encode(cfg: ModelConfig, params, frames, *, remat: bool = True):
    """frames [B, S, E] (the stub frontend's output) -> [B, S, E]."""
    x = frames.to(cfg.dtype) + _sinusoid(
        frames.shape[1], cfg.d_model, frames.device).to(cfg.dtype)
    block = checkpointed(_enc_block, remat)
    enc = params["enc_layers"]
    for i in range(enc["ln_attn"]["scale"].shape[0]):
        x = block(cfg, tree_index(enc, i), x)
    return layernorm(params["ln_enc_f"], x, cfg.norm_eps)


def _dec_block(cfg, p, x, enc_out):
    h = layernorm(p["ln_self"], x, cfg.norm_eps)
    x = x + attn.attn_train(cfg, p["self"], h, rope=False)
    h = layernorm(p["ln_cross"], x, cfg.norm_eps)
    x = x + attn.attn_train(cfg, p["cross"], h, kv_x=enc_out, rope=False)
    h = layernorm(p["ln_ffn"], x, cfg.norm_eps)
    return x + mlp(p["ffn"], h, "gelu")


def forward(cfg: ModelConfig, params, batch, *, remat: bool = True, **_):
    """batch: {"frames": [B, Sf, E], "tokens": [B, St]} -> (decoder hidden
    [B, St, E], aux)."""
    enc_out = encode(cfg, params, batch["frames"], remat=remat)
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens) + params["pos_dec"][:tokens.shape[1]]
    block = checkpointed(_dec_block, remat)
    for i in range(cfg.num_layers):
        x = block(cfg, tree_index(params["dec_layers"], i), x, enc_out)
    x = layernorm(params["ln_dec_f"], x, cfg.norm_eps)
    return x, {"load_balance_loss": 0.0}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      kv_dtype=None, device=None, cross_len: int = 0):
    """Self-KV capped at dec_len; cross-KV [L, B, cross_len, Kv, D] of
    zeros, empty by default: prefill puts the encoder's [L, B, Sf, Kv, D]
    in its place (the dry-run's decode cells hold Sf = max_len, the
    reference's layout)."""
    shape = (cfg.num_layers, batch, cross_len, cfg.num_kv_heads, cfg.hd)
    return {
        "cache": attn.init_kv_cache(cfg, batch, min(max_len, cfg.dec_len),
                                    kv_dtype=kv_dtype, device=device),
        "cross_k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "cross_v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "pos": 0,
    }


def prefill(cfg: ModelConfig, params, batch, state, *,
            use_kernels: bool | None = None, **_):
    """Encode the frames, compute each decoder layer's cross K/V, and
    decode the BOS token (the batch's first token, else 0) with
    :func:`decode_step`.  Returns (logits [B, V], state)."""
    enc_out = encode(cfg, params, batch["frames"], remat=False)
    B, Sf, _ = enc_out.shape
    L = cfg.num_layers
    shape = (L, B, Sf, cfg.num_kv_heads, cfg.hd)
    ck = torch.empty(shape, dtype=cfg.dtype, device=enc_out.device)
    cv = torch.empty_like(ck)
    for i in range(L):
        p = tree_index(params["dec_layers"], i)
        ck[i], cv[i] = attn._project_kv(cfg, p["cross"], enc_out)
    state = {**state, "cross_k": ck, "cross_v": cv}
    bos = (batch["tokens"][:, 0] if "tokens" in batch else
           torch.zeros((B,), dtype=torch.int32, device=enc_out.device))
    return decode_step(cfg, params, state, bos, use_kernels=use_kernels)


def decode_step(cfg: ModelConfig, params, state, tokens, *,
                use_kernels: bool | None = None):
    """tokens [B] -> (logits [B, V], state), the self cache updated in
    place.  Under ``use_kernels`` (``None``: on when the tokens lie on a
    CUDA device) the self- and cross-attention of every layer run on the
    ``flash_decode`` kernel."""
    if use_kernels is None:
        use_kernels = tokens.device.type == "cuda"
    pos = int(state["pos"])
    pos_c = min(pos, cfg.dec_len - 1)
    x = (embed(params["embed"], tokens[:, None])
         + params["pos_dec"][pos_c:pos_c + 1])
    cache = state["cache"]
    for i in range(cfg.num_layers):
        p = tree_index(params["dec_layers"], i)
        h = layernorm(p["ln_self"], x, cfg.norm_eps)
        a, _ = attn.attn_decode(cfg, p["self"], h,
                                {name: t[i] for name, t in cache.items()},
                                pos_c, rope=False, use_kernels=use_kernels)
        x = x + a
        h = layernorm(p["ln_cross"], x, cfg.norm_eps)
        c, _ = attn.attn_decode(
            cfg, p["cross"], h, None, pos, rope=False,
            cross_kv=(state["cross_k"][i], state["cross_v"][i]),
            use_kernels=use_kernels)
        x = x + c
        h = layernorm(p["ln_ffn"], x, cfg.norm_eps)
        x = x + mlp(p["ffn"], h, "gelu")
    x = layernorm(params["ln_dec_f"], x, cfg.norm_eps)
    logits = logits_of_hidden(cfg, params, x[:, 0])
    return logits, {**state, "pos": pos + 1}

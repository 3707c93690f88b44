"""Mamba2 LM: a pure SSM stack (attention-free), the ``ssm`` family.

Counterpart of ``repro/models/mamba.py``.  Parameters are the reference's
pytree, key for key: ``{"embed": {"table"}, "layers": {"ln", "ssm"},
"ln_f", "head"}`` with every layer leaf stacked ``[L, ...]``; the layers
run as a Python loop over views ``leaf[i]``.  The decode state (``{"ssm":
{"conv": [L, B, W-1, Ch], "ssm": [L, B, H, N, P]}, "pos"}``) is updated in
place, so a state passed to :func:`decode_step` or :func:`prefill` must not
be used again; ``pos`` is a Python int.  No attention runs here, so
``use_kernels`` has nothing to choose.
"""

from __future__ import annotations

import torch

from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import (checkpointed, embed, init_embed,
                                       init_rmsnorm, init_unembed, rmsnorm,
                                       stack_init, tree_index)
# the output projection is the transformer's (tied or untied; no softcap
# in these configs): the registry's facade reaches them through here
from repro_torch.models.transformer import (  # noqa: F401
    logits_of_hidden, unembed_matrix)


def init_layer(rng: torch.Generator, cfg: ModelConfig):
    """One Mamba2 layer: ``{"ln", "ssm"}``."""
    return {"ln": init_rmsnorm(cfg.d_model, rng.device),
            "ssm": ssm_mod.init_ssm(rng, cfg)}


def init_params(cfg: ModelConfig, rng: torch.Generator):
    """Random parameters drawn from ``rng``, on its device."""
    dev = rng.device
    return {
        "embed": init_embed(rng, cfg.vocab_size, cfg.d_model, cfg.dtype),
        "layers": stack_init(lambda: init_layer(rng, cfg), cfg.num_layers),
        "ln_f": init_rmsnorm(cfg.d_model, dev),
        "head": init_unembed(rng, cfg.vocab_size, cfg.d_model, cfg.dtype,
                             tie=cfg.tie_embeddings),
    }


def block(cfg, p, x):
    """One Mamba2 layer's training forward (pre-norm, residual)."""
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    return x + ssm_mod.ssm_train(cfg, p["ssm"], h)


def prefill_layer(cfg, p, x, st, i):
    """One Mamba2 layer's chunked-SSD prefill; its decode state (the
    inter-chunk combine's last state, the conv window) written into layer
    ``i`` of the stacked state ``st`` in place."""
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    y, new = ssm_mod.ssm_forward(cfg, p["ssm"], h, return_state=True)
    st["conv"][i] = new["conv"]
    st["ssm"][i] = new["ssm"]
    return x + y


def decode_layer(cfg, p, x, st, i):
    """One Mamba2 layer's decode, layer ``i`` of the stacked state ``st``
    updated in place."""
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    return x + ssm_mod.ssm_decode_into(cfg, p["ssm"], h, st["conv"][i],
                                       st["ssm"][i])


def forward(cfg: ModelConfig, params, batch, *, remat: bool = True, **_):
    """The training forward: (hidden [B, S, E], aux).  ``remat`` runs each
    layer under ``torch.utils.checkpoint`` when gradients are recorded."""
    x = embed(params["embed"], batch["tokens"])
    run = checkpointed(block, remat)
    for i in range(cfg.num_layers):
        x = run(cfg, tree_index(params["layers"], i), x)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return x, {"load_balance_loss": 0.0}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      kv_dtype=None, device=None):
    del max_len, kv_dtype  # O(1) state: no KV cache
    return {"ssm": ssm_mod.init_ssm_state(cfg, batch, cfg.num_layers,
                                          device),
            "pos": 0}


def decode_step(cfg: ModelConfig, params, state, tokens, *,
                use_kernels: bool | None = None):
    """tokens [B] -> (logits [B, V], state), the state updated in place."""
    del use_kernels  # no attention
    x = embed(params["embed"], tokens[:, None])
    st = state["ssm"]
    for i in range(cfg.num_layers):
        x = decode_layer(cfg, tree_index(params["layers"], i), x, st, i)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = logits_of_hidden(cfg, params, x[:, 0])
    return logits, {"ssm": st, "pos": int(state["pos"]) + 1}


def prefill(cfg: ModelConfig, params, batch, state, **_):
    """Chunked-SSD prefill: one training-shaped forward; each layer's
    decode state (the inter-chunk combine's last state, the conv window)
    is written into ``state`` in place.  Returns (last-position logits,
    state)."""
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens)
    st = state["ssm"]
    for i in range(cfg.num_layers):
        x = prefill_layer(cfg, tree_index(params["layers"], i), x, st, i)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = logits_of_hidden(cfg, params, x[:, -1])
    return logits, {"ssm": st, "pos": tokens.shape[1]}

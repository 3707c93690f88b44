"""Model registry: family -> implementation module, plus a uniform facade.

Counterpart of ``repro/models/registry.py``: every family of the reference
is ported (dense, moe and vlm to the transformer, ssm to mamba2, hybrid to
zamba2, audio to whisper).  :meth:`Model.abstract_params`, the
reference's ``jax.eval_shape`` of the initializer, builds the tree under
``FakeTensorMode``: shapes and dtypes, no storage.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import hybrid, mamba, transformer, whisper
from repro_torch.models.common import ModelConfig

_FAMILY_MODULES = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "ssm": mamba,
    "hybrid": hybrid,
    "audio": whisper,
}


@dataclasses.dataclass(frozen=True)
class Model:
    """Uniform facade over the family modules."""

    cfg: ModelConfig
    module: Any

    def init_params(self, rng: torch.Generator):
        return self.module.init_params(self.cfg, rng)

    def abstract_params(self, rng: torch.Generator | None = None):
        """The parameter tree as fake tensors, without allocation (the
        dry-run path); ``rng`` defaults to a fixed CPU generator."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            return self.init_params(
                rng if rng is not None else torch.Generator())

    def forward(self, params, batch, **kw):
        return self.module.forward(self.cfg, params, batch, **kw)

    def logits_of_hidden(self, params, hidden):
        return self.module.logits_of_hidden(self.cfg, params, hidden)

    def unembed_matrix(self, params):
        return self.module.unembed_matrix(self.cfg, params)

    def init_decode_state(self, batch: int, max_len: int, *, kv_dtype=None,
                          device=None, **kw):
        return self.module.init_decode_state(self.cfg, batch, max_len,
                                             kv_dtype=kv_dtype, device=device,
                                             **kw)

    def decode_step(self, params, state, tokens, *, use_kernels=None):
        return self.module.decode_step(self.cfg, params, state, tokens,
                                       use_kernels=use_kernels)

    def prefill(self, params, batch, state, **kw):
        return self.module.prefill(self.cfg, params, batch, state, **kw)

    @property
    def logit_softcap(self):
        return self.cfg.logit_softcap


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILY_MODULES:
        raise KeyError(f"unknown family {cfg.family}")
    return Model(cfg, _FAMILY_MODULES[cfg.family])


def param_count(params) -> int:
    from torch.utils import _pytree as pytree

    return sum(t.numel() for t in pytree.tree_leaves(params))


def active_param_count(cfg: ModelConfig, params) -> int:
    """Active params per token (MoE: top-k of the expert pool)."""
    total = param_count(params)
    if not cfg.num_experts:
        return total
    expert = sum(params["layers"]["moe"][name].numel()
                 for name in ("w_gate", "w_up", "w_down"))
    frac = cfg.num_experts_per_tok / cfg.num_experts
    return int(total - expert * (1 - frac))

"""Model configuration shared by the architectures.

Counterpart of ``repro/models/common.py``: :class:`ModelConfig` keeps the
reference's fields, defaults and derived sizes, with ``dtype`` a
``torch.dtype`` (the reference's ``jnp.bfloat16`` is ``torch.bfloat16``).
The reference's mesh and sharding helpers (``pick``, ``dp_axes``,
``param_spec``) are not ported: the port runs on one card, where there is
no mesh to shard over.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | moe | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # default d_model // num_heads
    qkv_bias: bool = False
    # gemma2-style options
    logit_softcap: float | None = None
    attn_softcap: float | None = None
    sliding_window: int | None = None
    local_global_alternate: bool = False
    post_norms: bool = False  # gemma2 post-attn/post-ffn norms
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # hybrid (zamba2): a shared attention block every k layers
    hybrid_attn_every: int = 6
    # encoder-decoder (whisper)
    enc_layers: int = 0
    dec_len: int = 448  # whisper max target positions
    # modality frontends are stubs: input_specs provides embeddings
    frontend: str | None = None  # None | "audio" | "vision"
    num_patches: int = 256  # vlm prefix length
    # numerics
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    act: str = "silu"
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.hd

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """May run the 500k-context decode shape."""
        return self.family in ("ssm", "hybrid")

    # --- SSM derived dims ---
    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests (the reference's
        sizes, f32)."""
        base = dict(
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            d_ff=128,
            vocab_size=128,
            head_dim=16,
            sliding_window=self.sliding_window and 32,
            num_experts=min(self.num_experts, 4),
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16,
            ssm_chunk=8,
            hybrid_attn_every=2,
            enc_layers=2 if self.enc_layers else 0,
            dec_len=16,
            num_patches=4,
            dtype=torch.float32,
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)

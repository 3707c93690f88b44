"""zamba2-1.2b [hybrid] — Mamba2 + shared attention blocks. [arXiv:2411.15242; hf]"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    hybrid_attn_every=6, dtype=torch.bfloat16,
)

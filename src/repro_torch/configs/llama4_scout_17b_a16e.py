"""llama4-scout-17b-a16e [moe] — 16 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    num_experts=16, num_experts_per_tok=1,
    rope_theta=500_000.0, dtype=torch.bfloat16,
)

"""qwen3-moe-30b-a3b [moe] — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128,
    num_experts=128, num_experts_per_tok=8,
    rope_theta=1_000_000.0, dtype=torch.bfloat16,
)

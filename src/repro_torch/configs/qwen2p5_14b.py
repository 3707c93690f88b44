"""qwen2.5-14b [dense] — GQA(kv=8), QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=13824, vocab_size=152064, head_dim=128,
    qkv_bias=True, rope_theta=1_000_000.0, dtype=torch.bfloat16,
)

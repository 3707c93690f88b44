"""qwen1.5-32b [dense] — QKV bias, MHA-like GQA(kv=40). [hf:Qwen/Qwen1.5-0.5B; hf]"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
    d_ff=27392, vocab_size=152064, head_dim=128,
    qkv_bias=True, rope_theta=1_000_000.0, dtype=torch.bfloat16,
)

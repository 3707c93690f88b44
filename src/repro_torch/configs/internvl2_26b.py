"""internvl2-26b [vlm] — InternViT STUB + InternLM2 backbone. [arXiv:2404.16821; hf]"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92553, head_dim=128,
    frontend="vision", num_patches=256,
    rope_theta=1_000_000.0, dtype=torch.bfloat16,
)

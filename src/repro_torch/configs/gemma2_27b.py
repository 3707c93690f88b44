"""gemma2-27b [dense] — local+global alternating, softcaps. [arXiv:2408.00118; hf]"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16,
    d_ff=36864, vocab_size=256000, head_dim=128,
    logit_softcap=30.0, attn_softcap=50.0,
    sliding_window=4096, local_global_alternate=True, post_norms=True,
    tie_embeddings=True, act="gelu", dtype=torch.bfloat16,
)

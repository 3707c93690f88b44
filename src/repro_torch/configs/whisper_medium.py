"""whisper-medium [audio] — enc-dec, conv frontend STUB. [arXiv:2212.04356; unverified]"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    num_layers=24, enc_layers=24, d_model=1024, num_heads=16,
    num_kv_heads=16, d_ff=4096, vocab_size=51865, head_dim=64,
    dec_len=448, frontend="audio", act="gelu",
    tie_embeddings=True, norm_eps=1e-5, dtype=torch.bfloat16,
)

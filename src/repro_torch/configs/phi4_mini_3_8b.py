"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA decoder.

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064
[arXiv:2412.08905; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    attention="gqa",
    mlp_act="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, scan_layers=False, max_seq_len=128,
    )

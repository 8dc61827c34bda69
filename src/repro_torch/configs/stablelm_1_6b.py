"""stablelm-1.6b [dense] — MHA decoder (kv = heads), LayerNorm.

24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352
[hf:stabilityai/stablelm-2-1_6b; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100352,
    attention="gqa",
    mlp_act="swiglu",
    norm="layernorm",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, scan_layers=False, max_seq_len=128,
    )

"""opt-6.7b — the paper's own evaluation architecture.

32L d_model=4096 32H MHA d_ff=16384 vocab=50272, learned positions,
LayerNorm, GELU  [arXiv:2205.01068]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="opt-6.7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=16384,
    vocab_size=50272,
    attention="gqa",
    pos="learned",
    mlp_act="gelu",
    norm="layernorm",
    tie_embeddings=True,
    max_seq_len=2048,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, scan_layers=False, max_seq_len=128,
    )

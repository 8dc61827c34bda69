"""qwen1.5-32b [dense] — GQA decoder with QKV bias.

64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064
[hf:Qwen/Qwen1.5-0.5B; hf]

Copied as the reference has it: 40 kv heads (MHA), where the published
Qwen1.5-32B has 8 (GQA); the port computes what the reference computes.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    attention="gqa",
    qkv_bias=True,
    mlp_act="swiglu",
    norm="rmsnorm",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, scan_layers=False, max_seq_len=128,
    )

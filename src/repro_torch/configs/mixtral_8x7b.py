"""mixtral-8x7b [moe] — 8-expert top-2 MoE with sliding-window attention.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2, SWA
[arXiv:2401.04088; hf]

The window of 4096 caps the contiguous cache's ring at 4096 slots, so
the model serves through the slots engine (a paged pool refuses a
window, as in the reference).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    attention="gqa",
    sliding_window=4096,
    n_experts=8,
    experts_per_token=2,
    moe_d_ff=14336,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, n_experts=4, experts_per_token=2,
        moe_d_ff=128, sliding_window=32, scan_layers=False, max_seq_len=128,
    )

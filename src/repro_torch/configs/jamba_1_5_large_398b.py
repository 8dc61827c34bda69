"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7 interleave + MoE.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2
[arXiv:2403.19887; hf]

Layer pattern: attention at i % 8 == 4 (9 attention layers, 63 Mamba
layers, the SSD mixer as in the reference); MoE replaces the MLP on
every 2nd layer.  Its Mamba layers hold a decode state, nothing to
page, so it serves through the slots engine.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    attention="gqa",
    attn_layer_period=8,
    attn_layer_offset=4,
    n_experts=16,
    experts_per_token=2,
    moe_d_ff=24576,
    moe_layer_period=2,
    ssm_state=64,
    ssm_head_dim=128,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    mlp_act="swiglu",
    norm="rmsnorm",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, n_experts=4, experts_per_token=2,
        moe_d_ff=128, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
        attn_layer_period=4, attn_layer_offset=2, scan_layers=False,
        max_seq_len=128,
    )

"""deepseek-v2-236b [moe] — MLA attention + 160-expert top-6 MoE.

60L d_model=5120 128H d_ff=1536(expert) vocab=102400, MoE 160e top-6,
MLA kv_lora=512, 2 shared + 160 routed  [arXiv:2405.04434; hf]

MLA dims from the paper: q_lora 1536, kv_lora 512, qk_nope 128,
qk_rope 64, v_head 128.  Layer 0 is dense (d_ff 12288), so under
``scan_layers`` it is the stack's prefix (``stack/prefix/0``).  Every
layer is attention, so it serves through the paged engine.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,             # MLA: full heads after latent decompression
    d_ff=12288,                 # dense layers (layer 0)
    vocab_size=102400,
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=160,
    n_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1536,
    first_dense_layers=1,
    mlp_act="swiglu",
    norm="rmsnorm",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, n_experts=8, n_shared_experts=1,
        experts_per_token=2, moe_d_ff=32, first_dense_layers=1,
        scan_layers=False, max_seq_len=128,
    )

"""minicpm3-4b [dense] — MLA attention, dense SwiGLU MLP.

62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA
[hf:openbmb/MiniCPM3-4B; hf]

MLA dims from the HF config: q_lora 768, kv_lora 256, qk_nope 64,
qk_rope 32, v_head 64.  As in the reference, none of HF's embedding,
depth or logit scalings (``scale_emb``, ``scale_depth``,
``dim_model_base``) and no long-RoPE scaling.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attention="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_head_dim=64,
    qk_rope_head_dim=32,
    v_head_dim=64,
    mlp_act="swiglu",
    norm="rmsnorm",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, scan_layers=False, max_seq_len=128,
    )

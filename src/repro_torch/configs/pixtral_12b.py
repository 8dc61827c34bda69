"""pixtral-12b [vlm] — Pixtral-ViT frontend (stub) + Mistral-Nemo backbone.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409; unverified]

The vision frontend is a stub, as in the reference: the caller passes
precomputed patch embeddings [B, P, d_model], which the model prepends
to the text embeddings (``Model._embed``).  Text-only requests serve
through the paged engine.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    attention="gqa",
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    num_patches=1024,           # stub: 32x32 patch grid of embeddings
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, num_patches=8, scan_layers=False,
        max_seq_len=128,
    )

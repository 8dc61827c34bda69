"""mamba2-2.7b [ssm] — attention-free SSD (state-space duality).

64L d_model=2560 d_ff=0 vocab=50280, ssm_state=128
[arXiv:2405.21060]

Mamba2 block: expand=2 (d_inner 5120), head_dim 64 (80 heads), conv 4,
chunk 128.  No separate MLP (d_ff=0): the block is the layer.  The
decode state is O(1) in sequence length, nothing to page, so it serves
through the slots engine; the head is tied to the token table.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    attention="none",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    norm="rmsnorm",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, vocab_size=256, ssm_state=16, ssm_head_dim=16,
        ssm_chunk=16, scan_layers=False, max_seq_len=128,
    )

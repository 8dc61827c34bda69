"""whisper-medium [audio] — encoder-decoder transformer backbone.

24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865 — enc-dec, conv
frontend (stub)  [arXiv:2212.04356; unverified]

The conv/mel frontend is a stub, as in the reference: the caller passes
precomputed frame embeddings [B, 1500, d_model] to the encoder
(``Model.encode``).  Each decoder layer cross-attends to the encoder
output through K/V written into its cache at prefill.  ``max_seq_len``
is the base config's 524,288, as the reference inherits it, so the
learned decoder position table is 524,288 x 1024 (the published model
has 448 positions).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,                 # decoder layers
    n_encoder_layers=24,
    encoder_seq=1500,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    attention="gqa",
    pos="learned",
    mlp_act="gelu",
    norm="layernorm",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, n_encoder_layers=2, encoder_seq=16, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        scan_layers=False, max_seq_len=128,
    )

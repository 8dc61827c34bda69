"""Model configuration (counterpart of ``repro.configs.base``).

Carries the fields the ported decoders use: ``kv_cache_bits`` (16, or 8
for an int8 KV cache), the MLA widths, ``qkv_bias`` and ``rope_theta``
among them.  The port builds OPT (MHA, learned positions), the rotary
GQA decoders (Phi-4-mini, Qwen1.5, StableLM) and MiniCPM3 (MLA).
Architectures it does not build yet (MoE, SSM, enc-dec, sliding
window) are refused where the model is built, naming their ROADMAP.md
item.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

from repro_torch.quant.spec import QuantSpec


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0
    attention: str = "gqa"
    sliding_window: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    pos: str = "rope"
    # MLA (minicpm3)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mlp_act: str = "swiglu"
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    max_seq_len: int = 524288
    quant: Optional[QuantSpec] = None
    scan_layers: bool = True
    kv_replication: int = 1
    kv_cache_bits: int = 16
    paged_kernel: str = "auto"

    @property
    def backend_preference(self) -> str:
        return self.quant.backend if self.quant is not None else "dense"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab_size // 256) * 256

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


ARCH_IDS = ["opt_6_7b", "minicpm3_4b", "phi4_mini_3_8b", "qwen1_5_32b",
            "stablelm_1_6b"]


def _module(arch: str):
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"arch {arch!r} is not ported yet; ported: "
                       f"{ARCH_IDS} (ROADMAP.md queue 1 item 8)")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()

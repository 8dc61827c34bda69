"""Model configuration (counterpart of ``repro.configs.base``).

Carries the fields the ported decoders use: ``kv_cache_bits`` (16, or 8
for an int8 KV cache), the MLA widths, ``qkv_bias``, ``rope_theta``,
``sliding_window``, the MoE fields and the SSM fields among them.  The
port builds OPT (MHA, learned positions), the rotary GQA decoders
(Phi-4-mini, Qwen1.5, StableLM), MiniCPM3 (MLA), Mixtral
(sliding-window GQA with MoE layers), DeepSeek-V2 (MLA with MoE layers
after a dense prefix), Mamba2 (attention-free SSD layers), Jamba (the
hybrid Mamba / attention interleave with MoE layers), Pixtral (rotary
GQA behind a stub patch frontend, ``num_patches``) and Whisper (an
encoder-decoder: ``n_encoder_layers`` over ``encoder_seq`` stub frames,
``is_encdec``).  Each layer's mixer is ``layer_kind(i)`` ("attn" or
"mamba") and its MLP ``mlp_kind(i)``, as in the reference.  An unknown
architecture is refused where it is looked up.

The shape cells are the reference's (``SHAPES``: train_4k, prefill_32k,
decode_32k, long_500k), and ``ModelConfig.input_specs`` gives a cell's
model inputs as tensors on ``torch.device("meta")``: shapes and dtypes,
no storage (the dry run's, ``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch

from repro_torch.quant.spec import QuantSpec


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str             # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


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
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                 # expert hidden width (d_ff if 0)
    moe_layer_period: int = 1         # MoE every k-th layer
    first_dense_layers: int = 0       # leading dense layers
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    attn_layer_period: int = 0        # hybrid: 1 attn layer every k
    attn_layer_offset: int = 4
    # enc-dec (whisper)
    n_encoder_layers: int = 0
    encoder_seq: int = 0              # stub frontend's frame count
    # vlm stub
    num_patches: int = 0              # precomputed patch embeds prepended
    mlp_act: str = "swiglu"
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    max_seq_len: int = 524288
    quant: Optional[QuantSpec] = None
    # checkpoint each block of a training forward (``models/transformer.py``)
    remat: bool = True
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

    @property
    def is_hybrid(self) -> bool:
        return self.attn_layer_period > 0

    @property
    def is_ssm_only(self) -> bool:
        return self.attention == "none" and self.ssm_state > 0

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    def layer_kind(self, i: int) -> str:
        """'attn' or 'mamba' for decoder layer i."""
        if self.is_ssm_only:
            return "mamba"
        if self.is_hybrid:
            return ("attn" if i % self.attn_layer_period
                    == self.attn_layer_offset else "mamba")
        return "attn"

    def mlp_kind(self, i: int) -> str:
        """'dense' or 'moe' for decoder layer i."""
        period = self.moe_layer_period
        if self.n_experts and i >= self.first_dense_layers \
                and i % period == (period - 1 if period > 1 else 0):
            return "moe"
        return "dense"

    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM, hybrid, or sliding-window attention."""
        return self.is_ssm_only or self.is_hybrid or self.sliding_window > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def input_specs(self, shape: ShapeCfg, *, per_device: bool = False,
                    data_shards: int = 1) -> dict:
        """Every model input of a shape cell as a meta tensor.

        ``train`` / ``prefill`` -> the token batch [B, S] (an
        encoder-decoder adds ``frames`` [B, encoder_seq, d]; a VLM takes
        ``patch_embeds`` [B, P, d] and S - P tokens); ``decode`` -> [B, 1]
        new tokens (the cache is built separately)."""
        b = shape.global_batch // (data_shards if per_device else 1)
        s = shape.seq_len
        dt = getattr(torch, self.dtype)

        def meta(shp, dtype=torch.int32):
            return torch.empty(shp, dtype=dtype, device="meta")
        if shape.kind == "decode":
            return {"tokens": meta((b, 1))}
        if self.is_encdec:
            enc = self.encoder_seq or 1500
            return {"frames": meta((b, enc, self.d_model), dt),
                    "tokens": meta((b, s))}
        if self.num_patches:
            p = min(self.num_patches, s // 2)
            return {"tokens": meta((b, s - p)),
                    "patch_embeds": meta((b, p, self.d_model), dt)}
        return {"tokens": meta((b, s))}


ARCH_IDS = ["opt_6_7b", "minicpm3_4b", "phi4_mini_3_8b", "qwen1_5_32b",
            "stablelm_1_6b", "mixtral_8x7b", "deepseek_v2_236b",
            "mamba2_2_7b", "jamba_1_5_large_398b", "pixtral_12b",
            "whisper_medium"]


def _module(arch: str):
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


def registry() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}

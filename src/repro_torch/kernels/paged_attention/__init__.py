"""Paged decode / chunked-prefill attention (CUDA), float and int8 pools,
absorbed MLA decode over a latent pool, and their plain versions."""
from .ops import (paged_attention, paged_attention_int8, paged_attention_mla,
                  paged_prefill)
from .ref import (gather_view, paged_decode_int8_ref, paged_decode_mla_ref,
                  paged_decode_mla_split_ref, paged_decode_ref,
                  paged_decode_split_ref, paged_prefill_ref)

__all__ = ["paged_attention", "paged_attention_int8", "paged_attention_mla",
           "paged_prefill", "gather_view", "paged_decode_int8_ref",
           "paged_decode_mla_ref", "paged_decode_mla_split_ref",
           "paged_decode_ref", "paged_decode_split_ref", "paged_prefill_ref"]

"""Float paged decode / chunked-prefill attention (CUDA) and plain versions."""
from .ops import paged_attention, paged_prefill
from .ref import gather_view, paged_decode_ref, paged_prefill_ref

__all__ = ["paged_attention", "paged_prefill", "gather_view",
           "paged_decode_ref", "paged_prefill_ref"]

"""Quantization API of the port: spec, formats, backends, bit plans,
quantize_model and quantized checkpoints."""
from repro_torch.quant.api import (QUANT_KEYS, QuantManifest, build_manifest,
                                   collect_linears, plan_bits,
                                   quantize_model)
from repro_torch.quant.backends import (AUTO_CHAIN, FALLBACK_CHAINS,
                                        execute_linear, fallback_chain,
                                        resolve_backend)
from repro_torch.quant.checkpoint import load_quantized, save_quantized
from repro_torch.quant.formats import (available_formats, format_for_bits,
                                       get_format)
from repro_torch.quant.spec import TERNARY_BITS, QuantSpec, canonical_format

__all__ = ["QUANT_KEYS", "QuantManifest", "QuantSpec", "TERNARY_BITS",
           "AUTO_CHAIN", "FALLBACK_CHAINS", "available_formats",
           "build_manifest", "canonical_format", "collect_linears",
           "execute_linear", "fallback_chain", "format_for_bits",
           "get_format", "load_quantized", "plan_bits", "quantize_model",
           "resolve_backend", "save_quantized"]

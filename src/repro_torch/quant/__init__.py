"""Quantization API of the port: spec, formats, backends, quantize_model."""
from repro_torch.quant.api import (QUANT_KEYS, QuantManifest, collect_linears,
                                   quantize_model)
from repro_torch.quant.backends import (AUTO_CHAIN, FALLBACK_CHAINS,
                                        execute_linear, fallback_chain,
                                        resolve_backend)
from repro_torch.quant.formats import get_format
from repro_torch.quant.spec import QuantSpec, canonical_format

__all__ = ["QUANT_KEYS", "QuantManifest", "QuantSpec", "AUTO_CHAIN",
           "FALLBACK_CHAINS", "canonical_format",
           "collect_linears", "execute_linear", "fallback_chain",
           "get_format", "quantize_model", "resolve_backend"]

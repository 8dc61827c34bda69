"""``linear_apply`` — every linear of the model stack goes through here.

Counterpart of ``repro.core.quantized_linear``: a weight is a dense
[out, in] tensor or a :class:`PlaneBundle`; the backend registry
(:mod:`repro_torch.quant.backends`) resolves the preference per weight.
"""
from __future__ import annotations

from typing import Optional

import torch


def linear_apply(w, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 backend: Optional[str] = None, out_dtype=None) -> torch.Tensor:
    """y = x @ W^T (+ bias)."""
    from repro_torch.quant.backends import execute_linear
    y = execute_linear(x, w, backend=backend, out_dtype=out_dtype or x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y

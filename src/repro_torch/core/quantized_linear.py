"""``linear_apply`` — every linear of the model stack goes through here.

Counterpart of ``repro.core.quantized_linear``: a weight is a dense
[out, in] tensor or a :class:`PlaneBundle`; the backend registry
(:mod:`repro_torch.quant.backends`) resolves the preference per weight.
``set_capture`` installs a hook that sees every call's weight and
input: OPTQ's calibration capture (``quant.optq.capture_calibration``).
"""
from __future__ import annotations

from typing import Optional

import torch

_CAPTURE = None


def set_capture(fn) -> None:
    """Install (or remove, with None) a hook ``fn(w, x)`` called on every
    ``linear_apply``."""
    global _CAPTURE
    _CAPTURE = fn


def linear_apply(w, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 backend: Optional[str] = None, out_dtype=None) -> torch.Tensor:
    """y = x @ W^T (+ bias)."""
    if _CAPTURE is not None:
        _CAPTURE(w, x)
    from repro_torch.quant.backends import execute_linear
    y = execute_linear(x, w, backend=backend, out_dtype=out_dtype or x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y

"""Plain version of bcq_matmul: dense dequantized matmul, f32 accumulate."""
from __future__ import annotations

import torch

from repro_torch.core.plane import PlaneBundle, dequantize


def bcq_matmul_ref(x: torch.Tensor, w: PlaneBundle,
                   out_dtype=None) -> torch.Tensor:
    dense = dequantize(w, dtype=torch.float32)
    y = torch.matmul(x.float(), dense.T)
    return y.to(out_dtype or x.dtype)

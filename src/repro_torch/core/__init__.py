"""Plane layout, BCQ quantizers and linear execution (port of ``repro.core``)."""
from repro_torch.core.plane import (PlaneBundle, dequantize, pack_planes,
                                    unpack_planes)
from repro_torch.core.quantized_linear import linear_apply

__all__ = ["PlaneBundle", "dequantize", "pack_planes", "unpack_planes",
           "linear_apply"]

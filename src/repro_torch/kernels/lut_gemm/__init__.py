"""FIGLUT LUT GEMM (CUDA) and its plain versions."""
from .ops import lut_gemm, route_for
from .ref import dense_ref, lut_ref

__all__ = ["lut_gemm", "route_for", "dense_ref", "lut_ref"]

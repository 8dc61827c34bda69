"""Dedicated ternary (1.58-bit) GEMM (CUDA) and its plain versions."""
from .ops import route_for, ternary_matmul
from .ref import (dense_ref, ternary_masked_ref, ternary_planes_ref,
                  ternary_ref)

__all__ = ["ternary_matmul", "route_for", "dense_ref", "ternary_masked_ref",
           "ternary_planes_ref", "ternary_ref"]

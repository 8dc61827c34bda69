"""Dequant-then-FMA packed-weight GEMM (CUDA) and its plain version."""
from .ops import bcq_matmul
from .ref import bcq_matmul_ref

__all__ = ["bcq_matmul", "bcq_matmul_ref"]

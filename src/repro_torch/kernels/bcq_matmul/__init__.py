"""Packed-weight GEMM (CUDA: tensor-core decode tile, CUDA-core GEMV,
tensor-core tile, dequantizing tensor-core tile) and its plain
versions."""
from .ops import bcq_matmul, route_for
from .ref import (bcq_matmul_ref, bcq_planes_ref, dq_split_ref,
                  gemv_split_ref, mma_split_ref, plane_group_sums,
                  split_bf16x3)

__all__ = ["bcq_matmul", "route_for", "bcq_matmul_ref", "bcq_planes_ref",
           "dq_split_ref", "gemv_split_ref", "mma_split_ref",
           "plane_group_sums", "split_bf16x3"]

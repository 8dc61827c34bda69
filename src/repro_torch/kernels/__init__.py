"""Hand-written Hopper kernels, each beside its plain PyTorch version.

  * ``bcq_matmul``      — packed-plane GEMM, dequant in shared memory;
  * ``lut_gemm``        — FIGLUT's LUT GEMM (``lut_common`` holds the math);
  * ``ternary_matmul``  — the ternary half-LUT GEMM (sign + mask planes);
  * ``paged_attention`` — paged decode and chunked prefill over float
                          pools and int8 pools with per-slot scales, and
                          absorbed MLA decode over a latent pool.

The CUDA sources live in ``repro_torch/csrc``; ``_lib`` builds them at
first use and keeps the per-kernel launch counts.
"""
from ._lib import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts"]

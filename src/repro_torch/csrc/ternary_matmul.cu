// ternary_matmul: FIGLUT's LUT GEMM for ternary weights,
// y[B, M] = x . dequant(W)^T with W = alpha * sign * mask.
//
// Replaces: src/repro/kernels/ternary_matmul/ternary_matmul.py
// ::_ternary_matmul_kernel (launcher ternary_matmul_tiled) with
// lut_common.ternary_plane_bytes, build_lut(half=True), extract_keys and
// read_lut.
//
// What bounds it on an H100: at decode, bytes (the sign and mask planes,
// N/4 bytes per weight row, and one alpha row); at prefill, operations.
//
// This file is the dispatcher of three bodies, picked by the wrapper
// (kernels/ternary_matmul/ops.py route_for) and passed here as route:
//   route 2 "gemv"    at most 8 rows of bf16 or f32 activations with
//                     group size 32, 64, 128 or 256 and in_features a
//                     multiple of 8: the tensor-core decode tile of
//                     bcq_decode.cu with its ternary flag (one {-1, 0,
//                     +1} operand decoded from the sign and mask words);
//   route 1 "mma"     more than 8 rows of bf16 or f32 activations with
//                     group size a multiple of 16 up to 256 and
//                     in_features a multiple of 8: the tensor-core tile
//                     of bcq_mma.cu with the derived planes b1 = s | ~m,
//                     b2 = s & m decoded in registers (f32 x split into
//                     three bf16 parts);
//   route 0 "mma_dq"  every other call, at any row count (group sizes 8
//                     mod 16 or above 256, 8, 16 or 24 at decode rows,
//                     in_features not a multiple of 8): the dequantizing
//                     tensor-core tile of bcq_dq.cu with its ternary
//                     flag, W = alpha mask (+-1 sign) built in registers
//                     and run, split into two bf16 parts, against x.
// Where the output tiles alone would leave SMs idle, each body splits
// its reduction axis over blocks and adds the partials in a fixed order.
// On exact inputs (integer activations, power-of-two alphas) every body
// equals the plain versions bit for bit.
#include "bcq_decode.cuh"
#include "bcq_dq.cuh"

// part: scratch f32 [splits, B, M] when splits > 1; sem: int32 counters,
// one per 64-row tile, all zero, for route 2 when splits > 1 (the last
// block of each tile sets its counter back to 0)
extern "C" int launch_ternary_matmul(const void* x, const void* packed,
                                     const void* alpha, void* y, void* part,
                                     void* sem, int B, int M, int N, int NB,
                                     int G, int gs, int x_is_bf16, int route,
                                     int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case 2:
      return static_cast<int>(launch_bcq_decode(
          x, packed, alpha, nullptr, y, part, sem, B, M, N, NB, G, 2, gs,
          x_is_bf16 != 0, true, splits, s));
    case 1:
      if (B <= 8) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch_bcq_mma(
          x, packed, alpha, nullptr, static_cast<float*>(y),
          static_cast<float*>(part), B, M, N, NB, G, 2, gs, splits, true,
          x_is_bf16 != 0, s));
    case 0:
      return static_cast<int>(launch_bcq_dq(
          x, packed, alpha, nullptr, static_cast<float*>(y),
          static_cast<float*>(part), B, M, N, NB, G, 2, gs, splits, true,
          x_is_bf16 != 0, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

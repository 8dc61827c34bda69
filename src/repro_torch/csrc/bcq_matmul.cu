// bcq_matmul: y[B, M] = x[B, N] . (sum_i alpha_i (2 b_i - 1) + z)^T
//
// Replaces: src/repro/kernels/bcq_matmul/bcq_matmul.py::_bcq_matmul_kernel
// (launcher bcq_matmul_tiled), the dequant-in-VMEM TPU matmul.
//
// What bounds it on an H100: at decode (B <= 8) it is bound by bytes —
// the packed planes (q/8 B per weight) plus the f32 alpha and z rows
// (4 (q+1) / group_size B per weight) are read once and every weight
// feeds at most 8 products.  At prefill (B = 32..512) it is bound by
// operations: 2 B M N of them, q times that on the bit planes.
//
// Three bodies, all on the tensor cores; the wrapper
// (kernels/bcq_matmul/ops.py, route_for) picks one by a documented rule
// and passes it as `route`:
//   route 1 "gemv"      B <= 8, bf16 or f32 activations, group size 32,
//                       64, 128 or 256, in_features a multiple of 8: the
//                       tensor-core decode tile (bcq_decode.cu; f32 x
//                       split there into three bf16 parts);
//   route 2 "mma"       B > 8, bf16 or f32 activations, group size a
//                       multiple of 16 up to 256, in_features a multiple
//                       of 8: the tensor-core BCQ tile of bcq_mma.cu, one
//                       bf16 mma.sync product per bit plane and alpha
//                       group against the +-1 plane decoded in registers
//                       (f32 x split there into three bf16 parts);
//   route 0 "mma_dq"    every other call, at any row count (group sizes
//                       8 mod 16, 16 or above 256 and the like,
//                       in_features not a multiple of 8): the
//                       dequantizing tensor-core tile of bcq_dq.cu, which
//                       builds W = sum_i alpha_i (+-1)_i + z in registers
//                       and runs it, split into two bf16 parts, against x
//                       (f32 x split there into bf16 parts; at B <= 8 a
//                       decode stage of 512 columns, bound by bytes).
// The weight is never written back dense, and ragged M / N / B edges
// are masked in-kernel instead of padded by a copy per call.
#include "bcq_decode.cuh"
#include "bcq_dq.cuh"

// route: 0 mma_dq, 1 gemv, 2 mma (see the note at the top);
// part: scratch f32 [splits, B, M] for routes 0, 1 and 2 when splits > 1;
// sem: int32 counters, one per 64-row tile, all zero, for route 1 when
// splits > 1 (the last block of each tile sets its counter back to 0)
extern "C" int launch_bcq_matmul(const void* x, const void* packed,
                                 const void* alpha, const void* z, void* y,
                                 void* part, void* sem, int B, int M, int N,
                                 int NB, int G, int q, int gs, int x_is_bf16,
                                 int route, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q < 1 || q > 8 || gs % 8 || G * gs != NB * 8 || N > NB * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (route) {
    case 0:
      return static_cast<int>(launch_bcq_dq(
          x, packed, alpha, z, static_cast<float*>(y),
          static_cast<float*>(part), B, M, N, NB, G, q, gs, splits, false,
          x_is_bf16 != 0, s));
    case 1:
      return static_cast<int>(launch_bcq_decode(x, packed, alpha, z, y, part,
                                                sem, B, M, N, NB, G, q, gs,
                                                x_is_bf16 != 0, false, splits,
                                                s));
    case 2:
      if (B <= 8) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch_bcq_mma(
          x, packed, alpha, z, static_cast<float*>(y),
          static_cast<float*>(part), B, M, N, NB, G, q, gs, splits, false,
          x_is_bf16 != 0, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

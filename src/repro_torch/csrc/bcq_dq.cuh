// The dequantizing tensor-core tile: y[B, M] = x . dequant(W)^T with the
// weight dequantized in registers, the "mma_dq" route of bcq_matmul,
// lut_gemm and ternary_matmul (every group size and input width, at any
// row count).  See bcq_dq.cu for the design.
#pragma once

#include "bcq_mma.cuh"

constexpr int BCQ_DQ_ROWS = 128;         // weight rows per block above 8
constexpr int BCQ_DQ_STEP = 64;          // reduction columns per stage
constexpr int BCQ_DQ_DECODE_STEP = 512;  // the same at 8 rows or fewer

// x [B, N] bf16 (x_is_bf16) or f32, base 16-byte aligned (any N);
// packed uint8 [q, M, NB]; alpha f32 [q, M, G]; z f32 [M, G] or null;
// y f32 [B, M]; any group size that is a multiple of 8.
// With ternary, packed holds the sign and mask planes (q = 2), alpha is
// one row [1, M, G] and z is null: W = alpha mask (+-1 sign).
// With splits > 1 the stages (BCQ_DQ_STEP columns, BCQ_DQ_DECODE_STEP at
// B <= 8) are split over that many blocks per output tile, whose partial
// sums go to part f32 [splits, B, M] and are added in split order into y.  Returns cudaErrorInvalidValue for a
// shape it does not take.
cudaError_t launch_bcq_dq(const void* x, const void* packed,
                          const void* alpha, const void* z, float* y,
                          float* part, int B, int M, int N, int NB, int G,
                          int q, int gs, int splits, bool ternary,
                          bool x_is_bf16, cudaStream_t s);

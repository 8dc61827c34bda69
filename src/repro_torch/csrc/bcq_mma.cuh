// The tensor-core BCQ tile: y[B, M] = x . dequant(W)^T for bf16
// activations at prefill widths, shared by bcq_matmul and lut_gemm.
// See bcq_mma.cu for the design.
#pragma once

#include "common.cuh"

constexpr int BCQ_MMA_ROWS = 128;    // weight rows per block
constexpr int BCQ_MMA_BATCH = 64;    // batch rows per block
constexpr int BCQ_MMA_MAX_GS = 256;  // widest alpha group it stages

// x bf16 [B, N] (rows 16-byte aligned, N % 8 == 0), packed uint8
// [q, M, NB], alpha f32 [q, M, G], z f32 [M, G] or null, y f32 [B, M].
// With ternary, packed holds the sign and mask planes (q = 2), alpha is
// one row [1, M, G] and z is null: y = sum_g (alpha / 2) x . ((+-1 b1) +
// (+-1 b2)) over the derived planes b1 = s | ~m, b2 = s & m.
// With splits > 1 the alpha groups are split over that many blocks per
// output tile, whose partial sums go to part f32 [splits, B, M] and are
// added in split order into y.  Returns cudaErrorInvalidValue for a
// shape it does not take.
cudaError_t launch_bcq_mma(const void* x, const void* packed,
                           const void* alpha, const void* z, float* y,
                           float* part, int B, int M, int N, int NB, int G,
                           int q, int gs, int splits, bool ternary,
                           cudaStream_t s);

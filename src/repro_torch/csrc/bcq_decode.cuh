// The tensor-core decode tile: y[B, M] = x . dequant(W)^T for at most 8
// activation rows, the "gemv" route of bcq_matmul and ternary_matmul.
// See bcq_decode.cu for the design.
#pragma once

#include "bcq_mma.cuh"

constexpr int BCQ_DECODE_ROWS = 64;   // weight rows per block
constexpr int BCQ_DECODE_BATCH = 8;   // most activation rows
constexpr int BCQ_DECODE_STEP = 256;  // reduction columns per stage

// x [B, N] bf16 (x_is_bf16) or f32, rows 16-byte aligned, N % 8 == 0;
// packed uint8 [q, M, NB]; alpha f32 [q, M, G]; z f32 [M, G] or null;
// y f32 [B, M]; group size 32, 64, 128 or 256.
// With ternary, packed holds the sign and mask planes (q = 2), alpha is
// one row [1, M, G] and z is null: y = sum_g alpha x . (mask (+-1 sign)).
// With splits > 1 the 256-column steps are split over that many blocks
// per 64-row tile; they write part f32 [splits, B, M], and the last block
// of each tile to finish adds them in split order into y, counted in sem
// (int32, one zeroed counter per 64-row tile, left at 0).  Returns
// cudaErrorInvalidValue for a shape it does not take.
cudaError_t launch_bcq_decode(const void* x, const void* packed,
                              const void* alpha, const void* z, void* y,
                              void* part, void* sem, int B, int M, int N,
                              int NB, int G, int q, int gs, bool x_is_bf16,
                              bool ternary, int splits, cudaStream_t s);

// The tensor-core BCQ tile: y[B, M] = x . dequant(W)^T for bf16 or f32
// activations at prefill widths, shared by bcq_matmul, lut_gemm and
// ternary_matmul.  See bcq_mma.cu for the design.
#pragma once

#include "common.cuh"

constexpr int BCQ_MMA_ROWS = 128;    // weight rows per block
constexpr int BCQ_MMA_BATCH = 64;    // batch rows per block
constexpr int BCQ_MMA_MAX_GS = 256;  // widest alpha group it stages

// Device helpers of the tensor-core BCQ tiles (the prefill tile of
// bcq_mma.cu and the decode tile of bcq_decode.cu).

// four 8x8 b16 matrices from shared memory (lanes 8j .. 8j + 7 give the
// row addresses of matrix j)
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a * b, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bits s and s + 1 of w -> two bf16 (+1 = 0x3F80 for a set bit, -1 =
// 0xBF80 for a clear one), bit s in the low half, for s <= 14, with
// mask = 3 << s and mul = 0x40008000 >> s fixed per thread: the multiply
// puts bit s on bit 15 and bit s + 1 on bit 31 (the cross terms land on
// bits 16 and 30, outside the mask), and the xor flips -1 to +1 where a
// bit is set.  Three instructions a register (the and and the xor are
// one lop3, written out: the compiler emits two), no shift of w.
__device__ __forceinline__ unsigned decode_pm1_at(unsigned w, unsigned mask,
                                                  unsigned mul) {
  const unsigned t = (w & mask) * mul;
  unsigned r;
  // r = (t & 0x80008000) ^ 0xBF80BF80: lut 0xF0 & 0xCC ^ 0xAA = 0x6A
  asm("lop3.b32 %0, %1, 0x80008000, %2, 0x6A;"
      : "=r"(r)
      : "r"(t), "r"(0xBF80BF80u));
  return r;
}

constexpr unsigned ONES = 0x3F803F80u;  // two bf16 +1

// two f32 values -> their three bf16 parts as bf16 pairs: w[0] = h =
// bf16(v), w[1] = m = bf16(v - h), w[2] = l = bf16(v - h - m), each
// residual exact in f32 (for normal v, h + m + l = v)
__device__ __forceinline__ void split_bf16x3(float2 v, unsigned (&w)[3]) {
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
    w[p] = *reinterpret_cast<const unsigned*>(&h);
    const float2 hf = __bfloat1622float2(h);
    v.x -= hf.x;
    v.y -= hf.y;
  }
}

// alpha and z are staged SG groups at a time (a row's values for
// consecutive groups are contiguous, so 8 lanes fill one 32-byte
// sector), rows SGP floats apart (odd: the 8 rows a warp reads at once
// fall in 8 banks)
constexpr int SG = 8;
constexpr int SGP = SG + 1;

// x bf16 or f32 (x_is_bf16) [B, N] (rows 16-byte aligned, N % 8 == 0;
// f32 x is split into three bf16 parts in the kernel), packed uint8
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
                           bool x_is_bf16, cudaStream_t s);

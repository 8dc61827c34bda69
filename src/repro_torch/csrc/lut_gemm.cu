// lut_gemm: FIGLUT's LUT-based FP-INT GEMM, y[B, M] = x . dequant(W)^T
//
// Replaces: src/repro/kernels/lut_gemm/lut_gemm.py::_lut_gemm_kernel
// (launcher lut_gemm_tiled) with the lut_common.py helpers sign_matrix,
// build_lut, extract_keys and read_lut.
//
// What bounds it on an H100: at decode it is bound by bytes (the packed
// planes, alpha and z, as for bcq_matmul).  Beyond that the keyed reads
// are shared-memory operations: each weight byte costs 8/mu table reads
// per batch row, so at prefill the shared-memory read rate, not the
// FLOP rate, is the wall.
//
// What the design does about it: one block owns 32 weight rows (one per
// lane) and 8 batch rows, and walks the whole reduction axis in chunks
// of at most 128 columns that never straddle an alpha group (nothing
// is carried between blocks).  Per chunk it
//   1. stages the x chunk and the chunk's plane bytes in shared memory
//      (bytes at a 20-byte row stride, so 32 lanes reading one column
//      hit 32 distinct banks);
//   2. builds the LUT: for every batch row and mu-group the 2^mu signed
//      sums (hFFLUT: only the 2^(mu-1) MSB=1 entries), plus the chunk's
//      activation sum for the offset term;
//   3. each lane pulls 8/mu keys per byte and reads the table directly:
//      the keyed shared-memory read IS the RAC on this card.  With
//      half_lut the index and sign decode as in lut_common.read_lut:
//      idx = msb ? key - 2^(mu-1) : 2^(mu-1) - 1 - key, sign = +-1.
//      The 8 warps of a block split the chunk's bytes; partial sums are
//      scaled by alpha_i per plane, z * sum(x) is added once, and the
//      warps are reduced through shared memory at the end.
// Bank layout: the table is [batch row][mu-group][entry].  All lanes of
// a warp read the same batch row and mu-group at the same time, so a
// warp touches at most 2^mu consecutive words: conflict-free by that
// loop order.  The reference's claim that any concurrent keyed reads are
// conflict-free (lut_gemm.py:10-14) does NOT hold on 32-bank shared
// memory in general; other loop orders would conflict.
// read_mode (select / onehot / gather) is a TPU lowering choice: the
// wrapper accepts it for parity and it does not change this kernel.
#include "common.cuh"

namespace {

constexpr int LM = 32;            // weight rows per block
constexpr int LK = 8;             // warps splitting a chunk's bytes
constexpr int LB = 8;             // batch rows per block
constexpr int LCH = 128;          // max chunk columns
constexpr int PSTRIDE = LCH / 8 + 4;
constexpr int NT = LM * LK;       // 256 threads

template <typename T>
__global__ void __launch_bounds__(NT) lut_gemm_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ alpha, const float* __restrict__ z,
    float* __restrict__ y, int B, int M, int N, int NB, int G, int q, int gs,
    int mu, int half, int ch) {
  __shared__ float xs[LB][LCH];
  __shared__ float xsum[LB];
  __shared__ uint8_t ps[8][LM][PSTRIDE];
  __shared__ float lut[LB * LCH * 4];
  __shared__ float red[LK][LB][LM];

  const int tid = threadIdx.x;
  const int r = tid % LM, kl = tid / LM;
  const int m0 = blockIdx.x * LM, b0 = blockIdx.y * LB;
  const int m = m0 + r;
  const int hsz = 1 << (mu - 1);
  const int P = half ? hsz : (1 << mu);
  const int U = ch / mu;
  const int per_byte = 8 / mu;
  const uint32_t kmask = (1u << mu) - 1u;
  const int nbc = ch / 8;
  const int K = NB * 8;

  float acc[LB];
#pragma unroll
  for (int bb = 0; bb < LB; ++bb) acc[bb] = 0.f;

  for (int k0 = 0; k0 < K; k0 += ch) {
    const int grp = k0 / gs;
    for (int i = tid; i < LB * ch; i += NT) {
      const int bb = i / ch, kk = i % ch;
      const int b = b0 + bb, k = k0 + kk;
      xs[bb][kk] = (b < B && k < N) ? to_f32(x[(size_t)b * N + k]) : 0.f;
    }
    for (int i = tid; i < q * LM * nbc; i += NT) {
      const int p = i / (LM * nbc), rem = i % (LM * nbc);
      const int rr = rem / nbc, c = rem % nbc;
      const int mm = m0 + rr;
      ps[p][rr][c] =
          (mm < M) ? packed[((size_t)p * M + mm) * NB + k0 / 8 + c] : 0;
    }
    __syncthreads();
    for (int i = tid; i < LB * U * P; i += NT) {
      const int bb = i / (U * P), rem = i % (U * P);
      const int u = rem / P, p = rem % P;
      const int pat = half ? p + hsz : p;
      float v = 0.f;
      for (int j = 0; j < mu; ++j) {
        const float xv = xs[bb][u * mu + j];
        v += ((pat >> j) & 1) ? xv : -xv;
      }
      lut[(bb * U + u) * P + p] = v;
    }
    if (tid < LB) {
      float s = 0.f;
      for (int kk = 0; kk < ch; ++kk) s += xs[tid][kk];
      xsum[tid] = s;
    }
    __syncthreads();
    if (m < M) {
      for (int p = 0; p < q; ++p) {
        float v[LB];
#pragma unroll
        for (int bb = 0; bb < LB; ++bb) v[bb] = 0.f;
        for (int c = kl; c < nbc; c += LK) {
          const uint32_t byte = ps[p][r][c];
          for (int s = 0; s < per_byte; ++s) {
            const int key = (byte >> (s * mu)) & kmask;
            const int u = c * per_byte + s;
            int idx = key;
            float sg = 1.f;
            if (half) {
              const bool msb = key >= hsz;
              idx = msb ? key - hsz : hsz - 1 - key;
              sg = msb ? 1.f : -1.f;
            }
            const float* e = lut + u * P + idx;
#pragma unroll
            for (int bb = 0; bb < LB; ++bb) v[bb] += sg * e[bb * U * P];
          }
        }
        const float a = alpha[((size_t)p * M + m) * G + grp];
#pragma unroll
        for (int bb = 0; bb < LB; ++bb) acc[bb] = fmaf(a, v[bb], acc[bb]);
      }
      if (kl == 0) {
        const float zz = z ? z[(size_t)m * G + grp] : 0.f;
#pragma unroll
        for (int bb = 0; bb < LB; ++bb) acc[bb] = fmaf(zz, xsum[bb], acc[bb]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int bb = 0; bb < LB; ++bb) red[kl][bb][r] = acc[bb];
  __syncthreads();
  {
    const int bb = tid / LM, rr = tid % LM;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < LK; ++k) s += red[k][bb][rr];
    const int b = b0 + bb, mm = m0 + rr;
    if (b < B && mm < M) y[(size_t)b * M + mm] = s;
  }
}

template <typename T>
void launch_t(const void* x, const void* packed, const void* alpha,
              const void* z, void* y, int B, int M, int N, int NB, int G,
              int q, int gs, int mu, int half, int ch, cudaStream_t s) {
  dim3 grid(ceil_div(M, LM), ceil_div(B, LB));
  lut_gemm_kernel<T><<<grid, NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(alpha), static_cast<const float*>(z),
      static_cast<float*>(y), B, M, N, NB, G, q, gs, mu, half, ch);
}

}  // namespace

extern "C" int launch_lut_gemm(const void* x, const void* packed,
                               const void* alpha, const void* z, void* y,
                               int B, int M, int N, int NB, int G, int q,
                               int gs, int x_is_bf16, int mu, int half,
                               int ch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q > 8 || (mu != 2 && mu != 4) || ch > LCH || ch % 8 || gs % ch)
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_is_bf16)
    launch_t<__nv_bfloat16>(x, packed, alpha, z, y, B, M, N, NB, G, q, gs, mu,
                            half, ch, s);
  else
    launch_t<float>(x, packed, alpha, z, y, B, M, N, NB, G, q, gs, mu, half,
                    ch, s);
  return static_cast<int>(cudaGetLastError());
}

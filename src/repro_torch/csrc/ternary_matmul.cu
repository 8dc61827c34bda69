// ternary_matmul: FIGLUT's LUT GEMM for ternary weights,
// y[B, M] = x . dequant(W)^T with W = alpha * sign * mask.
//
// Three routes, picked by the wrapper (kernels/ternary_matmul/ops.py
// route_for) and passed here as route: "gemv" (2), at most 8 rows of
// bf16 or f32 activations with group size 32, 64, 128 or 256 and
// in_features a multiple of 8, the tensor-core decode tile of
// bcq_decode.cu with its ternary flag (one {-1, 0, +1} operand decoded
// from the sign and mask words, see there); "mma" (1), more than 8 rows
// of bf16 or f32 activations with group size a multiple of 16 up to 256
// and in_features a multiple of 8, the tensor-core tile of bcq_mma.cu
// with the derived planes decoded in registers (f32 x split into three
// bf16 parts; see there); "lut" (0), the half-LUT body below, for every
// other call (group sizes that are 8 mod 16 or above 256 at any rows, 8,
// 16, 24 at decode rows, in_features not a multiple of 8).
//
// Replaces: src/repro/kernels/ternary_matmul/ternary_matmul.py
// ::_ternary_matmul_kernel (launcher ternary_matmul_tiled) with
// lut_common.ternary_plane_bytes, build_lut(half=True), extract_keys and
// read_lut.
//
// What bounds the LUT body on an H100: at decode it must stream the sign and mask
// planes (N/4 bytes per weight row) and one alpha row, so bytes bound it
// on paper.  In practice the keyed reads are the wall: every weight byte
// costs 2 planes x 2 keys table reads per batch row, one 4-byte
// shared-memory read each, so at 8 batch rows the shared-memory read
// rate (32 words per clock per SM) sets the time, several times the
// byte bound; at prefill it is the same wall scaled by the batch.
//
// What the design does about it:
//   * one block owns 32 weight rows (one per lane) and 8 batch rows and
//     walks its share of the reduction axis in chunks of 512 columns.
//     Where the (row, batch) tiles alone would leave SMs idle, the
//     chunks are split over several blocks (gridDim.y) that write
//     partial sums, and a second kernel adds them in a fixed order;
//   * per chunk each lane issues the loads of its row's 8 sign and 8
//     mask bytes first, then the block builds the half LUT in shared
//     memory: for every batch row and mu-group (mu = 4) the 8 signed sums
//     whose pattern has its MSB set (the hFFLUT symmetry LUT[p] =
//     -LUT[15 - p] gives the other 8), so the byte loads overlap the
//     build;
//   * the sign-decoding unit is two bitwise ops in registers:
//     b1 = sign | ~mask, b2 = sign & mask, then both derived planes read
//     the SAME table: idx = key >= 8 ? key - 8 : 7 - key, sign +-1;
//   * V1 + V2 is summed per alpha group and scaled once by alpha / 2;
//     ternary has no offset row, so there is no activation-sum term.
// Bank layout: the table is [batch row][mu-group][entry].  All lanes of
// a warp read the same batch row and mu-group at the same time, so a
// warp touches at most 8 consecutive words: conflict-free by that loop
// order.
// On exact inputs (integer activations, power-of-two alphas) every
// partial sum is an exact f32, so the result equals the plain version
// bit for bit whatever the order of the sums.
#include "bcq_decode.cuh"

namespace {

constexpr int TM = 32;               // weight rows per block (one per lane)
constexpr int TW = 8;                // warps, splitting a chunk's bytes
constexpr int TB = 8;                // batch rows per block
constexpr int KC = 512;              // chunk columns (one LUT build)
constexpr int HSZ = 8;               // half-LUT entries per mu-group
constexpr int U = KC / 4;            // mu-groups per chunk
constexpr int WBYTES = KC / 8 / TW;  // bytes per plane per lane per chunk
constexpr int NT = TM * TW;          // 256 threads

static_assert(WBYTES == 8, "a lane holds one 64-bit word per plane");

__device__ __forceinline__ uint64_t load_bytes(const uint8_t* row, int byte0,
                                               int NB, bool vec) {
  if (vec && byte0 + 8 <= NB)
    return *reinterpret_cast<const uint64_t*>(row + byte0);
  uint64_t v = 0;
  for (int i = 0; i < 8 && byte0 + i < NB; ++i)
    v |= static_cast<uint64_t>(row[byte0 + i]) << (8 * i);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(NT) ternary_matmul_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ alpha, float* __restrict__ out, int B, int M,
    int N, int NB, int G, int gs, int per) {
  __shared__ __align__(16) float lut[TB * U * HSZ];
  __shared__ float red[TW][TB][TM];

  const int tid = threadIdx.x;
  const int lane = tid % TM, w = tid / TM;
  const int m0 = blockIdx.x * TM, b0 = blockIdx.z * TB;
  const int split = blockIdx.y;
  const int m = m0 + lane;
  const int nchunks = (NB * 8 + KC - 1) / KC;
  const int c_end = min(nchunks, (split + 1) * per);
  const bool vec = (NB % 8) == 0;
  const uint8_t* sgn = packed + (size_t)m * NB;
  const uint8_t* msk = packed + ((size_t)M + m) * NB;
  const float* arow = alpha + (size_t)m * G;

  float acc[TB];
#pragma unroll
  for (int bb = 0; bb < TB; ++bb) acc[bb] = 0.f;

  for (int ck = split * per; ck < c_end; ++ck) {
    const int k0 = ck * KC;
    const int byte0 = k0 / 8 + w * WBYTES;
    uint64_t s64 = 0, m64 = 0;
    if (m < M) {
      s64 = load_bytes(sgn, byte0, NB, vec);
      m64 = load_bytes(msk, byte0, NB, vec);
    }
    for (int i = tid; i < TB * U; i += NT) {
      const int bb = i / U, u = i % U;
      const int b = b0 + bb;
      float xv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + u * 4 + j;
        xv[j] = (b < B && k < N) ? to_f32(x[(size_t)b * N + k]) : 0.f;
      }
      float e[HSZ];
#pragma unroll
      for (int p = 0; p < HSZ; ++p) {
        const int pat = p + HSZ;
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) v += ((pat >> j) & 1) ? xv[j] : -xv[j];
        e[p] = v;
      }
      float4* dst = reinterpret_cast<float4*>(lut + (size_t)i * HSZ);
      dst[0] = make_float4(e[0], e[1], e[2], e[3]);
      dst[1] = make_float4(e[4], e[5], e[6], e[7]);
    }
    __syncthreads();
    if (m < M) {
      const uint64_t b1 = s64 | ~m64, b2 = s64 & m64;
      float v[TB];
#pragma unroll
      for (int bb = 0; bb < TB; ++bb) v[bb] = 0.f;
      int cur = -1;
      for (int i = 0; i < WBYTES && byte0 + i < NB; ++i) {
        const int grp = (byte0 + i) * 8 / gs;
        if (grp != cur) {
          if (cur >= 0) {
            const float a = arow[cur] * 0.5f;
#pragma unroll
            for (int bb = 0; bb < TB; ++bb) {
              acc[bb] = fmaf(a, v[bb], acc[bb]);
              v[bb] = 0.f;
            }
          }
          cur = grp;
        }
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int sh = 8 * i + 4 * s;
          const int u = (w * WBYTES + i) * 2 + s;
          const int key1 = static_cast<int>((b1 >> sh) & 0xF);
          const int key2 = static_cast<int>((b2 >> sh) & 0xF);
          const int i1 = key1 >= HSZ ? key1 - HSZ : HSZ - 1 - key1;
          const int i2 = key2 >= HSZ ? key2 - HSZ : HSZ - 1 - key2;
          const float g1 = key1 >= HSZ ? 1.f : -1.f;
          const float g2 = key2 >= HSZ ? 1.f : -1.f;
          const float* e = lut + u * HSZ;
#pragma unroll
          for (int bb = 0; bb < TB; ++bb) {
            v[bb] += g1 * e[bb * U * HSZ + i1];
            v[bb] += g2 * e[bb * U * HSZ + i2];
          }
        }
      }
      if (cur >= 0) {
        const float a = arow[cur] * 0.5f;
#pragma unroll
        for (int bb = 0; bb < TB; ++bb) acc[bb] = fmaf(a, v[bb], acc[bb]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int bb = 0; bb < TB; ++bb) red[w][bb][lane] = acc[bb];
  __syncthreads();
  {
    const int bb = tid / TM, r = tid % TM;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < TW; ++k) s += red[k][bb][r];
    const int b = b0 + bb, mm = m0 + r;
    if (b < B && mm < M) out[((size_t)split * B + b) * M + mm] = s;
  }
}

template <typename T>
cudaError_t launch_t(const void* x, const void* packed, const void* alpha,
                     void* y, void* part, int B, int M, int N, int NB, int G,
                     int gs, int splits, cudaStream_t s) {
  const int nchunks = ceil_div(NB * 8, KC);
  const int per = ceil_div(nchunks, splits);
  dim3 grid(ceil_div(M, TM), splits, ceil_div(B, TB));
  float* out = static_cast<float*>(splits > 1 ? part : y);
  ternary_matmul_kernel<T><<<grid, NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(alpha), out, B, M, N, NB, G, gs, per);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return launch_sum_splits(static_cast<const float*>(part),
                           static_cast<float*>(y), splits, (size_t)B * M, s);
}

}  // namespace

// part: scratch f32 [splits, B, M] when splits > 1; sem: int32 counters,
// one per 64-row tile, all zero, for route 2 when splits > 1 (the last
// block of each tile sets its counter back to 0)
extern "C" int launch_ternary_matmul(const void* x, const void* packed,
                                     const void* alpha, void* y, void* part,
                                     void* sem, int B, int M, int N, int NB,
                                     int G, int gs, int x_is_bf16, int route,
                                     int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 2)
    return static_cast<int>(launch_bcq_decode(
        x, packed, alpha, nullptr, y, part, sem, B, M, N, NB, G, 2, gs,
        x_is_bf16 != 0, true, splits, s));
  if (route == 1) {
    if (B <= 8) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_bcq_mma(
        x, packed, alpha, nullptr, static_cast<float*>(y),
        static_cast<float*>(part), B, M, N, NB, G, 2, gs, splits, true,
        x_is_bf16 != 0, s));
  }
  if (route != 0 || gs % 8 || G * gs != NB * 8 || N > NB * 8 ||
      splits < 1 || splits > ceil_div(NB * 8, KC))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e =
      x_is_bf16 ? launch_t<__nv_bfloat16>(x, packed, alpha, y, part, B, M, N,
                                          NB, G, gs, splits, s)
                : launch_t<float>(x, packed, alpha, y, part, B, M, N, NB, G,
                                  gs, splits, s);
  return static_cast<int>(e);
}

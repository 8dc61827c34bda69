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
// Four bodies; the wrapper (kernels/bcq_matmul/ops.py, route_for)
// picks one by a documented rule and passes it as `route`:
//   route 1 "gemv"      B <= 8, bf16 or f32 activations, group size 32,
//                       64, 128 or 256, in_features a multiple of 8: the
//                       tensor-core decode tile (bcq_decode.cu; f32 x
//                       split there into three bf16 parts);
//   route 3 "gemv_fma"  B <= 8 otherwise (group sizes 8 mod 16, 16, 96
//                       and the like, in_features not a multiple of 8):
//                       the weight-streaming GEMV on the CUDA cores
//                       (bcq_gemv_kernel below), which keeps x in f32;
//   route 2 "mma"       B > 8, bf16 or f32 activations, group size a
//                       multiple of 16 up to 256, in_features a multiple
//                       of 8: the tensor-core BCQ tile of bcq_mma.cu, one
//                       bf16 mma.sync product per bit plane and alpha
//                       group against the +-1 plane decoded in registers
//                       (f32 x split there into three bf16 parts);
//   route 0 "mma_dq"    B > 8 otherwise (group size 8 mod 16 or above
//                       256, in_features not a multiple of 8): the
//                       dequantizing tensor-core tile of bcq_dq.cu, which
//                       builds W = sum_i alpha_i (+-1)_i + z in registers
//                       and runs it, split into two bf16 parts, against x
//                       (f32 x split there into bf16 parts).
// The weight is never written back dense, and ragged M / N / B edges
// are masked in-kernel instead of padded by a copy per call.
#include "bcq_decode.cuh"
#include "bcq_dq.cuh"

namespace {

// Route "gemv_fma" (B <= 8 where the decode tile does not apply): a
// weight-streaming GEMV.  Each warp owns GR
// weight rows; each lane takes 16 consecutive plane bytes (128 columns)
// of every row and plane per step, so a warp streams 512 contiguous
// bytes of each plane row with 16-byte loads, and all GR x Q of them are
// issued before any is used — enough bytes in flight per SM to keep
// the weight stream moving (a byte per lane per step, one load at a
// time, left the first version latency-bound at ~55 GB/s).  The planes
// are unpacked to +-1, scaled per group and offset in registers (the
// reference's order: plane sum, then z), and multiplied against the B
// activation rows read from global memory (L1/L2-resident).  Partial
// sums are reduced across the warp with shuffles.
constexpr int GR = 4;                 // weight rows per warp
constexpr int GW = 8;                 // warps per block
constexpr int GB = 8;                 // max batch rows
constexpr int GBYTES = 16;            // plane bytes per lane per step

__device__ __forceinline__ uint4 load_bytes16(const uint8_t* __restrict__ row,
                                              int c0, int NB, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(row + c0);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int j = 0; j < GBYTES && c0 + j < NB; ++j)
    w[j / 4] |= static_cast<uint32_t>(row[c0 + j]) << (8 * (j % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, int Q>
__global__ void __launch_bounds__(GW * 32) bcq_gemv_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ alpha, const float* __restrict__ z,
    float* __restrict__ y, int B, int M, int N, int NB, int G, int gs,
    bool pvec, bool xvec) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int m0 = (blockIdx.x * GW + warp) * GR;
  float acc[GR][GB];
#pragma unroll
  for (int r = 0; r < GR; ++r)
#pragma unroll
    for (int b = 0; b < GB; ++b) acc[r][b] = 0.f;

  for (int c0 = lane * GBYTES; c0 < NB; c0 += 32 * GBYTES) {
    uint32_t pk[GR][Q][4];
#pragma unroll
    for (int r = 0; r < GR; ++r)
#pragma unroll
      for (int p = 0; p < Q; ++p) {
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < M)
          u = load_bytes16(packed + ((size_t)p * M + m0 + r) * NB, c0, NB,
                           pvec);
        pk[r][p][0] = u.x; pk[r][p][1] = u.y;
        pk[r][p][2] = u.z; pk[r][p][3] = u.w;
      }
    // scale rows of the current group, reloaded only when a byte of this
    // step starts a new group (once per step when 128 | group_size)
    float aa[GR][Q], zr[GR];
    int cur = -1;
    // pk must be indexed by constants to stay in registers: the word
    // index jw is unrolled, the byte within the word (jb) is a shift
#pragma unroll
    for (int jw = 0; jw < GBYTES / 4; ++jw)
#pragma unroll 1
    for (int jb = 0; jb < 4; ++jb) {
      const int c = c0 + jw * 4 + jb;
      if (c >= NB) break;
      const int col = c * 8;
      const int grp = col / gs;
      if (grp != cur) {
        cur = grp;
#pragma unroll
        for (int r = 0; r < GR; ++r) {
          const int m = min(m0 + r, M - 1);
#pragma unroll
          for (int p = 0; p < Q; ++p)
            aa[r][p] = alpha[((size_t)p * M + m) * G + grp];
          zr[r] = z ? z[(size_t)m * G + grp] : 0.f;
        }
      }
      float w[GR][8];
#pragma unroll
      for (int r = 0; r < GR; ++r) {
#pragma unroll
        for (int e = 0; e < 8; ++e) w[r][e] = 0.f;
#pragma unroll
        for (int p = 0; p < Q; ++p) {
          const uint32_t byte = (pk[r][p][jw] >> (8 * jb)) & 0xffu;
          const float a = aa[r][p];
#pragma unroll
          for (int e = 0; e < 8; ++e) w[r][e] += ((byte >> e) & 1u) ? a : -a;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) w[r][e] += zr[r];
      }
#pragma unroll
      for (int b = 0; b < GB; ++b) {
        if (b >= B) break;
        float xv[8];
        load_x8<T>(x, (size_t)b * N + col, col, N, xvec, xv);
#pragma unroll
        for (int r = 0; r < GR; ++r) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) s = fmaf(w[r][e], xv[e], s);
          acc[r][b] += s;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < GR; ++r)
#pragma unroll
    for (int b = 0; b < GB; ++b) {
      float v = acc[r][b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[r][b] = v;
    }
  // GR * GB == 32: lane l writes row l / GB, batch row l % GB
  const int r = lane / GB, b = lane % GB;
  float v = 0.f;
#pragma unroll
  for (int rr = 0; rr < GR; ++rr)
#pragma unroll
    for (int bb = 0; bb < GB; ++bb)
      if (rr == r && bb == b) v = acc[rr][bb];
  if (m0 + r < M && b < B) y[(size_t)b * M + m0 + r] = v;
}

template <typename T, int Q>
void launch_gemv(const T* x, const uint8_t* packed, const float* alpha,
                 const float* z, float* y, int B, int M, int N, int NB, int G,
                 int gs, cudaStream_t s) {
  const bool pvec = NB % GBYTES == 0 &&
                    reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  const bool xvec = (N * sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  dim3 grid(ceil_div(M, GW * GR));
  bcq_gemv_kernel<T, Q><<<grid, GW * 32, 0, s>>>(x, packed, alpha, z, y, B, M,
                                                 N, NB, G, gs, pvec, xvec);
}

template <typename T>
void launch_gemv_t(const void* x, const void* packed, const void* alpha,
                   const void* z, void* y, int B, int M, int N, int NB, int G,
                   int q, int gs, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const uint8_t* pp = static_cast<const uint8_t*>(packed);
  const float* ap = static_cast<const float*>(alpha);
  const float* zp = static_cast<const float*>(z);
  float* yp = static_cast<float*>(y);
  switch (q) {
#define GEMV_CASE(QQ) \
  case QQ: launch_gemv<T, QQ>(xp, pp, ap, zp, yp, B, M, N, NB, G, gs, s); break;
    GEMV_CASE(1) GEMV_CASE(2) GEMV_CASE(3) GEMV_CASE(4)
    GEMV_CASE(5) GEMV_CASE(6) GEMV_CASE(7) GEMV_CASE(8)
#undef GEMV_CASE
  }
}

}  // namespace

// route: 0 mma_dq, 1 gemv, 2 mma, 3 gemv_fma (see the note at the top);
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
      if (B <= GB) return static_cast<int>(cudaErrorInvalidValue);
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
      if (B <= GB) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch_bcq_mma(
          x, packed, alpha, z, static_cast<float*>(y),
          static_cast<float*>(part), B, M, N, NB, G, q, gs, splits, false,
          x_is_bf16 != 0, s));
    case 3:
      if (B > GB) return static_cast<int>(cudaErrorInvalidValue);
      if (x_is_bf16)
        launch_gemv_t<__nv_bfloat16>(x, packed, alpha, z, y, B, M, N, NB, G,
                                     q, gs, s);
      else
        launch_gemv_t<float>(x, packed, alpha, z, y, B, M, N, NB, G, q, gs,
                             s);
      return static_cast<int>(cudaGetLastError());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// lut_gemm: FIGLUT's LUT-based FP-INT GEMM, y[B, M] = x . dequant(W)^T
//
// Replaces: src/repro/kernels/lut_gemm/lut_gemm.py::_lut_gemm_kernel
// (launcher lut_gemm_tiled) with the lut_common.py helpers sign_matrix,
// build_lut, extract_keys and read_lut.
//
// Three bodies; the wrapper (kernels/lut_gemm/ops.py, route_for) picks
// one by a documented rule and passes it as `route`:
//   route 1 "lut"      1-8 batch rows, mu 4 with the half table (the
//                      serve path's decode): lut_decode_kernel below;
//   route 2 "mma"      more than 8 rows of bf16 or f32 activations,
//                      group size a multiple of 16 up to 256,
//                      in_features a multiple of 8, any mu and table: the
//                      tensor-core BCQ tile of bcq_mma.cu (the keyed read
//                      re-associated into one product per bit plane,
//                      exact in bf16; f32 x split into three bf16 parts);
//   route 0 "lut_tile" everything else (decode rows at mu 2 or with the
//                      full table; above 8 rows, group sizes 8 mod 16 or
//                      above 256, in_features not a multiple of 8):
//                      lut_gemm_kernel below.
//
// What bounds it on an H100: at decode it is bound by bytes (the packed
// planes, alpha and z, as for bcq_matmul) on paper; in practice the keyed
// reads are shared-memory operations, each weight byte costing 8/mu
// table reads per batch row, so the shared-memory read rate is the wall
// (~0.054 ms at rows 8 on [16384 x 4096], q 3).  At prefill the same
// reads would cost ~3.5 ms, 35x torch.matmul, in any table layout; the
// mma route does the work on the tensor cores instead.
//
// lut_decode_kernel (route 1), after ternary_matmul.cu: one block of 16
// warps owns 64 weight rows (one a thread: two halves of 32 rows, 8 warps
// each) and walks its share of the reduction axis in chunks of 512
// columns, one table build each, shared by the 64 rows.  Per chunk each
// thread first issues the loads of its row's 8 bytes of every plane
// (64-bit words, straight into registers), then the block builds the
// half table in shared memory, so the loads overlap the build; each of
// a half's 8 warps then reads the keys of its 64 columns.  Per-group alpha is applied per
// plane as the group changes, and z times the sum of x once per group
// (the sums of each byte's 8 activations are built beside the table and
// read by all lanes of a warp at one address).  Where the row tiles
// alone would leave SMs idle, the chunks are split over gridDim.y and a
// fixed-order second pass adds the partial sums.
// Table layout: [mu-group u][batch half h][entry slot][4 batch rows], so
// a key's batch-row entries are BB/4 16-byte reads (one 4-, 8- or
// 16-byte read below 4 rows).  The 32 lanes of a warp read the same u and
// half at once and one 16-byte slot per entry: the 8 entries of one
// (u, h) are 128 contiguous bytes, all 32 banks once, so any mix of keys
// is conflict-free.  Entry e sits in slot e ^ ((u / 2) NH + h) mod 8, so
// the build's stores (one entry for every byte and half a warp covers)
// spread over 8 bank groups too; the entries are built by a butterfly
// of 14 adds per mu-group.
//
// lut_gemm_kernel (route 0): one block owns 32 weight rows (one per
// lane) and 8 batch rows, and walks the whole reduction axis in chunks
// of at most 128 columns that never straddle an alpha group.  Per chunk
// it
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
// wrapper accepts it for parity and it does not change these kernels.
#include "bcq_mma.cuh"

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


// ---- route 1: the decode body (1-8 batch rows, mu 4, half table) ----

constexpr int DM = 64;               // weight rows per block (one a thread)
constexpr int DW = 8;                // warps per 32 rows, splitting a
                                     // chunk's bytes
constexpr int DKC = 512;             // chunk columns (one table build)
constexpr int DU = DKC / 4;          // mu-groups per chunk
constexpr int DNB = DKC / 8;         // plane bytes per chunk row
constexpr int DBYTES = DNB / DW;     // bytes per plane per lane per chunk
constexpr int DHSZ = 8;              // half-table entries per mu-group
constexpr int DNT = DM * DW;         // 512 threads

static_assert(DBYTES == 8, "a lane holds one 64-bit word per plane");

// the table and byte-sum layouts for BB batch rows: QB rows per read
template <int BB>
struct Tab {
  static constexpr int QB = BB < 4 ? BB : 4;
  static constexpr int NH = BB / QB;
  // entry slot e of (u, h) is swizzled by f = ((u / 2) NH + h) mod 8: the
  // build's store of one entry for the 4 bytes x 2 halves a warp covers
  // (8 weight columns a byte) then hits 8 bank groups instead of one,
  // and a reader's 8 entries of one (u, h) stay one 128-byte run
  __device__ static int entry(int u, int e, int bb) {
    const int h = bb / QB;
    const int f = ((u >> 1) * NH + h) & (DHSZ - 1);
    return ((u * NH + h) * DHSZ + (e ^ f)) * QB + bb % QB;
  }
  __device__ static int bsum(int c, int bb) {
    return (c * NH + bb / QB) * QB + bb % QB;
  }
};

template <int QB>
__device__ __forceinline__ void lds(const float* p, float* v) {
  if constexpr (QB == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else if constexpr (QB == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x; v[1] = f.y;
  } else {
    v[0] = *p;
  }
}

__device__ __forceinline__ uint64_t load_bytes8(const uint8_t* row, int byte0,
                                                int NB, bool vec) {
  if (vec && byte0 + 8 <= NB)
    return *reinterpret_cast<const uint64_t*>(row + byte0);
  uint64_t v = 0;
  for (int i = 0; i < 8 && byte0 + i < NB; ++i)
    v |= static_cast<uint64_t>(row[byte0 + i]) << (8 * i);
  return v;
}

template <typename T, int BB>
__global__ void __launch_bounds__(DNT) lut_decode_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ alpha, const float* __restrict__ z,
    float* __restrict__ out, int B, int M, int N, int NB, int G, int q,
    int gs, int per, bool pvec, bool xvec) {
  using L = Tab<BB>;
  constexpr int QB = L::QB, NH = L::NH;
  __shared__ __align__(16) float lut[DU * DHSZ * BB];
  __shared__ __align__(16) float bsum[DNB * BB];
  const int tid = threadIdx.x;
  // warp w of row half rh: rows m0 + 32 rh + lane, bytes w * DBYTES ..
  const int lane = tid % 32, w = (tid / 32) % DW, rh = tid / (32 * DW);
  const int m0 = blockIdx.x * DM, split = blockIdx.y;
  const int m = m0 + 32 * rh + lane;
  const int nchunks = (NB * 8 + DKC - 1) / DKC;
  const int c_end = min(nchunks, (split + 1) * per);

  float acc[BB];
#pragma unroll
  for (int bb = 0; bb < BB; ++bb) acc[bb] = 0.f;

  for (int ck = split * per; ck < c_end; ++ck) {
    const int k0 = ck * DKC;
    const int byte0 = k0 / 8 + w * DBYTES;
    uint64_t pk[8];
#pragma unroll
    for (int p = 0; p < 8; ++p)
      pk[p] = (p < q && m < M)
                  ? load_bytes8(packed + ((size_t)p * M + m) * NB, byte0, NB,
                                pvec)
                  : 0;
    // the half table of every mu-group and batch row (entries e = 0..7:
    // patterns e + 8, the MSB set) and the sum of each byte's activations
    for (int i = tid; i < DNB * BB; i += DNT) {
      const int c = i / BB, bb = i % BB;
      const int col = k0 + c * 8;
      float xv[8];
      if (bb < B) {
        load_x8<T>(x, (size_t)bb * N + col, col, N, xvec, xv);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) xv[e] = 0.f;
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        // entry e = x3 + (+-x2) + (+-x1) + (+-x0), bit j of e choosing
        // +x_j, by a butterfly: 2 + 4 + 8 adds for the 8 entries
        const float* v = xv + 4 * s;
        float t2[2], t1[4], t0[8];
        t2[0] = v[3] - v[2];
        t2[1] = v[3] + v[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          t1[2 * k] = t2[k] - v[1];
          t1[2 * k + 1] = t2[k] + v[1];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          t0[2 * k] = t1[k] - v[0];
          t0[2 * k + 1] = t1[k] + v[0];
        }
        // t0[k] has x2 from bit 2, x1 from bit 1, x0 from bit 0 of k
#pragma unroll
        for (int e = 0; e < DHSZ; ++e) lut[L::entry(2 * c + s, e, bb)] = t0[e];
      }
      float t = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) t += xv[e];
      bsum[L::bsum(c, bb)] = t;
    }
    __syncthreads();
    if (m < M) {
      const int c0 = w * DBYTES;                 // first byte in the chunk
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        if (p >= q) break;
        float v[BB];
#pragma unroll
        for (int bb = 0; bb < BB; ++bb) v[bb] = 0.f;
        int cur = -1;
#pragma unroll 1
        for (int i = 0; i < DBYTES && byte0 + i < NB; ++i) {
          const int grp = (byte0 + i) * 8 / gs;
          if (grp != cur) {
            if (cur >= 0) {
              const float a = alpha[((size_t)p * M + m) * G + cur];
#pragma unroll
              for (int bb = 0; bb < BB; ++bb) {
                acc[bb] = fmaf(a, v[bb], acc[bb]);
                v[bb] = 0.f;
              }
            }
            cur = grp;
          }
          const uint32_t byte = static_cast<uint32_t>(pk[p] >> (8 * i)) & 0xffu;
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int key = (byte >> (4 * s)) & 0xF;
            const int idx = key >= DHSZ ? key - DHSZ : DHSZ - 1 - key;
            const float sg = key >= DHSZ ? 1.f : -1.f;
            const int u = 2 * (c0 + i) + s;
#pragma unroll
            for (int h = 0; h < NH; ++h) {
              float e[QB];
              lds<QB>(lut + L::entry(u, idx, h * QB), e);
#pragma unroll
              for (int j = 0; j < QB; ++j)
                v[h * QB + j] = fmaf(sg, e[j], v[h * QB + j]);
            }
          }
        }
        if (cur >= 0) {
          const float a = alpha[((size_t)p * M + m) * G + cur];
#pragma unroll
          for (int bb = 0; bb < BB; ++bb) acc[bb] = fmaf(a, v[bb], acc[bb]);
        }
      }
      if (z) {
        // z[m, g] times the sum of this lane's activations of group g
        float v[BB];
#pragma unroll
        for (int bb = 0; bb < BB; ++bb) v[bb] = 0.f;
        int cur = -1;
#pragma unroll 1
        for (int i = 0; i < DBYTES && byte0 + i < NB; ++i) {
          const int grp = (byte0 + i) * 8 / gs;
          if (grp != cur) {
            if (cur >= 0) {
              const float zz = z[(size_t)m * G + cur];
#pragma unroll
              for (int bb = 0; bb < BB; ++bb) {
                acc[bb] = fmaf(zz, v[bb], acc[bb]);
                v[bb] = 0.f;
              }
            }
            cur = grp;
          }
#pragma unroll
          for (int h = 0; h < NH; ++h) {
            float e[QB];
            lds<QB>(bsum + L::bsum(c0 + i, h * QB), e);
#pragma unroll
            for (int j = 0; j < QB; ++j) v[h * QB + j] += e[j];
          }
        }
        if (cur >= 0) {
          const float zz = z[(size_t)m * G + cur];
#pragma unroll
          for (int bb = 0; bb < BB; ++bb) acc[bb] = fmaf(zz, v[bb], acc[bb]);
        }
      }
    }
    __syncthreads();
  }
  // the warps' partial sums, through shared memory (the table's, free
  // after the last chunk's barrier)
  float(*red)[BB][DM] = reinterpret_cast<float(*)[BB][DM]>(lut);
  static_assert(DW * BB * DM <= DU * DHSZ * BB, "red fits in the table");
#pragma unroll
  for (int bb = 0; bb < BB; ++bb) red[w][bb][32 * rh + lane] = acc[bb];
  __syncthreads();
  if (tid < BB * DM) {
    const int bb = tid / DM, r = tid % DM;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < DW; ++k) s += red[k][bb][r];
    const int mm = m0 + r;
    if (bb < B && mm < M) out[((size_t)split * B + bb) * M + mm] = s;
  }
}

template <typename T, int BB>
cudaError_t launch_decode_bb(const void* x, const void* packed,
                             const void* alpha, const void* z, float* out,
                             int B, int M, int N, int NB, int G, int q,
                             int gs, int per, int splits, cudaStream_t s) {
  const bool pvec = NB % 8 == 0 && reinterpret_cast<uintptr_t>(packed) % 8 == 0;
  const bool xvec = (N * sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  dim3 grid(ceil_div(M, DM), splits);
  lut_decode_kernel<T, BB><<<grid, DNT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(alpha), static_cast<const float*>(z), out, B,
      M, N, NB, G, q, gs, per, pvec, xvec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_decode(const void* x, const void* packed, const void* alpha,
                          const void* z, float* y, float* part, int B, int M,
                          int N, int NB, int G, int q, int gs, int splits,
                          cudaStream_t s) {
  const int nchunks = ceil_div(NB * 8, DKC);
  if (splits < 1 || splits > nchunks || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const int per = ceil_div(nchunks, splits);
  if (ceil_div(nchunks, per) != splits) return cudaErrorInvalidValue;
  float* out = splits > 1 ? part : y;
  cudaError_t e;
  if (B <= 1)
    e = launch_decode_bb<T, 1>(x, packed, alpha, z, out, B, M, N, NB, G, q,
                               gs, per, splits, s);
  else if (B <= 2)
    e = launch_decode_bb<T, 2>(x, packed, alpha, z, out, B, M, N, NB, G, q,
                               gs, per, splits, s);
  else if (B <= 4)
    e = launch_decode_bb<T, 4>(x, packed, alpha, z, out, B, M, N, NB, G, q,
                               gs, per, splits, s);
  else
    e = launch_decode_bb<T, 8>(x, packed, alpha, z, out, B, M, N, NB, G, q,
                               gs, per, splits, s);
  if (e != cudaSuccess || splits == 1) return e;
  return launch_sum_splits(part, y, splits, (size_t)B * M, s);
}

template <typename T>
cudaError_t launch_tile(const void* x, const void* packed, const void* alpha,
                        const void* z, void* y, int B, int M, int N, int NB,
                        int G, int q, int gs, int mu, int half, int ch,
                        cudaStream_t s) {
  dim3 grid(ceil_div(M, LM), ceil_div(B, LB));
  lut_gemm_kernel<T><<<grid, NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(alpha), static_cast<const float*>(z),
      static_cast<float*>(y), B, M, N, NB, G, q, gs, mu, half, ch);
  return cudaGetLastError();
}

}  // namespace

// route: 0 lut_tile, 1 lut (decode), 2 mma (see the note at the top);
// part: scratch f32 [splits, B, M] for routes 1 and 2 when splits > 1
extern "C" int launch_lut_gemm(const void* x, const void* packed,
                               const void* alpha, const void* z, void* y,
                               void* part, int B, int M, int N, int NB, int G,
                               int q, int gs, int x_is_bf16, int mu, int half,
                               int ch, int route, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* yf = static_cast<float*>(y);
  float* pf = static_cast<float*>(part);
  if (q < 1 || q > 8 || (mu != 2 && mu != 4) || gs % 8 || G * gs != NB * 8 ||
      N > NB * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (route) {
    case 0:
      if (ch > LCH || ch % 8 || gs % ch)
        return static_cast<int>(cudaErrorInvalidValue);
      e = x_is_bf16 ? launch_tile<__nv_bfloat16>(x, packed, alpha, z, y, B, M,
                                                 N, NB, G, q, gs, mu, half,
                                                 ch, s)
                    : launch_tile<float>(x, packed, alpha, z, y, B, M, N, NB,
                                         G, q, gs, mu, half, ch, s);
      break;
    case 1:
      if (B > 8 || mu != 4 || !half)
        return static_cast<int>(cudaErrorInvalidValue);
      e = x_is_bf16 ? launch_decode<__nv_bfloat16>(x, packed, alpha, z, yf,
                                                   pf, B, M, N, NB, G, q, gs,
                                                   splits, s)
                    : launch_decode<float>(x, packed, alpha, z, yf, pf, B, M,
                                           N, NB, G, q, gs, splits, s);
      break;
    case 2:
      if (B <= 8) return static_cast<int>(cudaErrorInvalidValue);
      e = launch_bcq_mma(x, packed, alpha, z, yf, pf, B, M, N, NB, G, q, gs,
                         splits, false, x_is_bf16 != 0, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

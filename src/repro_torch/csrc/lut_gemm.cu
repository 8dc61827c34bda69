// lut_gemm: FIGLUT's LUT-based FP-INT GEMM, y[B, M] = x . dequant(W)^T
//
// Replaces: src/repro/kernels/lut_gemm/lut_gemm.py::_lut_gemm_kernel
// (launcher lut_gemm_tiled) with the lut_common.py helpers sign_matrix,
// build_lut, extract_keys and read_lut.
//
// Three bodies; the wrapper (kernels/lut_gemm/ops.py, route_for) picks
// one by a documented rule and passes it as `route`:
//   route 1 "lut"      1-8 batch rows, at mu 2 or 4 with the half or the
//                      full table (the serve path's decode is mu 4, half
//                      table; the others are the paper's LUT-size and
//                      hFFLUT ablations): lut_decode_kernel below;
//   route 2 "mma"      more than 8 rows of bf16 or f32 activations,
//                      group size a multiple of 16 up to 256,
//                      in_features a multiple of 8, any mu and table: the
//                      tensor-core BCQ tile of bcq_mma.cu (the keyed read
//                      re-associated into one product per bit plane,
//                      exact in bf16; f32 x split into three bf16 parts);
//   route 0 "mma_dq"   every other call above 8 rows (group sizes 8 mod
//                      16 or above 256, in_features not a multiple of 8),
//                      any mu and table: the dequantizing tensor-core
//                      tile of bcq_dq.cu (the keyed read re-associated as
//                      on route 2, W built in registers).
//
// What bounds it on an H100: at decode it is bound by bytes (the packed
// planes, alpha and z, as for bcq_matmul) on paper; in practice the keyed
// reads are shared-memory operations, each weight byte costing 8/mu
// table reads per batch row, so the shared-memory read rate is the wall
// (~0.054 ms at rows 8 on [16384 x 4096], q 3, mu 4; twice that at mu
// 2).  At prefill the same reads would cost ~3.5 ms, 35x torch.matmul,
// in any table layout; routes 2 and 0 do the work on the tensor cores.
//
// lut_decode_kernel (route 1), after ternary_matmul.cu: one block of 16
// warps owns 64 weight rows (one a thread: two halves of 32 rows, 8 warps
// each) and walks its share of the reduction axis in chunks of 512
// columns, one table build each, shared by the 64 rows.  Per chunk each
// thread first issues the loads of its row's 8 bytes of every plane
// (64-bit words, straight into registers), then the block builds the
// table in shared memory, so the loads overlap the build; each of a
// half's 8 warps then reads the keys of its 64 columns: 8/mu keys a byte
// (2 at mu 4, 4 at mu 2), each a keyed read of its mu-group's entry for
// every batch row.  Per-group alpha is applied per plane as the group
// changes, and z times the sum of x once per group (the sums of each
// byte's 8 activations are built beside the table and read by all lanes
// of a warp at one address).  Where the row tiles alone would leave SMs
// idle, the chunks are split over gridDim.y and a fixed-order second
// pass adds the partial sums.
// Table: E entries a mu-group (the half table 2^(mu-1): the patterns
// with the MSB set; the full table 2^mu), each entry the signed sum of
// the group's mu activations, built by a butterfly from the top bit down
// (2 + 4 + 8 adds for mu 4's half table).  Layout: [mu-group u][batch
// part h][entry slot][QB batch rows], so a key's batch-row entries are
// BB/QB reads of QB floats.  The 32 lanes of a warp read the same u and
// h at once and one slot per entry: QB is 4 (16-byte slots) where E <= 8
// and 2 (8-byte slots) where E = 16, so the E entries of one (u, h) are
// one run of at most 128 contiguous bytes, each slot in its own banks,
// and any mix of keys is conflict-free.  Entry e sits in slot e ^ ((c
// NH + h) mod E), c = u / (8 / mu) the byte the group comes from, so the
// build's stores (one entry for every byte and batch part a warp covers)
// spread over E slots too.  With the half table a key's read is
// sign-decoded as lut_common.read_lut does (idx = msb ? key - 2^(mu-1)
// : 2^(mu-1) - 1 - key, sign +-1); with the full table the key is the
// slot and needs no decode.
// read_mode (select / onehot / gather) is a TPU lowering choice: the
// wrapper accepts it for parity and it does not change these kernels.
#include "bcq_dq.cuh"

namespace {

constexpr int DM = 64;               // weight rows per block (one a thread)
constexpr int DW = 8;                // warps per 32 rows, splitting a
                                     // chunk's bytes
constexpr int DKC = 512;             // chunk columns (one table build)
constexpr int DNB = DKC / 8;         // plane bytes per chunk row
constexpr int DBYTES = DNB / DW;     // bytes per plane per lane per chunk
constexpr int DNT = DM * DW;         // 512 threads

static_assert(DBYTES == 8, "a lane holds one 64-bit word per plane");

// the table and byte-sum layouts at mu MU, the half (HALF) or full table,
// for BB batch rows: QB rows per read
template <int MU, bool HALF, int BB>
struct Tab {
  static constexpr int KPB = 8 / MU;                   // keys a byte
  static constexpr int DU = DKC / MU;                  // mu-groups a chunk
  static constexpr int E = HALF ? 1 << (MU - 1) : 1 << MU;  // entries
  static constexpr int QMAX = E == 16 ? 2 : 4;
  static constexpr int QB = BB < QMAX ? BB : QMAX;
  static constexpr int NH = BB / QB;
  static constexpr int FLOATS = DU * E * BB;           // the table
  // entry slot e of (u, h) is swizzled by f = ((u / KPB) NH + h) mod E:
  // the build's store of one entry for the bytes x batch parts a warp
  // covers then spreads over E slots instead of one, and a reader's E
  // entries of one (u, h) stay one run
  __device__ static int entry(int u, int e, int bb) {
    const int h = bb / QB;
    const int f = ((u / KPB) * NH + h) & (E - 1);
    return ((u * NH + h) * E + (e ^ f)) * QB + bb % QB;
  }
  __device__ static int bsum(int c, int bb) {
    return FLOATS + (c * NH + bb / QB) * QB + bb % QB;
  }
};

// the E entries of one mu-group of activations v[0 .. MU): entry k is
// sum_j (bit j of (k, with the MSB set for the half table) ? v_j : -v_j),
// doubled from the top bit down
template <int MU, bool HALF>
__device__ __forceinline__ void build_entries(
    const float* v, float (&t)[HALF ? 1 << (MU - 1) : 1 << MU]) {
  t[0] = HALF ? v[MU - 1] : -v[MU - 1];
  if constexpr (!HALF) t[1] = v[MU - 1];
#pragma unroll
  for (int j = MU - 2; j >= 0; --j) {
    // the entries so far (bits MU - 1 .. j + 1) each split on bit j
    const int n = (HALF ? 1 : 2) << (MU - 2 - j);
#pragma unroll
    for (int k = n - 1; k >= 0; --k) {
      const float a = t[k];
      t[2 * k + 1] = a + v[j];
      t[2 * k] = a - v[j];
    }
  }
}

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

template <typename T, int MU, bool HALF, int BB>
__global__ void __launch_bounds__(DNT, 2) lut_decode_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ alpha, const float* __restrict__ z,
    float* __restrict__ out, int B, int M, int N, int NB, int G, int q,
    int gs, int per, bool pvec, bool xvec) {
  using L = Tab<MU, HALF, BB>;
  constexpr int QB = L::QB, NH = L::NH, E = L::E, KPB = L::KPB;
  constexpr int HSZ = 1 << (MU - 1);
  extern __shared__ __align__(16) float lut[];  // the table, then bsum
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
    // the table of every mu-group and batch row and the sum of each
    // byte's activations
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
      for (int s = 0; s < KPB; ++s) {
        float t[E];
        build_entries<MU, HALF>(xv + MU * s, t);
#pragma unroll
        for (int e = 0; e < E; ++e) lut[L::entry(KPB * c + s, e, bb)] = t[e];
      }
      float t = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) t += xv[e];
      lut[L::bsum(c, bb)] = t;
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
          for (int s = 0; s < KPB; ++s) {
            const int key = (byte >> (MU * s)) & ((1 << MU) - 1);
            const int u = KPB * (c0 + i) + s;
            if constexpr (HALF) {
              const int idx = key >= HSZ ? key - HSZ : HSZ - 1 - key;
              const float sg = key >= HSZ ? 1.f : -1.f;
#pragma unroll
              for (int h = 0; h < NH; ++h) {
                float e[QB];
                lds<QB>(lut + L::entry(u, idx, h * QB), e);
#pragma unroll
                for (int j = 0; j < QB; ++j)
                  v[h * QB + j] = fmaf(sg, e[j], v[h * QB + j]);
              }
            } else {
#pragma unroll
              for (int h = 0; h < NH; ++h) {
                float e[QB];
                lds<QB>(lut + L::entry(u, key, h * QB), e);
#pragma unroll
                for (int j = 0; j < QB; ++j) v[h * QB + j] += e[j];
              }
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
            lds<QB>(lut + L::bsum(c0 + i, h * QB), e);
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
  static_assert(DW * BB * DM <= L::FLOATS, "red fits in the table");
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

template <typename T, int MU, bool HALF, int BB>
cudaError_t launch_decode_bb(const void* x, const void* packed,
                             const void* alpha, const void* z, float* out,
                             int B, int M, int N, int NB, int G, int q,
                             int gs, int per, int splits, cudaStream_t s) {
  using L = Tab<MU, HALF, BB>;
  auto kernel = lut_decode_kernel<T, MU, HALF, BB>;
  constexpr int smem = (L::FLOATS + DNB * BB) * 4;
  if constexpr (smem > 48 * 1024) {
    // the shared-memory opt-in, once per device
    static unsigned ready = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= 32) return cudaErrorInvalidDevice;
    if (!(ready >> dev & 1u)) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      ready |= 1u << dev;
    }
  }
  const bool pvec = NB % 8 == 0 && reinterpret_cast<uintptr_t>(packed) % 8 == 0;
  const bool xvec = (N * sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  dim3 grid(ceil_div(M, DM), splits);
  kernel<<<grid, DNT, smem, s>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(alpha), static_cast<const float*>(z), out, B,
      M, N, NB, G, q, gs, per, pvec, xvec);
  return cudaGetLastError();
}

template <typename T, int MU, bool HALF>
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
    e = launch_decode_bb<T, MU, HALF, 1>(x, packed, alpha, z, out, B, M, N,
                                         NB, G, q, gs, per, splits, s);
  else if (B <= 2)
    e = launch_decode_bb<T, MU, HALF, 2>(x, packed, alpha, z, out, B, M, N,
                                         NB, G, q, gs, per, splits, s);
  else if (B <= 4)
    e = launch_decode_bb<T, MU, HALF, 4>(x, packed, alpha, z, out, B, M, N,
                                         NB, G, q, gs, per, splits, s);
  else
    e = launch_decode_bb<T, MU, HALF, 8>(x, packed, alpha, z, out, B, M, N,
                                         NB, G, q, gs, per, splits, s);
  if (e != cudaSuccess || splits == 1) return e;
  return launch_sum_splits(part, y, splits, (size_t)B * M, s);
}

template <typename T>
cudaError_t launch_decode_t(const void* x, const void* packed,
                            const void* alpha, const void* z, float* y,
                            float* part, int B, int M, int N, int NB, int G,
                            int q, int gs, int mu, bool half, int splits,
                            cudaStream_t s) {
  if (mu == 4)
    return half ? launch_decode<T, 4, true>(x, packed, alpha, z, y, part, B,
                                            M, N, NB, G, q, gs, splits, s)
                : launch_decode<T, 4, false>(x, packed, alpha, z, y, part, B,
                                             M, N, NB, G, q, gs, splits, s);
  return half ? launch_decode<T, 2, true>(x, packed, alpha, z, y, part, B, M,
                                          N, NB, G, q, gs, splits, s)
              : launch_decode<T, 2, false>(x, packed, alpha, z, y, part, B, M,
                                           N, NB, G, q, gs, splits, s);
}

}  // namespace

// route: 0 mma_dq, 1 lut (decode), 2 mma (see the note at the top);
// part: scratch f32 [splits, B, M] when splits > 1
extern "C" int launch_lut_gemm(const void* x, const void* packed,
                               const void* alpha, const void* z, void* y,
                               void* part, int B, int M, int N, int NB, int G,
                               int q, int gs, int x_is_bf16, int mu, int half,
                               int route, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* yf = static_cast<float*>(y);
  float* pf = static_cast<float*>(part);
  if (q < 1 || q > 8 || (mu != 2 && mu != 4) || gs % 8 || G * gs != NB * 8 ||
      N > NB * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (route) {
    case 0:
      e = launch_bcq_dq(x, packed, alpha, z, yf, pf, B, M, N, NB, G, q, gs,
                        splits, false, x_is_bf16 != 0, s);
      break;
    case 1:
      if (B > 8) return static_cast<int>(cudaErrorInvalidValue);
      e = x_is_bf16 ? launch_decode_t<__nv_bfloat16>(x, packed, alpha, z, yf,
                                                     pf, B, M, N, NB, G, q,
                                                     gs, mu, half != 0,
                                                     splits, s)
                    : launch_decode_t<float>(x, packed, alpha, z, yf, pf, B,
                                             M, N, NB, G, q, gs, mu,
                                             half != 0, splits, s);
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

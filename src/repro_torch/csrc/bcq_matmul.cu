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
//   route 1 "gemv"      B <= 8, bf16 activations, group size 32, 64, 128
//                       or 256, in_features a multiple of 8: the
//                       tensor-core decode tile (bcq_decode_kernel
//                       below);
//   route 3 "gemv_fma"  B <= 8 otherwise (f32 activations, such as
//                       MiniCPM3's f32 view and the tests): the
//                       weight-streaming GEMV on the CUDA cores
//                       (bcq_gemv_kernel below), which keeps x in f32;
//   route 2 "mma"       B > 8, bf16 activations, group size a multiple of
//                       16: the tensor-core BCQ tile of bcq_mma.cu, one
//                       bf16 mma.sync product per bit plane and alpha
//                       group against the +-1 plane decoded in registers;
//   route 0 "fma"       B > 8 otherwise (f32 activations, group size 8
//                       mod 16): bcq_matmul_kernel below.  Each block
//                       owns a 64-row slice of M and a tile of B rows,
//                       and walks the whole reduction axis itself (CUDA
//                       blocks run in no order, so nothing is carried
//                       between blocks the way the Pallas grid revisits
//                       its output block).  Per 64-column step it stages
//                       the x tile in shared memory, unpacks the
//                       LSB-first plane bytes to +-1, applies alpha per
//                       group and z, stages that f32 weight tile in
//                       shared memory (row stride 65 floats, so the 32
//                       lanes reading one column hit 32 banks) and
//                       accumulates in f32 registers with FMAs.
// The weight is never written back dense, and ragged M / N / B edges
// are masked in-kernel instead of padded by a copy per call.
#include "bcq_mma.cuh"

namespace {

constexpr int BM = 64;   // weight rows per block
constexpr int BK = 64;   // reduction columns per step
constexpr int NT = 256;  // threads per block

template <typename T, int TB, int TX>
__global__ void __launch_bounds__(NT) bcq_matmul_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ alpha, const float* __restrict__ z,
    float* __restrict__ y, int B, int M, int N, int NB, int G, int q,
    int gs) {
  constexpr int TY = NT / TX;
  constexpr int RB = TB / TY;  // batch rows per thread
  constexpr int RM = BM / TX;  // weight rows per thread
  __shared__ float xs[TB][BK];
  __shared__ float ws[BM][BK + 1];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.x * BM, b0 = blockIdx.y * TB;
  const int K = NB * 8;
  float acc[RB][RM];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < RM; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < TB * BK; i += NT) {
      const int bb = i / BK, kk = i % BK;
      const int b = b0 + bb, k = k0 + kk;
      xs[bb][kk] = (b < B && k < N) ? to_f32(x[(size_t)b * N + k]) : 0.f;
    }
    for (int i = tid; i < BM * (BK / 8); i += NT) {
      const int mm = i / (BK / 8), jb = i % (BK / 8);
      const int m = m0 + mm, col = k0 / 8 + jb;
      float w[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) w[e] = 0.f;
      if (m < M && col < NB) {
        const int grp = (col * 8) / gs;
        for (int p = 0; p < q; ++p) {
          const uint32_t byte = packed[((size_t)p * M + m) * NB + col];
          const float a = alpha[((size_t)p * M + m) * G + grp];
#pragma unroll
          for (int e = 0; e < 8; ++e) w[e] += ((byte >> e) & 1u) ? a : -a;
        }
        const float zz = z ? z[(size_t)m * G + grp] : 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) w[e] += zz;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) ws[mm][jb * 8 + e] = w[e];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float xv[RB], wv[RM];
#pragma unroll
      for (int r = 0; r < RB; ++r) xv[r] = xs[ty * RB + r][kk];
#pragma unroll
      for (int j = 0; j < RM; ++j) wv[j] = ws[tx + TX * j][kk];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int j = 0; j < RM; ++j) acc[r][j] = fmaf(xv[r], wv[j], acc[r][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int b = b0 + ty * RB + r;
#pragma unroll
    for (int j = 0; j < RM; ++j) {
      const int m = m0 + tx + TX * j;
      if (b < B && m < M) y[(size_t)b * M + m] = acc[r][j];
    }
  }
}

// Route "gemv_fma" (B <= 8 where the decode tile does not apply, f32
// activations above all): a weight-streaming GEMV.  Each warp owns GR
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

template <typename T>
void launch_fma_t(const void* x, const void* packed, const void* alpha,
                  const void* z, void* y, int B, int M, int N, int NB, int G,
                  int q, int gs, cudaStream_t s) {
  dim3 grid(ceil_div(M, BM), ceil_div(B, 32));
  bcq_matmul_kernel<T, 32, 16><<<grid, NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(alpha), static_cast<const float*>(z),
      static_cast<float*>(y), B, M, N, NB, G, q, gs);
}


// Route "gemv": the tensor-core decode tile (B <= 8, bf16 activations).
//
// At 8 rows the CUDA-core GEMV above is bound by issue, not bytes: it
// unpacks every bit to +-alpha, adds z, loads 8 activations per batch row
// and plane byte and runs 8 FMAs per batch row, all scalar f32.  This
// body hands that work to the tensor cores with the operand layout of
// the prefill tile (bcq_mma.cu) turned around: the batch goes on the N
// side of mma.sync.m16n8k16 (a decode step has at most 8 rows, exactly
// n8), 16 weight rows on the M side.
//  - a block of 4 warps owns 64 weight rows and a range of the reduction
//    axis (all of it, or one split's share of 256-column steps); each
//    warp owns 16 weight rows;
//  - per 256-column step a cp.async ring of DT_STAGES stages brings the
//    step's x tile (8 rows, rows past B zero-filled; rows padded by 16
//    bytes so the 8 row addresses of an ldmatrix fall in 8 distinct
//    16-byte bank groups) and its plane bytes (q x 64 rows x 32 bytes:
//    whole 32-byte sectors, in 16-byte copies); alpha and z ride along
//    SG groups at a time;
//  - the weight operand (A: 16 rows x k16) is decoded in registers from
//    the plane words with the prefill tile's decode_pm1_at; the x
//    operand (B: k16 x 8 batch rows) comes by one ldmatrix.x4 per two
//    k16 steps, shared by all planes;
//  - per plane and alpha group one f32 fragment takes gs/16 mmas and is
//    folded into the accumulator with its alpha; the z term is z times
//    the group's sum of x, which the same x fragments give against an
//    all-ones A operand (one more mma per k16 step);
//  - where the row tiles alone would leave SMs idle (gemv_splits in
//    ops.py), the steps are split over gridDim.y; each split writes its
//    partial [B, 64] slice, and the last block of the row tile to finish
//    (a counter per tile, set back to 0 by that block) adds the partials
//    in split order: the result does not depend on which blocks ran when,
//    no float atomics, and no second launch.
// x and +-1 are exact in bf16 and every product is exact in f32, so only
// the f32 summation order differs from bcq_planes_ref.
// Measured on an H100 at [16384 x 4096], rows 8, it runs at ~5x its byte
// bound, and rows 1 cost the same as rows 8.  Scratch builds with the
// arithmetic removed and with the copies removed each kept most of the
// time, so the copy pipeline and the decode's integer instructions (an
// and, a multiply and a lop3 per +-1 pair) both hold it.  Wider steps,
// 128-row blocks, more or fewer stages, one accumulator chain per k16
// step and 16-byte alpha copies measured no faster.
constexpr int DT_ROWS = 64;             // weight rows per block
constexpr int DT_NT = 128;              // 4 warps, 16 weight rows each
constexpr int DT_STEP = 256;            // reduction columns per stage
constexpr int DT_PB = DT_STEP / 8;      // plane bytes per row per stage
constexpr int DT_XS = DT_STEP * 2 + 16;  // bytes per staged x row
constexpr int DT_STAGES = 4;
constexpr int DT_X_BYTES = GB * DT_XS;
constexpr int DT_MAX_SMEM = 232448 - 1024;

struct DecodeArgs {
  const __nv_bfloat16* x;
  const uint8_t* packed;
  const float* alpha;
  const float* z;
  float* y;
  float* part;     // splits > 1: [splits, B, M]
  int* sem;        // splits > 1: one counter per row tile, zero between calls
  int B, M, N, NB, G, q, gs;
  int nsteps;      // 256-column steps of the padded reduction axis
  int per;         // steps per split
  int splits;
  int pw;          // bytes per plane copy: 16, 8 or 4
};

// shared memory: a ring of DT_STAGES stages (x tile, plane bytes), then
// nab buffers of SG groups' alpha and z values
struct DecodeLayout {
  int stage, nrow, sa, nab, sc;
  __host__ __device__ DecodeLayout(int q, bool has_z, int gs) {
    stage = DT_X_BYTES + q * DT_ROWS * DT_PB;
    nrow = q + (has_z ? 1 : 0);
    sa = SG * gs / DT_STEP;              // steps per block of SG groups
    // a block is staged with its first step, DT_STAGES - 1 steps ahead of
    // its use: enough buffers that none is refilled while it is read
    nab = (DT_STAGES - 2) / sa + 2;
    sc = nrow * DT_ROWS * SGP;        // floats per buffer
  }
  __host__ __device__ int bytes() const {
    return DT_STAGES * stage + nab * sc * 4;
  }
};

// stage step it (relative to the split's first step sbeg) into ring slot
// st: the x tile, the plane bytes and, when the step starts a block of SG
// groups, that block's alpha and z values
template <int GS, int PW>
__device__ __forceinline__ void dt_load(const DecodeArgs& a,
                                        const DecodeLayout& L,
                                        unsigned char* st, float* scb,
                                        int sbeg, int it, int m0, int tid) {
  const int gs = GS ? GS : a.gs;
  const int pw = PW ? PW : a.pw;
  const int step = sbeg + it;
  const int k0 = step * DT_STEP;
  for (int i = tid; i < GB * (DT_STEP / 8); i += DT_NT) {
    const int r = i / (DT_STEP / 8), c = i % (DT_STEP / 8);
    const int k = k0 + c * 8;
    const bool ok = r < a.B && k < a.N;
    cp_async16(st + r * DT_XS + c * 16,
               ok ? a.x + (size_t)r * a.N + k : a.x, ok ? 16 : 0);
  }
  unsigned char* ps = st + DT_X_BYTES;
  const int pieces = DT_PB / pw;
  const int b0 = step * DT_PB;
  for (int i = tid; i < a.q * DT_ROWS * pieces; i += DT_NT) {
    const int p = i / (DT_ROWS * pieces), rem = i % (DT_ROWS * pieces);
    const int r = rem / pieces, c = rem % pieces;
    const int m = m0 + r, off = b0 + c * pw;
    const bool ok = m < a.M && off < a.NB;
    const uint8_t* src =
        ok ? a.packed + ((size_t)p * a.M + m) * a.NB + off : a.packed;
    unsigned char* dst = ps + (p * DT_ROWS + r) * DT_PB + c * pw;
    if (pw == 16)
      cp_async16(dst, src, ok ? 16 : 0);
    else if (pw == 8)
      cp_async8(dst, src, ok ? 8 : 0);
    else
      cp_async4(dst, src, ok ? 4 : 0);
  }
  if (it % L.sa) return;
  const int g0 = step * (DT_STEP / gs);
  float* sc = scb + ((it / L.sa) % L.nab) * L.sc;
  for (int i = tid; i < L.nrow * DT_ROWS * SG; i += DT_NT) {
    const int gg = i % SG, pr = i / SG;
    const int p = pr / DT_ROWS, r = pr % DT_ROWS, m = m0 + r;
    const bool ok = m < a.M && g0 + gg < a.G;
    const float* src = a.alpha;
    if (ok)
      src = p < a.q ? a.alpha + ((size_t)p * a.M + m) * a.G + g0 + gg
                    : a.z + (size_t)m * a.G + g0 + gg;
    cp_async4(sc + pr * SGP + gg, src, ok ? 4 : 0);
  }
}

// One pass of NP planes (1 or 2) over one alpha group for one warp:
// part[i] += (+-1 plane i) . x^T over the group's k16 steps, two steps
// per ldmatrix.x4 of x.  prow is this thread's row g of the first plane
// at the group's first byte (planes DT_ROWS rows apart, row g + 8 eight
// rows below); xaddr this lane's ldmatrix address at the group's first
// column.  With XS the x fragments also run against an all-ones A
// operand, leaving each batch row's sum of x over the group in xs.
template <int GS, int NP, bool XS>
__device__ __forceinline__ void dt_pass(const unsigned char* prow,
                                        unsigned xaddr, int gs, unsigned mlo,
                                        unsigned klo, unsigned mhi,
                                        unsigned khi, float (&part)[NP][4],
                                        float (&xs)[4]) {
  const unsigned ones[4] = {ONES, ONES, ONES, ONES};
#pragma unroll
  for (int kp = 0; kp < (GS ? GS : gs) / 32; ++kp) {
    // batch rows x k: k16 step 2 kp in r0, r1, step 2 kp + 1 in r2, r3
    unsigned r[4];
    ldsm_x4(r, xaddr + kp * 64);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      // 32 columns of weight rows g and g + 8: the low half word is step
      // 2 kp, the high half step 2 kp + 1
      const unsigned char* row = prow + i * DT_ROWS * DT_PB;
      const unsigned w0 = *reinterpret_cast<const unsigned*>(row + 4 * kp);
      const unsigned w1 =
          *reinterpret_cast<const unsigned*>(row + 8 * DT_PB + 4 * kp);
      const unsigned lo[4] = {decode_pm1_at(w0, mlo, klo),
                              decode_pm1_at(w1, mlo, klo),
                              decode_pm1_at(w0, mhi, khi),
                              decode_pm1_at(w1, mhi, khi)};
      mma_bf16(part[i], lo, r[0], r[1]);
      const unsigned h0 = w0 >> 16, h1 = w1 >> 16;
      const unsigned hi[4] = {decode_pm1_at(h0, mlo, klo),
                              decode_pm1_at(h1, mlo, klo),
                              decode_pm1_at(h0, mhi, khi),
                              decode_pm1_at(h1, mhi, khi)};
      mma_bf16(part[i], hi, r[2], r[3]);
    }
    if constexpr (XS) {
      mma_bf16(xs, ones, r[0], r[1]);
      mma_bf16(xs, ones, r[2], r[3]);
    }
  }
}

// zero NP partial fragments, run one pass over planes p .. p + NP - 1 of
// the group and fold them into acc with their alphas (sc: this group's
// column of the staged alpha block; c0, c1 are weight row g, c2, c3 row
// g + 8)
template <int GS, int NP, bool XS>
__device__ __forceinline__ void dt_planes(const unsigned char* prow,
                                          const float* sc, int p, int rg,
                                          unsigned xaddr, int gs,
                                          unsigned mlo, unsigned klo,
                                          unsigned mhi, unsigned khi,
                                          float (&acc)[4], float (&xs)[4]) {
  float part[NP][4];
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
  dt_pass<GS, NP, XS>(prow + p * DT_ROWS * DT_PB, xaddr, gs, mlo, klo, mhi,
                      khi, part, xs);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const float s0 = sc[((p + i) * DT_ROWS + rg) * SGP];
    const float s1 = sc[((p + i) * DT_ROWS + rg + 8) * SGP];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[e] = fmaf(e < 2 ? s0 : s1, part[i][e], acc[e]);
  }
}

template <int GS, int PW>
__global__ void __launch_bounds__(DT_NT) bcq_decode_kernel(
    const DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_s;
  const int gs = GS ? GS : a.gs;
  const int gps = DT_STEP / gs;          // alpha groups per step
  const bool has_z = a.z != nullptr;
  const DecodeLayout L(a.q, has_z, gs);
  float* scb = reinterpret_cast<float*>(smem + DT_STAGES * L.stage);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp * 16 + g;          // this thread's weight row g
  const int m0 = blockIdx.x * DT_ROWS;
  const int sbeg = blockIdx.y * a.per;
  const int ns = min(a.nsteps, sbeg + a.per) - sbeg;
  // decode constants: bits 2t, 2t + 1 of a step's low byte and of its
  // high byte
  const unsigned mlo = 3u << (2 * t), klo = 0x40008000u >> (2 * t);
  const unsigned mhi = 3u << (2 * t + 8), khi = 0x40008000u >> (2 * t + 8);
  // ldmatrix: lanes 8j .. 8j + 7 address batch rows 0-7 at column 8 j
  const int lrow = lane & 7, lcol = (lane >> 3) * 16;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < DT_STAGES - 1; ++s) {
    if (s < ns)
      dt_load<GS, PW>(a, L, smem + s * L.stage, scb, sbeg, s, m0, tid);
    cp_async_commit();
  }
  for (int it = 0; it < ns; ++it) {
    cp_async_wait<DT_STAGES - 2>();
    __syncthreads();
    {
      const int nx = it + DT_STAGES - 1;
      if (nx < ns)
        dt_load<GS, PW>(a, L, smem + (nx % DT_STAGES) * L.stage, scb, sbeg,
                        nx, m0, tid);
      cp_async_commit();
    }
    const unsigned char* st = smem + (it % DT_STAGES) * L.stage;
    const unsigned char* ps = st + DT_X_BYTES + rg * DT_PB;
    const unsigned xbase = smem_u32(st + lrow * DT_XS + lcol);
    const float* scblk = scb + ((it / L.sa) % L.nab) * L.sc;
    for (int gi = 0; gi < gps; ++gi) {
      const int grp = (sbeg + it) * gps + gi;
      if (grp >= a.G) break;
      const unsigned char* prow = ps + gi * (gs / 8);
      const unsigned xaddr = xbase + gi * gs * 2;
      const float* sc = scblk + (it % L.sa) * gps + gi;
      float xs[4] = {0.f, 0.f, 0.f, 0.f};
      // planes two at a time (x fragments loaded once for both), the
      // sums of x in the first pass
      int p = 0;
      if (a.q >= 2) {
        if (has_z)
          dt_planes<GS, 2, true>(prow, sc, 0, rg, xaddr, gs, mlo, klo, mhi,
                                 khi, acc, xs);
        else
          dt_planes<GS, 2, false>(prow, sc, 0, rg, xaddr, gs, mlo, klo, mhi,
                                  khi, acc, xs);
        p = 2;
      } else if (has_z) {
        dt_planes<GS, 1, true>(prow, sc, 0, rg, xaddr, gs, mlo, klo, mhi,
                               khi, acc, xs);
        p = 1;
      }
      for (; p + 1 < a.q; p += 2)
        dt_planes<GS, 2, false>(prow, sc, p, rg, xaddr, gs, mlo, klo, mhi,
                                khi, acc, xs);
      if (p < a.q)
        dt_planes<GS, 1, false>(prow, sc, p, rg, xaddr, gs, mlo, klo, mhi,
                                khi, acc, xs);
      if (has_z) {
        const float z0 = sc[(a.q * DT_ROWS + rg) * SGP];
        const float z1 = sc[(a.q * DT_ROWS + rg + 8) * SGP];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[e] = fmaf(e < 2 ? z0 : z1, xs[e], acc[e]);
      }
    }
  }
  cp_async_wait<0>();

  // c0, c1: weight row g, batch rows 2t, 2t + 1; c2, c3: row g + 8
  float* out = a.splits == 1 ? a.y
                             : a.part + (size_t)blockIdx.y * a.B * a.M;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = m0 + rg + (e >> 1) * 8, b = 2 * t + (e & 1);
    if (m < a.M && b < a.B) out[(size_t)b * a.M + m] = acc[e];
  }
  if (a.splits == 1) return;

  // the last split of this row tile to finish adds all of them in split
  // order and sets the tile's counter back to 0 for the next call
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last_s = atomicAdd(a.sem + blockIdx.x, 1) == a.splits - 1;
    if (last_s) a.sem[blockIdx.x] = 0;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const size_t n = (size_t)a.B * a.M;
  for (int i = tid; i < DT_ROWS * a.B; i += DT_NT) {
    const int r = i % DT_ROWS, b = i / DT_ROWS, m = m0 + r;
    if (m >= a.M) continue;
    const size_t o = (size_t)b * a.M + m;
    float v = 0.f;
    for (int sp = 0; sp < a.splits; ++sp) v += __ldcg(a.part + sp * n + o);
    a.y[o] = v;
  }
}

template <int GS, int PW>
cudaError_t launch_dt(const DecodeArgs& a, int smem, cudaStream_t s) {
  auto kernel = bcq_decode_kernel<GS, PW>;
  // the shared-memory opt-in (to the card's maximum), once per device
  static unsigned ready = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(ready >> dev & 1u)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DT_MAX_SMEM);
    if (e != cudaSuccess) return e;
    ready |= 1u << dev;
  }
  dim3 grid(ceil_div(a.M, DT_ROWS), a.splits);
  kernel<<<grid, DT_NT, smem, s>>>(a);
  return cudaGetLastError();
}

bool aligned(const void* p, int n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// the decode tile's checks and derived fields; group size 128 with
// 16-byte plane copies (the served shape) is compiled with its shapes
// fixed, other shapes take the same body with runtime shapes
cudaError_t launch_decode_tile(const void* x, const void* packed,
                               const void* alpha, const void* z, void* y,
                               void* part, void* sem, int B, int M, int N,
                               int NB, int G, int q, int gs, int splits,
                               cudaStream_t s) {
  if (B < 1 || B > GB || (gs != 32 && gs != 64 && gs != 128 && gs != 256) ||
      N % 8 || !aligned(x, 16) || splits < 1 || splits > 65535)
    return cudaErrorInvalidValue;
  const int nsteps = ceil_div(NB, DT_PB);
  const int per = ceil_div(nsteps, splits);
  if (ceil_div(nsteps, per) != splits ||
      (splits > 1 && (part == nullptr || sem == nullptr)))
    return cudaErrorInvalidValue;
  int pw = 4;
  if (NB % 16 == 0 && aligned(packed, 16))
    pw = 16;
  else if (NB % 8 == 0 && aligned(packed, 8))
    pw = 8;
  else if (NB % 4 || !aligned(packed, 4))
    return cudaErrorInvalidValue;
  const DecodeArgs a{static_cast<const __nv_bfloat16*>(x),
                     static_cast<const uint8_t*>(packed),
                     static_cast<const float*>(alpha),
                     static_cast<const float*>(z),
                     static_cast<float*>(y),
                     static_cast<float*>(part),
                     static_cast<int*>(sem),
                     B, M, N, NB, G, q, gs, nsteps, per, splits, pw};
  const int smem = DecodeLayout(q, z != nullptr, gs).bytes();
  if (smem > DT_MAX_SMEM) return cudaErrorInvalidValue;
  if (gs == 128 && pw == 16) return launch_dt<128, 16>(a, smem, s);
  return launch_dt<0, 0>(a, smem, s);
}

}  // namespace

// route: 0 fma, 1 gemv, 2 mma, 3 gemv_fma (see the note at the top);
// part: scratch f32 [splits, B, M] for routes 1 and 2 when splits > 1;
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
      if (x_is_bf16)
        launch_fma_t<__nv_bfloat16>(x, packed, alpha, z, y, B, M, N, NB, G, q,
                                    gs, s);
      else
        launch_fma_t<float>(x, packed, alpha, z, y, B, M, N, NB, G, q, gs, s);
      return static_cast<int>(cudaGetLastError());
    case 1:
      if (!x_is_bf16) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch_decode_tile(x, packed, alpha, z, y, part,
                                                 sem, B, M, N, NB, G, q, gs,
                                                 splits, s));
    case 2:
      if (!x_is_bf16 || B <= GB)
        return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch_bcq_mma(
          x, packed, alpha, z, static_cast<float*>(y),
          static_cast<float*>(part), B, M, N, NB, G, q, gs, splits, false,
          s));
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

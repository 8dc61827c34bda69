// The tensor-core decode tile: y[B, M] = x . dequant(W)^T for at most 8
// activation rows (a decode step), the "gemv" route of bcq_matmul (BCQ
// bit planes, bf16 or f32 activations) and of ternary_matmul (sign and
// mask planes, bf16 or f32 activations).
//
// Replaces, at decode rows: src/repro/kernels/bcq_matmul/bcq_matmul.py
// ::_bcq_matmul_kernel (launcher bcq_matmul_tiled) and
// src/repro/kernels/ternary_matmul/ternary_matmul.py::_ternary_matmul_kernel
// (launcher ternary_matmul_tiled).
//
// What bounds it on an H100: bytes.  The packed planes (q/8 B per weight)
// and the f32 alpha and z rows are read once and every weight feeds at
// most 8 products.
//
// The design: the prefill tile's operand layout (bcq_mma.cu) turned
// around.  The batch goes on the N side of mma.sync.m16n8k16 (a decode
// step has at most 8 rows, exactly n8), 16 weight rows on the M side.
//  - a block of 4 warps owns 64 weight rows and a range of the reduction
//    axis (all of it, or one split's share of 256-column steps); each
//    warp owns 16 weight rows;
//  - per 256-column step a cp.async ring of DT_STAGES stages brings the
//    step's x tile (8 rows, rows past B zero-filled; bf16 rows padded by
//    16 bytes so the 8 row addresses of an ldmatrix fall in 8 distinct
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
//    bcq_matmul/ops.py), the steps are split over gridDim.y; each split
//    writes its partial [B, 64] slice, and the last block of the row tile
//    to finish (a counter per tile, set back to 0 by that block) adds the
//    partials in split order: the result does not depend on which blocks
//    ran when, no float atomics, and no second launch.
// x and +-1 are exact in bf16 and every product is exact in f32, so only
// the f32 summation order differs from bcq_planes_ref.
//
// Ternary weights (TERN).  The reference computes (alpha_g / 2)(x . (+-1
// b1) + x . (+-1 b2)) over the derived planes b1 = s | ~m, b2 = s & m.
// Per weight a clear mask gives (+1) + (-1) = 0 and a set mask 2 (2 s -
// 1), so the pair is exactly alpha_g x . (m (+-1 s)): one {-1, 0, +1}
// operand per k16 step, one mma, alpha itself.  The sign and mask planes
// are staged as the tile's two plane rows, one alpha row and no z row;
// the operand is the sign's +-1 pair with its magnitude taken from the
// mask bits (decode_tern_at).  On exact inputs (integer x, power-of-two
// alpha) every product and partial sum is an exact f32, so the route
// equals the plain versions bit for bit.
//
// f32 activations (F32).  Each x is split into three bf16 parts, each
// from the residual of the ones before it: h = bf16(x), m = bf16(x - h),
// l = bf16(x - h - m); every residual is exact in f32, and for normal x,
// h + m + l = x.  The ring stages the f32 tile (8 KB a step); after the
// step's barrier the block writes its three bf16 parts to one tile in
// shared memory (the next step's barrier keeps it until every warp has
// read it), and each decoded A fragment feeds three mmas, one per part,
// whose f32 fragments are added at the end of the group (the x-sum pass
// likewise).  The decode's integer work is shared by the three parts.
// The error comes only from the f32 summation order.  Four stages fit at
// every q (at most ~194 KB at q 8, group size 32).
//
// Measured on an H100 (PERF.md): the bf16 BCQ tile at [16384 x 4096],
// rows 8, runs at ~5x its byte bound, and rows 1 cost the same as rows
// 8: the copy pipeline and the decode's integer instructions (an and, a
// multiply and a lop3 per +-1 pair) both hold it.
#include "bcq_decode.cuh"

namespace {

constexpr int DT_ROWS = BCQ_DECODE_ROWS;  // weight rows per block
constexpr int DT_NT = 128;                // 4 warps, 16 weight rows each
constexpr int DT_STEP = BCQ_DECODE_STEP;  // reduction columns per stage
constexpr int DT_B = BCQ_DECODE_BATCH;    // batch rows (the n8 side)
constexpr int DT_PB = DT_STEP / 8;        // plane bytes per row per stage
constexpr int DT_XS = DT_STEP * 2 + 16;   // bytes per staged bf16 x row
constexpr int DT_XB = DT_B * DT_XS;       // one bf16 x tile
constexpr int DT_XF = DT_B * DT_STEP * 4;  // one f32 x tile
constexpr int DT_STAGES = 4;
constexpr int DT_MAX_SMEM = 232448 - 1024;

struct DecodeArgs {
  const void* x;
  const uint8_t* packed;
  const float* alpha;
  const float* z;
  float* y;
  float* part;     // splits > 1: [splits, B, M]
  int* sem;        // splits > 1: one counter per row tile, zero between calls
  int B, M, N, NB, G, q, gs;
  int arows;       // alpha rows: q, or 1 for ternary (both planes share it)
  int nsteps;      // 256-column steps of the padded reduction axis
  int per;         // steps per split
  int splits;
  int pw;          // bytes per plane copy: 16, 8 or 4
};

// shared memory: a ring of DT_STAGES stages (x tile, plane bytes), the
// f32 tile's three bf16 parts (F32 only), then nab buffers of SG groups'
// alpha and z values (nrow rows of them)
struct DecodeLayout {
  int xbytes, stage, conv, nrow, sa, nab, sc;
  __host__ __device__ DecodeLayout(int q, int nrow_, int gs, bool f32) {
    nrow = nrow_;
    xbytes = f32 ? DT_XF : DT_XB;
    stage = xbytes + q * DT_ROWS * DT_PB;
    conv = f32 ? 3 * DT_XB : 0;
    sa = SG * gs / DT_STEP;              // steps per block of SG groups
    // a block is staged with its first step, DT_STAGES - 1 steps ahead of
    // its use: enough buffers that none is refilled while it is read
    nab = (DT_STAGES - 2) / sa + 2;
    sc = nrow * DT_ROWS * SGP;           // floats per buffer
  }
  __host__ __device__ int bytes() const {
    return DT_STAGES * stage + conv + nab * sc * 4;
  }
};

// stage step it (relative to the split's first step sbeg) into ring slot
// st: the x tile, the plane bytes and, when the step starts a block of SG
// groups, that block's alpha and z values
template <int GS, int PW, bool F32>
__device__ __forceinline__ void dt_load(const DecodeArgs& a,
                                        const DecodeLayout& L,
                                        unsigned char* st, float* scb,
                                        int sbeg, int it, int m0, int tid) {
  const int gs = GS ? GS : a.gs;
  const int pw = PW ? PW : a.pw;
  const int step = sbeg + it;
  const int k0 = step * DT_STEP;
  if constexpr (F32) {
    const float* x = static_cast<const float*>(a.x);
    for (int i = tid; i < DT_B * (DT_STEP / 4); i += DT_NT) {
      const int r = i / (DT_STEP / 4), c = i % (DT_STEP / 4);
      const int k = k0 + c * 4;
      const bool ok = r < a.B && k < a.N;
      cp_async16(st + r * (DT_STEP * 4) + c * 16,
                 ok ? x + (size_t)r * a.N + k : x, ok ? 16 : 0);
    }
  } else {
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
    for (int i = tid; i < DT_B * (DT_STEP / 8); i += DT_NT) {
      const int r = i / (DT_STEP / 8), c = i % (DT_STEP / 8);
      const int k = k0 + c * 8;
      const bool ok = r < a.B && k < a.N;
      cp_async16(st + r * DT_XS + c * 16,
                 ok ? x + (size_t)r * a.N + k : x, ok ? 16 : 0);
    }
  }
  unsigned char* ps = st + L.xbytes;
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
      src = p < a.arows ? a.alpha + ((size_t)p * a.M + m) * a.G + g0 + gg
                        : a.z + (size_t)m * a.G + g0 + gg;
    cp_async4(sc + pr * SGP + gg, src, ok ? 4 : 0);
  }
}

// F32: the staged f32 tile xf -> its three bf16 parts in xb (part j at
// j * DT_XB, rows DT_XS bytes apart, the layout of a bf16 x tile):
// h = bf16(x), m = bf16(x - h), l = bf16(x - h - m)
__device__ __forceinline__ void dt_split(const unsigned char* xf,
                                         unsigned char* xb, int tid) {
  for (int i = tid; i < DT_B * (DT_STEP / 4); i += DT_NT) {
    const int r = i / (DT_STEP / 4), c = i % (DT_STEP / 4);
    const float4 v =
        *reinterpret_cast<const float4*>(xf + r * (DT_STEP * 4) + c * 16);
    unsigned lo[3], hi[3];
    split_bf16x3(make_float2(v.x, v.y), lo);
    split_bf16x3(make_float2(v.z, v.w), hi);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint2*>(xb + p * DT_XB + r * DT_XS + c * 8) =
          make_uint2(lo[p], hi[p]);
  }
}

// A ternary +-1 / 0 pair: bits s and s + 1 of the sign word give the sign
// as in decode_pm1_at (mask, mul); the same bits of the mask word,
// shifted so that they sit at s <= 7 (k8), give the magnitude: mask7 =
// 3 << s and mul7 = 0x00400080 >> s put them on bits 7 and 23 (cross
// terms on 8 and 22), and times 0x17F each becomes 0xBF80 (-1) in its
// half.  The sign's product has bits only on 15, 16, 30 and 31, so the
// and-not clears bit 15 / 31 (-1 -> +1) where the sign bit is set, and
// a clear mask bit leaves +0.
__device__ __forceinline__ unsigned decode_tern_at(unsigned s, unsigned k8,
                                                   unsigned mask,
                                                   unsigned mul,
                                                   unsigned mask7,
                                                   unsigned mul7) {
  const unsigned ts = (s & mask) * mul;
  const unsigned mag = (((k8 & mask7) * mul7) & 0x00800080u) * 0x17Fu;
  return mag & ~ts;
}

// Decode constants of one thread (t = lane % 4): bits 2t, 2t + 1 of a
// step's low byte (lo) and of its high byte (hi), and the mask word's
// placement (mask7, mul7: bits 2t, 2t + 1 of a byte shifted to the
// bottom)
struct DecodeConsts {
  unsigned mlo, klo, mhi, khi, m7, k7;
  __device__ explicit DecodeConsts(int t)
      : mlo(3u << (2 * t)), klo(0x40008000u >> (2 * t)),
        mhi(3u << (2 * t + 8)), khi(0x40008000u >> (2 * t + 8)),
        m7(3u << (2 * t)), k7(0x00400080u >> (2 * t)) {}
};

// the A fragments of two k16 steps (lo: step 2 kp, hi: step 2 kp + 1)
// for weight rows g and g + 8 of one plane at prow (32 columns each)
__device__ __forceinline__ void bcq_frags(const unsigned char* prow, int kp,
                                          const DecodeConsts& c,
                                          unsigned (&lo)[4],
                                          unsigned (&hi)[4]) {
  const unsigned w0 = *reinterpret_cast<const unsigned*>(prow + 4 * kp);
  const unsigned w1 =
      *reinterpret_cast<const unsigned*>(prow + 8 * DT_PB + 4 * kp);
  lo[0] = decode_pm1_at(w0, c.mlo, c.klo);   // row g, cols 2t, 2t + 1
  lo[1] = decode_pm1_at(w1, c.mlo, c.klo);   // row g + 8
  lo[2] = decode_pm1_at(w0, c.mhi, c.khi);   // row g, cols 2t + 8, + 9
  lo[3] = decode_pm1_at(w1, c.mhi, c.khi);   // row g + 8
  const unsigned h0 = w0 >> 16, h1 = w1 >> 16;
  hi[0] = decode_pm1_at(h0, c.mlo, c.klo);
  hi[1] = decode_pm1_at(h1, c.mlo, c.klo);
  hi[2] = decode_pm1_at(h0, c.mhi, c.khi);
  hi[3] = decode_pm1_at(h1, c.mhi, c.khi);
}

// the same for ternary weights: the sign plane at prow, the mask plane
// DT_ROWS rows below it
__device__ __forceinline__ void tern_frags(const unsigned char* prow, int kp,
                                           const DecodeConsts& c,
                                           unsigned (&lo)[4],
                                           unsigned (&hi)[4]) {
  const unsigned char* mrow = prow + DT_ROWS * DT_PB;
  const unsigned s0 = *reinterpret_cast<const unsigned*>(prow + 4 * kp);
  const unsigned s1 =
      *reinterpret_cast<const unsigned*>(prow + 8 * DT_PB + 4 * kp);
  const unsigned k0 = *reinterpret_cast<const unsigned*>(mrow + 4 * kp);
  const unsigned k1 =
      *reinterpret_cast<const unsigned*>(mrow + 8 * DT_PB + 4 * kp);
  lo[0] = decode_tern_at(s0, k0, c.mlo, c.klo, c.m7, c.k7);
  lo[1] = decode_tern_at(s1, k1, c.mlo, c.klo, c.m7, c.k7);
  lo[2] = decode_tern_at(s0, k0 >> 8, c.mhi, c.khi, c.m7, c.k7);
  lo[3] = decode_tern_at(s1, k1 >> 8, c.mhi, c.khi, c.m7, c.k7);
  const unsigned h0 = s0 >> 16, h1 = s1 >> 16;
  hi[0] = decode_tern_at(h0, k0 >> 16, c.mlo, c.klo, c.m7, c.k7);
  hi[1] = decode_tern_at(h1, k1 >> 16, c.mlo, c.klo, c.m7, c.k7);
  hi[2] = decode_tern_at(h0, k0 >> 24, c.mhi, c.khi, c.m7, c.k7);
  hi[3] = decode_tern_at(h1, k1 >> 24, c.mhi, c.khi, c.m7, c.k7);
}

// One pass of NP planes (1 or 2; TERN: the one sign-and-mask operand)
// over one alpha group for one warp: part[i] += (plane i operand) . x^T
// over the group's k16 steps, two steps per ldmatrix.x4 of each of the
// NX x tiles (1, or the 3 bf16 parts of f32 x, DT_XB bytes apart), every
// A fragment against each tile, into one accumulator per tile (three
// dependent chains a third as long, added at the end: measured faster
// than one chain on f32 rows).  prow is this thread's row g of the
// first plane at the group's first byte (planes DT_ROWS rows apart, row
// g + 8 eight rows below); xaddr this lane's ldmatrix address at the
// group's first column.  With XS the x fragments also run against an
// all-ones A operand, leaving each batch row's sum of x over the group
// in xs.
template <int GS, int NP, bool XS, bool TERN, int NX>
__device__ __forceinline__ void dt_pass(const unsigned char* prow,
                                        unsigned xaddr, int gs,
                                        const DecodeConsts& c,
                                        float (&part)[NP][4],
                                        float (&xs)[4]) {
  const unsigned ones[4] = {ONES, ONES, ONES, ONES};
  float pp[NP][NX][4], xp[NX][4];
#pragma unroll
  for (int j = 0; j < NX; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int i = 0; i < NP; ++i) pp[i][j][e] = j ? 0.f : part[i][e];
      xp[j][e] = j ? 0.f : xs[e];
    }
#pragma unroll
  for (int kp = 0; kp < (GS ? GS : gs) / 32; ++kp) {
    // batch rows x k: k16 step 2 kp in r0, r1, step 2 kp + 1 in r2, r3
    unsigned r[NX][4];
#pragma unroll
    for (int j = 0; j < NX; ++j) ldsm_x4(r[j], xaddr + j * DT_XB + kp * 64);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      unsigned lo[4], hi[4];
      if constexpr (TERN)
        tern_frags(prow, kp, c, lo, hi);
      else
        bcq_frags(prow + i * DT_ROWS * DT_PB, kp, c, lo, hi);
#pragma unroll
      for (int j = 0; j < NX; ++j) mma_bf16(pp[i][j], lo, r[j][0], r[j][1]);
#pragma unroll
      for (int j = 0; j < NX; ++j) mma_bf16(pp[i][j], hi, r[j][2], r[j][3]);
    }
    if constexpr (XS) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        mma_bf16(xp[j], ones, r[j][0], r[j][1]);
        mma_bf16(xp[j], ones, r[j][2], r[j][3]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float v = xp[0][e];
#pragma unroll
    for (int j = 1; j < NX; ++j) v += xp[j][e];
    xs[e] = v;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      float w = pp[i][0][e];
#pragma unroll
      for (int j = 1; j < NX; ++j) w += pp[i][j][e];
      part[i][e] = w;
    }
  }
}

// zero NP partial fragments, run one pass over planes p .. p + NP - 1 of
// the group and fold them into acc with their alphas (sc: this group's
// column of the staged alpha block; c0, c1 are weight row g, c2, c3 row
// g + 8)
template <int GS, int NP, bool XS, bool TERN, int NX>
__device__ __forceinline__ void dt_planes(const unsigned char* prow,
                                          const float* sc, int p, int rg,
                                          unsigned xaddr, int gs,
                                          const DecodeConsts& c,
                                          float (&acc)[4], float (&xs)[4]) {
  float part[NP][4];
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
  dt_pass<GS, NP, XS, TERN, NX>(prow + p * DT_ROWS * DT_PB, xaddr, gs, c,
                                part, xs);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const float s0 = sc[((p + i) * DT_ROWS + rg) * SGP];
    const float s1 = sc[((p + i) * DT_ROWS + rg + 8) * SGP];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[e] = fmaf(e < 2 ? s0 : s1, part[i][e], acc[e]);
  }
}

template <int GS, int PW, bool TERN, bool F32>
__global__ void __launch_bounds__(DT_NT) bcq_decode_kernel(
    const DecodeArgs a) {
  constexpr int NX = F32 ? 3 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_s;
  const int gs = GS ? GS : a.gs;
  const int gps = DT_STEP / gs;          // alpha groups per step
  const bool has_z = !TERN && a.z != nullptr;
  const DecodeLayout L(a.q, a.arows + (has_z ? 1 : 0), gs, F32);
  unsigned char* xb = smem + DT_STAGES * L.stage;   // F32: the bf16 parts
  float* scb = reinterpret_cast<float*>(xb + L.conv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2;
  const int rg = warp * 16 + g;          // this thread's weight row g
  const int m0 = blockIdx.x * DT_ROWS;
  const int sbeg = blockIdx.y * a.per;
  const int ns = min(a.nsteps, sbeg + a.per) - sbeg;
  const DecodeConsts dc(lane & 3);
  // ldmatrix: lanes 8j .. 8j + 7 address batch rows 0-7 at column 8 j
  const int lrow = lane & 7, lcol = (lane >> 3) * 16;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < DT_STAGES - 1; ++s) {
    if (s < ns)
      dt_load<GS, PW, F32>(a, L, smem + s * L.stage, scb, sbeg, s, m0, tid);
    cp_async_commit();
  }
  for (int it = 0; it < ns; ++it) {
    cp_async_wait<DT_STAGES - 2>();
    __syncthreads();
    {
      const int nx = it + DT_STAGES - 1;
      if (nx < ns)
        dt_load<GS, PW, F32>(a, L, smem + (nx % DT_STAGES) * L.stage, scb,
                             sbeg, nx, m0, tid);
      cp_async_commit();
    }
    const unsigned char* st = smem + (it % DT_STAGES) * L.stage;
    if constexpr (F32) {
      dt_split(st, xb, tid);
      __syncthreads();
    }
    const unsigned char* ps = st + L.xbytes + rg * DT_PB;
    const unsigned xbase = smem_u32((F32 ? xb : st) + lrow * DT_XS + lcol);
    const float* scblk = scb + ((it / L.sa) % L.nab) * L.sc;
    for (int gi = 0; gi < gps; ++gi) {
      const int grp = (sbeg + it) * gps + gi;
      if (grp >= a.G) break;
      const unsigned char* prow = ps + gi * (gs / 8);
      const unsigned xaddr = xbase + gi * gs * 2;
      const float* sc = scblk + (it % L.sa) * gps + gi;
      float xs[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (TERN) {
        dt_planes<GS, 1, false, true, NX>(prow, sc, 0, rg, xaddr, gs, dc,
                                          acc, xs);
      } else {
        // planes two at a time (x fragments loaded once for both), the
        // sums of x in the first pass
        int p = 0;
        if (a.q >= 2) {
          if (has_z)
            dt_planes<GS, 2, true, false, NX>(prow, sc, 0, rg, xaddr, gs, dc,
                                              acc, xs);
          else
            dt_planes<GS, 2, false, false, NX>(prow, sc, 0, rg, xaddr, gs,
                                               dc, acc, xs);
          p = 2;
        } else if (has_z) {
          dt_planes<GS, 1, true, false, NX>(prow, sc, 0, rg, xaddr, gs, dc,
                                            acc, xs);
          p = 1;
        }
        for (; p + 1 < a.q; p += 2)
          dt_planes<GS, 2, false, false, NX>(prow, sc, p, rg, xaddr, gs, dc,
                                             acc, xs);
        if (p < a.q)
          dt_planes<GS, 1, false, false, NX>(prow, sc, p, rg, xaddr, gs, dc,
                                             acc, xs);
        if (has_z) {
          const float z0 = sc[(a.arows * DT_ROWS + rg) * SGP];
          const float z1 = sc[(a.arows * DT_ROWS + rg + 8) * SGP];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[e] = fmaf(e < 2 ? z0 : z1, xs[e], acc[e]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // c0, c1: weight row g, batch rows 2t, 2t + 1; c2, c3: row g + 8
  const int t = lane & 3;
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

template <int GS, int PW, bool TERN, bool F32>
cudaError_t launch_dt(const DecodeArgs& a, int smem, cudaStream_t s) {
  auto kernel = bcq_decode_kernel<GS, PW, TERN, F32>;
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

// group size 128 with 16-byte plane copies (the served shape) is compiled
// with its shapes fixed; other shapes take the same body with runtime
// shapes
template <bool TERN, bool F32>
cudaError_t launch_shapes(const DecodeArgs& a, int smem, cudaStream_t s) {
  if (a.gs == 128 && a.pw == 16)
    return launch_dt<128, 16, TERN, F32>(a, smem, s);
  return launch_dt<0, 0, TERN, F32>(a, smem, s);
}

bool aligned(const void* p, int n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

cudaError_t launch_bcq_decode(const void* x, const void* packed,
                              const void* alpha, const void* z, void* y,
                              void* part, void* sem, int B, int M, int N,
                              int NB, int G, int q, int gs, bool x_is_bf16,
                              bool ternary, int splits, cudaStream_t s) {
  if (B < 1 || B > DT_B || (gs != 32 && gs != 64 && gs != 128 && gs != 256) ||
      q < 1 || q > 8 || (ternary && (q != 2 || z != nullptr)) || N % 8 ||
      N > NB * 8 || G * gs != NB * 8 || !aligned(x, 16) || splits < 1 ||
      splits > 65535)
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
  const int arows = ternary ? 1 : q;
  const DecodeArgs a{x,
                     static_cast<const uint8_t*>(packed),
                     static_cast<const float*>(alpha),
                     static_cast<const float*>(z),
                     static_cast<float*>(y),
                     static_cast<float*>(part),
                     static_cast<int*>(sem),
                     B, M, N, NB, G, q, gs, arows, nsteps, per, splits, pw};
  const bool f32 = !x_is_bf16;
  const int smem =
      DecodeLayout(q, arows + (z != nullptr ? 1 : 0), gs, f32).bytes();
  if (smem > DT_MAX_SMEM) return cudaErrorInvalidValue;
  if (ternary)
    return f32 ? launch_shapes<true, true>(a, smem, s)
               : launch_shapes<true, false>(a, smem, s);
  return f32 ? launch_shapes<false, true>(a, smem, s)
             : launch_shapes<false, false>(a, smem, s);
}

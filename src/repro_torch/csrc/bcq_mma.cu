// The tensor-core BCQ tile: y[B, M] = x . dequant(W)^T on bit planes,
// bf16 or f32 activations, more than 8 batch rows.  The "mma" route of
// bcq_matmul, lut_gemm and ternary_matmul.
//
// Replaces, at prefill widths: src/repro/kernels/lut_gemm/lut_gemm.py
// ::_lut_gemm_kernel (launcher lut_gemm_tiled) and
// src/repro/kernels/bcq_matmul/bcq_matmul.py::_bcq_matmul_kernel
// (launcher bcq_matmul_tiled).  Both compute
//   y[b,m] = sum_i sum_g alpha[i,m,g] sum_{k in g} x[b,k] (2 bit_i[m,k] - 1)
//          + sum_g z[m,g] sum_{k in g} x[b,k].
// The reference reads its LUT by a one-hot contraction on the MXU
// (lut_common.read_lut, mode "onehot"); the table is itself a product,
// lut = x_g . S^T, so (x_g . S^T) . onehot(key)^T = x_g . (S^T .
// onehot(key)^T), and S^T . onehot(key) is the key's +-1 bit column.
// Re-associated, the table read is one bf16 product per bit plane and
// alpha group: x against the decoded +-1 plane.  x and +-1 are exact in
// bf16 and every product is exact, so only the f32 summation order
// differs from the reference.
//
// What bounds it on an H100: operations.  q bf16 products of the dense
// size (2 q B M N flops; 206 GFLOP at rows 512, [16384 x 4096], q 3, or
// 0.21 ms at 989 TFLOP/s), against a few MB of planes.
//
// The design (mma.sync; wgmma and TMA are later work):
//  - a block of 8 warps owns 128 weight rows x 64 batch rows (32 when B
//    is at most 32) and walks its alpha groups (all of them, or one
//    split's share) one group of gs columns at a time; each warp owns 16
//    weight rows and all the block's batch rows (1 m16 x 8 or 4 n8 mma
//    tiles), so each weight fragment is decoded once per block;
//  - staging: the group's x tile (bf16; f32 x below) and plane bytes (q
//    x 128 rows x gs/8 bytes) go through a cp.async ring of 3 stages (2
//    where 3 do not fit), one barrier per group; the alpha and z values
//    of 8 groups at a time ride with the first of them, into two
//    buffers; x rows are padded by 16 bytes, so the 8 row addresses of
//    an ldmatrix fall in 8 distinct 16-byte bank groups
//    (conflict-free), and rows past B or M are zero-filled by the copy
//    itself;
//  - the weight operand (mma A, weight rows x k) is built by each thread
//    in registers straight from two plane bytes: bits 2t and 2t+1 of a
//    byte become the two bf16 halves of a register, 0x3F80 (+1) or
//    0xBF80 (-1), by one multiply and one masked xor: the sign-decoding
//    unit.  No dense weight tile is ever written;
//  - per plane and group one f32 partial fragment is zeroed, takes gs/16
//    mmas per tile and is folded into the accumulator as acc += alpha *
//    part; planes go two to a pass, so each x fragment loaded feeds 4
//    mmas.  For the offset term, in plane 0's pass the first warps also
//    run the x fragments they load anyway as an A operand against an
//    all-ones B (one mma per 16 batch rows and k16 step), which yields
//    each batch row's sum of x over the group; they leave the sums in
//    shared memory (two buffers by group parity), and every warp folds
//    acc += z * xsum after the next group's barrier;
//  - every mma of a warp runs unconditionally (tiles past B read
//    zero-filled rows): a mma.sync under a per-tile branch costs a
//    convergence barrier each;
//  - the main path's group size (128, with 16-byte plane rows) is a
//    compile-time shape: its index arithmetic folds and the k16 loop
//    unrolls; other group sizes take the same body with runtime shapes;
//  - a split of the alpha groups over gridDim.z is taken where the
//    (row, batch) tiles alone would leave SMs idle (rows 32 or 128); the
//    partials are added by a fixed-order second pass.
//
// Ternary weights (the "mma" route of ternary_matmul; replaces
// src/repro/kernels/ternary_matmul/ternary_matmul.py::_ternary_matmul_kernel
// at prefill widths) take the same tile with the TERN flag.  The
// reference computes y = sum_g (alpha_g / 2) (x . (+-1 b1) + x . (+-1 b2))
// over the derived planes b1 = sign | ~mask and b2 = sign & mask
// (lut_common.ternary_plane_bytes), so a ternary bundle is a 2-plane
// problem with alpha / 2 on both planes and no offset.  Both raw planes
// (sign, mask) arrive in one stage; each thread derives b1 and b2 from
// the two 16-bit words in registers, decodes both to +-1 pairs and adds
// them (bf16 {-2, 0, +2}, exact), so the two plane products become one:
// x . ((+-1 b1) + (+-1 b2)) = x . (+-1 b1) + x . (+-1 b2), the
// reference's V1 + V2 summed before its alpha / 2 scale.  The one alpha
// row is folded times 0.5; z is null, so the x-sum pass is compiled out.
// The stored planes are read as they are: nothing is re-encoded.  On
// exact inputs (integer x, power-of-two alpha) every product and partial
// sum is an exact f32, so the route equals the plain versions bit for bit.
//
// f32 activations (F32; the plain version of this order is
// bcq_matmul.ref.mma_split_ref).  The decode tile's split (bcq_decode.cu)
// at prefill widths: each x is split into three bf16 parts, h = bf16(x),
// m = bf16(x - h), l = bf16(x - h - m), every residual exact in f32, so
// for normal x h + m + l = x.  The ring stages the group's f32 x tile;
// after the stage's barrier the block writes its three bf16 parts to one
// shared tile (rows laid out as a staged bf16 x tile), and a second
// barrier hands it to the warps; the next group's first barrier keeps it
// until every warp has read it.  Each decoded A fragment then runs
// against the x fragments of all three parts into the same partial
// fragment of its plane and group (no more registers), which is folded
// with alpha as in bf16; the x-sum pass runs the three parts too.  The
// decode, the alpha and the z folds are shared by the parts; the mmas
// and x loads are three times bf16's.  What bounds it: operations, 3 q
// bf16 products of the dense size (618 GFLOP at rows 512, [16384 x
// 4096], q 3: 0.63 ms at 989 TFLOP/s, against 1.03 ms for the dense f32
// product on the CUDA cores at 67 TFLOP/s).  An f32 stage is twice a
// bf16 one and the parts take another 3 x 64 rows x (2 gs + 16) bytes,
// so a block holds 64 batch rows where three or two stages of that fit
// (gs <= 128 at q <= 7), else 32 (gs 128 at q 8, gs 256 at q <= 6), else
// 16 (gs 256 at q 7 and 8); one block an SM (its 128-203 registers a
// thread, and at gs 128 its shared memory).  Only the f32 summation
// order differs from the plain version; on exact inputs (m = l = 0) it
// equals the plain versions bit for bit.
#include "bcq_mma.cuh"

#include <type_traits>

namespace {

constexpr int MT = BCQ_MMA_ROWS;   // weight rows per block
constexpr int NT = 256;            // 8 warps, 16 weight rows each
constexpr int WM = MT / (NT / 32);  // weight rows per warp
// a block's dynamic shared memory: the card's 232,448 bytes less room
// for the kernel's static buffer
constexpr int MAX_SMEM = 232448 - 1024;

// two bf16 pairs added (exact for the +-1 sums of the ternary planes)
__device__ __forceinline__ unsigned add_bf16x2(unsigned a, unsigned b) {
  const __nv_bfloat162 r =
      __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const unsigned*>(&r);
}

// shared memory: a ring of stages (x tile, plane bytes), with f32 x the
// three bf16 parts of the current group's x tile, then two blocks of SG
// groups' alpha and z
struct Layout {
  int xs;       // bytes per bf16 x row (staged, or one part): gs bf16
                // and 16 of padding
  int xrow;     // bytes per staged x row: xs, or gs f32 with f32 x
  int x_bytes;  // the staged x tile
  int p_bytes;  // the plane bytes, rounded up to 16
  int stage;    // one ring stage: x tile and plane bytes
  int part;     // one bf16 part of an f32 x tile
  int conv;     // the three parts (f32 x), or 0
  int sc_bytes;  // two blocks of SG groups' alpha and z, after the ring
  __host__ __device__ Layout(int gs, int q, int bt, bool f32) {
    xs = gs * 2 + 16;
    xrow = f32 ? gs * 4 : xs;
    x_bytes = bt * xrow;
    p_bytes = (q * MT * (gs / 8) + 15) / 16 * 16;
    stage = x_bytes + p_bytes;
    part = bt * xs;
    conv = f32 ? 3 * part : 0;
    sc_bytes = 2 * (q + 1) * MT * SGP * 4;
  }
  __host__ __device__ int bytes(int stages) const {
    return stages * stage + conv + sc_bytes;
  }
};

struct Args {
  const void* x;  // bf16, or f32 with the F32 kernels
  const uint8_t* packed;
  const float* alpha;
  const float* z;
  float* out;     // y, or the split partials [splits, B, M]
  int B, M, N, NB, G, q, gs;
  int arows;      // alpha rows: q, or 1 for ternary (both planes share it)
  int per;        // alpha groups per split
  int pw;         // bytes per plane copy: 16, 8, 4, or 1 (plain loads)
};

// stage the x tile (BT rows; bf16, or f32 with F32) and plane bytes of
// alpha group grp, and the alpha and z values of groups grp .. grp + SG
// - 1 when grp starts a block of SG.  GS and PW are the group size and
// plane copy width when fixed at compile time (0: read from the
// arguments), so the index arithmetic folds.
template <int GS, int PW, int BT, bool F32>
__device__ __forceinline__ void load_stage(const Args& a, const Layout& L,
                                           unsigned char* st, float* scb,
                                           int grp, int gbeg, int gend,
                                           int m0, int b0, int tid) {
  const int gs = GS ? GS : a.gs;
  const int pw = PW ? PW : a.pw;
  const int k0 = grp * gs;
  // 16-byte chunks per x row: 8 bf16 or 4 f32 values
  constexpr int EPC = F32 ? 4 : 8;
  using T = typename std::conditional<F32, float, __nv_bfloat16>::type;
  const T* x = static_cast<const T*>(a.x);
  const int nch = gs / EPC;
  for (int i = tid; i < BT * nch; i += NT) {
    const int r = i / nch, c = i % nch;
    const int b = b0 + r, k = k0 + c * EPC;
    const bool ok = b < a.B && k < a.N;
    cp_async16(st + r * L.xrow + c * 16,
               ok ? x + (size_t)b * a.N + k : x, ok ? 16 : 0);
  }
  unsigned char* ps = st + L.x_bytes;
  const int pb = gs / 8;                    // plane bytes per row
  const int pieces = pb / pw;
  for (int i = tid; i < a.q * MT * pieces; i += NT) {
    const int p = i / (MT * pieces), rem = i % (MT * pieces);
    const int r = rem / pieces, c = rem % pieces;
    const int m = m0 + r;
    const bool ok = m < a.M;
    const uint8_t* src = a.packed + ((size_t)p * a.M + (ok ? m : 0)) * a.NB +
                         (size_t)grp * pb + c * pw;
    unsigned char* dst = ps + (p * MT + r) * pb + c * pw;
    if (pw == 16)
      cp_async16(dst, src, ok ? 16 : 0);
    else if (pw == 8)
      cp_async8(dst, src, ok ? 8 : 0);
    else if (pw == 4)
      cp_async4(dst, src, ok ? 4 : 0);
    else
      *dst = ok ? *src : 0;
  }
  // the first group of a block of SG stages its block's alpha and z
  if ((grp - gbeg) % SG) return;
  const int nrow = a.arows + (a.z != nullptr);
  float* sc = scb + (((grp - gbeg) / SG) & 1) * (a.q + 1) * MT * SGP;
  for (int i = tid; i < nrow * MT * SG; i += NT) {
    const int gg = i % SG, pr = i / SG;
    const int p = pr / MT, r = pr % MT, m = m0 + r;
    const bool ok = m < a.M && grp + gg < gend;
    const size_t mm = ok ? m : 0;
    const int gr = ok ? grp + gg : 0;
    const float* src = p < a.arows
                           ? a.alpha + ((size_t)p * a.M + mm) * a.G + gr
                           : a.z + mm * a.G + gr;
    cp_async4(sc + pr * SGP + gg, src, ok ? 4 : 0);
  }
}

// F32: the staged f32 x tile (BT rows of gs values) -> its three bf16
// parts in conv (part j at j * L.part, rows L.xs bytes apart: the layout
// of a staged bf16 x tile)
template <int BT>
__device__ __forceinline__ void split_stage(const unsigned char* xf,
                                            unsigned char* conv,
                                            const Layout& L, int gs,
                                            int tid) {
  const int nch = gs / 4;                   // float4 chunks per row
  for (int i = tid; i < BT * nch; i += NT) {
    const int r = i / nch, c = i % nch;
    const float4 v =
        *reinterpret_cast<const float4*>(xf + r * L.xrow + c * 16);
    unsigned lo[3], hi[3];
    split_bf16x3(make_float2(v.x, v.y), lo);
    split_bf16x3(make_float2(v.z, v.w), hi);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint2*>(conv + p * L.part + r * L.xs + c * 8) =
          make_uint2(lo[p], hi[p]);
  }
}

// One pass of NP planes (1 or 2) over a staged group for one warp:
// part[i] += x . (+-1 plane i)^T over gs/16 k16 steps, one m16 x NB8 n8
// tiles each, the x fragments loaded once for all NP planes.  NX x tiles
// (1, or the 3 bf16 parts of f32 x, xpart bytes apart) run against the
// same A fragments into the same partials.  prow is this thread's row g
// of the first plane (planes are MT rows apart).  With XS it also runs
// the x fragments of 16-row pair xpair (all NX tiles) as an A operand
// against an all-ones B, which leaves each of those batch rows' sum of x
// over the group in xs (row 16 xpair + g in xs[0], + 8 in xs[2]).  With
// TERN (NP 1) the pass reads the sign plane at prow and the mask plane
// MT rows below it, and its operand is the sum of the two derived
// planes' +-1 pairs.
template <int GS, int NB8, int NP, bool XS, bool TERN, int NX>
__device__ __forceinline__ void plane_pass(
    const unsigned char* prow, int pb, int ksteps, unsigned xaddr,
    int xstride, int xpart, int xpair, unsigned mlo, unsigned klo,
    unsigned mhi, unsigned khi, float (&part)[NP][NB8][4], float (&xs)[4]) {
  const unsigned ones[2] = {ONES, ONES};
#pragma unroll
  for (int kk = 0; kk < (GS ? GS / 16 : ksteps); ++kk) {
    unsigned af[NP][4];
    if constexpr (TERN) {
      static_assert(NP == 1, "a ternary pass is one combined operand");
      // sign and mask words of weight rows g and g + 8, then the derived
      // planes b1 = s | ~m and b2 = s & m
      const unsigned char* mrow = prow + MT * pb;
      const unsigned s0 = *reinterpret_cast<const uint16_t*>(prow + 2 * kk);
      const unsigned s1 =
          *reinterpret_cast<const uint16_t*>(prow + 8 * pb + 2 * kk);
      const unsigned k0 = *reinterpret_cast<const uint16_t*>(mrow + 2 * kk);
      const unsigned k1 =
          *reinterpret_cast<const uint16_t*>(mrow + 8 * pb + 2 * kk);
      const unsigned b1[2] = {s0 | ~k0, s1 | ~k1};
      const unsigned b2[2] = {s0 & k0, s1 & k1};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // e: row g / g + 8 (e & 1), low / high byte of the step (e >> 1)
        const unsigned mk = e >> 1 ? mhi : mlo, ml = e >> 1 ? khi : klo;
        af[0][e] = add_bf16x2(decode_pm1_at(b1[e & 1], mk, ml),
                              decode_pm1_at(b2[e & 1], mk, ml));
      }
    } else {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        // bytes 2 kk (columns 0-7 of the step) and 2 kk + 1 (8-15) of
        // weight rows g and g + 8
        const unsigned char* row = prow + i * MT * pb;
        const unsigned w0 = *reinterpret_cast<const uint16_t*>(row + 2 * kk);
        const unsigned w1 =
            *reinterpret_cast<const uint16_t*>(row + 8 * pb + 2 * kk);
        af[i][0] = decode_pm1_at(w0, mlo, klo);  // row g, cols 2t, 2t + 1
        af[i][1] = decode_pm1_at(w1, mlo, klo);  // row g + 8
        af[i][2] = decode_pm1_at(w0, mhi, khi);  // row g, cols 2t + 8, + 9
        af[i][3] = decode_pm1_at(w1, mhi, khi);  // row g + 8
      }
    }
#pragma unroll
    for (int j = 0; j < NB8 / 2; ++j)
#pragma unroll
      for (int x = 0; x < NX; ++x) {
        // n8 tiles 2j and 2j + 1: batch rows 16 j + [0, 16) of x tile x
        unsigned r[4];
        ldsm_x4(r, xaddr + x * xpart + j * 16 * xstride + kk * 32);
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          mma_bf16(part[i][2 * j], af[i], r[0], r[1]);
          mma_bf16(part[i][2 * j + 1], af[i], r[2], r[3]);
        }
      }
    if constexpr (XS) {
      // pair xpair's x fragments once more, as an A operand: (rows 0-7,
      // k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k
      // 8-15) are ldmatrix registers 0, 2, 1, 3 (one more load rather
      // than a branch around a mma.sync)
#pragma unroll
      for (int x = 0; x < NX; ++x) {
        unsigned r[4];
        ldsm_x4(r, xaddr + x * xpart + xpair * 16 * xstride + kk * 32);
        const unsigned xa[4] = {r[0], r[2], r[1], r[3]};
        mma_bf16(xs, xa, ones[0], ones[1]);
      }
    }
  }
}

// zero NP partial fragments, run one pass over planes p .. p + NP - 1
// and fold them into acc with their alphas (TERN: the one combined pass,
// folded with alpha / 2)
template <int GS, int NB8, int NP, bool XS, bool TERN, int NX>
__device__ __forceinline__ void planes_step(
    const unsigned char* ps, const float* sc, int p, int wm, int g, int pb,
    int ksteps, unsigned xaddr, int xstride, int xpart, int xpair,
    unsigned mlo, unsigned klo, unsigned mhi, unsigned khi,
    float (&acc)[NB8][4], float (&xs)[4]) {
  float part[NP][NB8][4];
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int j = 0; j < NB8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
  plane_pass<GS, NB8, NP, XS, TERN, NX>(ps + (p * MT + wm + g) * pb, pb,
                                        ksteps, xaddr, xstride, xpart, xpair,
                                        mlo, klo, mhi, khi, part, xs);
  // fold: c0, c1 are weight row g, c2, c3 row g + 8
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const float s0 = sc[((p + i) * MT + wm + g) * SGP] * (TERN ? 0.5f : 1.f);
    const float s1 =
        sc[((p + i) * MT + wm + g + 8) * SGP] * (TERN ? 0.5f : 1.f);
#pragma unroll
    for (int nt = 0; nt < NB8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[nt][e] = fmaf(e < 2 ? s0 : s1, part[i][nt][e], acc[nt][e]);
  }
}

// one block a SM with f32 x (its shared memory), two with bf16
template <int S, int GS, int PW, int NB8, bool TERN, bool F32>
__global__ void __launch_bounds__(NT, F32 ? 1 : 2)
    bcq_mma_kernel(const Args a) {
  constexpr int BT = NB8 * 8;       // batch rows per block
  constexpr int NX = F32 ? 3 : 1;   // x tiles per group: the f32 parts
  extern __shared__ __align__(16) unsigned char smem[];
  // sums of x per batch row, by group parity
  __shared__ __align__(16) float xsum_s[2][BT];
  const int gs = GS ? GS : a.gs;
  const Layout L(gs, a.q, BT, F32);
  unsigned char* conv = smem + S * L.stage;       // F32: the bf16 parts
  float* scb = reinterpret_cast<float*>(conv + L.conv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp * WM;
  const int m0 = blockIdx.x * MT, b0 = blockIdx.y * BT;
  const int gbeg = blockIdx.z * a.per;
  const int ng = min(a.G, gbeg + a.per) - gbeg;
  const int ksteps = gs / 16, pb = gs / 8;
  const bool has_z = a.z != nullptr;
  // warps 0 .. NB8/2 - 1 sum x over 16 batch rows each
  const bool sums = has_z && warp < NB8 / 2;
  // ldmatrix row of this lane: matrix j = lane / 8 covers batch rows
  // (j / 2) * 8 + [0, 8) and columns (j % 2) * 8 + [0, 8) of a k16 step
  const int lrow = (lane >> 4) * 8 + (lane & 7);
  const int lcol = ((lane >> 3) & 1) * 16;
  // decode constants: bits 2t, 2t + 1 of the step's low byte and of its
  // high byte (bits 2t + 8, 2t + 9 of the 16-bit word)
  const unsigned mlo = 3u << (2 * t), klo = 0x40008000u >> (2 * t);
  const unsigned mhi = 3u << (2 * t + 8), khi = 0x40008000u >> (2 * t + 8);

  float acc[NB8][4];
#pragma unroll
  for (int j = 0; j < NB8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // the previous group's z values for rows g and g + 8, folded with its
  // sums of x once they are in shared memory (after the next barrier)
  float zp0 = 0.f, zp1 = 0.f;
  auto fold_z = [&](int buf) {
#pragma unroll
    for (int nt = 0; nt < NB8; ++nt) {
      const float2 xv =
          *reinterpret_cast<const float2*>(&xsum_s[buf][nt * 8 + 2 * t]);
      acc[nt][0] = fmaf(zp0, xv.x, acc[nt][0]);
      acc[nt][1] = fmaf(zp0, xv.y, acc[nt][1]);
      acc[nt][2] = fmaf(zp1, xv.x, acc[nt][2]);
      acc[nt][3] = fmaf(zp1, xv.y, acc[nt][3]);
    }
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < ng)
      load_stage<GS, PW, BT, F32>(a, L, smem + s * L.stage, scb, gbeg + s,
                                  gbeg, gbeg + ng, m0, b0, tid);
    cp_async_commit();
  }

  for (int it = 0; it < ng; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (has_z && it > 0) fold_z((it - 1) & 1);
    {
      const int nx = it + S - 1;
      if (nx < ng)
        load_stage<GS, PW, BT, F32>(a, L, smem + (nx % S) * L.stage, scb,
                                    gbeg + nx, gbeg, gbeg + ng, m0, b0, tid);
      cp_async_commit();
    }
    const unsigned char* st = smem + (it % S) * L.stage;
    if constexpr (F32) {
      split_stage<BT>(st, conv, L, gs, tid);
      __syncthreads();
    }
    const unsigned xaddr =
        smem_u32((F32 ? conv : st) + lrow * L.xs + lcol);
    const unsigned char* ps = st + L.x_bytes;
    // this group's column of the staged alpha and z block
    const float* sc =
        scb + ((it / SG) & 1) * (a.q + 1) * MT * SGP + it % SG;
    float xs[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (TERN) {
      // sign and mask planes in one combined pass, alpha / 2
      planes_step<GS, NB8, 1, false, true, NX>(
          ps, sc, 0, wm, g, pb, ksteps, xaddr, L.xs, L.part, warp, mlo, klo,
          mhi, khi, acc, xs);
    } else {
      // planes two at a time (the x fragments loaded once for both), the
      // sums of x in the first pass
      int p = 0;
      if (a.q >= 2) {
        if (sums)
          planes_step<GS, NB8, 2, true, false, NX>(
              ps, sc, 0, wm, g, pb, ksteps, xaddr, L.xs, L.part, warp, mlo,
              klo, mhi, khi, acc, xs);
        else
          planes_step<GS, NB8, 2, false, false, NX>(
              ps, sc, 0, wm, g, pb, ksteps, xaddr, L.xs, L.part, warp, mlo,
              klo, mhi, khi, acc, xs);
        p = 2;
      } else if (sums) {
        planes_step<GS, NB8, 1, true, false, NX>(
            ps, sc, 0, wm, g, pb, ksteps, xaddr, L.xs, L.part, warp, mlo,
            klo, mhi, khi, acc, xs);
        p = 1;
      }
      for (; p + 1 < a.q; p += 2)
        planes_step<GS, NB8, 2, false, false, NX>(
            ps, sc, p, wm, g, pb, ksteps, xaddr, L.xs, L.part, warp, mlo,
            klo, mhi, khi, acc, xs);
      if (p < a.q)
        planes_step<GS, NB8, 1, false, false, NX>(
            ps, sc, p, wm, g, pb, ksteps, xaddr, L.xs, L.part, warp, mlo,
            klo, mhi, khi, acc, xs);
    }
    if (has_z) {
      zp0 = sc[(a.arows * MT + wm + g) * SGP];
      zp1 = sc[(a.arows * MT + wm + g + 8) * SGP];
      if (sums && t == 0) {
        xsum_s[it & 1][16 * warp + g] = xs[0];
        xsum_s[it & 1][16 * warp + 8 + g] = xs[2];
      }
    }
  }
  cp_async_wait<0>();
  if (has_z && ng > 0) {
    __syncthreads();
    fold_z((ng - 1) & 1);
  }

  float* out = a.out + (size_t)blockIdx.z * a.B * a.M;
#pragma unroll
  for (int nt = 0; nt < NB8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + wm + g + (e >> 1) * 8;
      const int b = b0 + nt * 8 + 2 * t + (e & 1);
      if (m < a.M && b < a.B) out[(size_t)b * a.M + m] = acc[nt][e];
    }
}

template <int S, int GS, int PW, int NB8, bool TERN, bool F32>
cudaError_t launch_s(const Args& a, int smem, int splits, float* y,
                     cudaStream_t s) {
  auto kernel = bcq_mma_kernel<S, GS, PW, NB8, TERN, F32>;
  // the shared-memory opt-in (to the card's maximum), once per device
  static unsigned ready = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(ready >> dev & 1u)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM);
    if (e != cudaSuccess) return e;
    ready |= 1u << dev;
  }
  dim3 grid(ceil_div(a.M, MT), ceil_div(a.B, NB8 * 8), splits);
  kernel<<<grid, NT, smem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return launch_sum_splits(a.out, y, splits, (size_t)a.B * a.M, s);
}

// the stage count and compile-time shapes for NB8 n8 tiles per warp:
// the main path's group size 128 with 16-byte plane rows has them fixed
// where three stages fit (always with bf16 x: at most 180 KB at q 8;
// with f32 x up to q 4 at 64 batch rows); other shapes run the same body
// with runtime shapes, in three stages or, where those do not fit, two
template <int NB8, bool TERN, bool F32>
cudaError_t launch_nb8(const Args& a, int splits, float* y, cudaStream_t s) {
  const Layout L(a.gs, a.q, NB8 * 8, F32);
  const int s3 = L.bytes(3), s2 = L.bytes(2);
  if (a.gs == 128 && a.pw == 16 && s3 <= MAX_SMEM)
    return launch_s<3, 128, 16, NB8, TERN, F32>(a, s3, splits, y, s);
  if (s3 <= MAX_SMEM)
    return launch_s<3, 0, 0, NB8, TERN, F32>(a, s3, splits, y, s);
  if (s2 <= MAX_SMEM)
    return launch_s<2, 0, 0, NB8, TERN, F32>(a, s2, splits, y, s);
  return cudaErrorInvalidValue;
}

// batch rows per block: 32 when B fits in 32, else 64; with f32 x the
// widest of 64, 32 and 16 whose two stages fit in shared memory (no
// ternary bundle needs 16: its two planes fit 32 rows at every group
// size)
int batch_tile(int B, int q, int gs, bool ternary, bool f32) {
  int nb8 = B <= 32 ? 4 : 8;
  if (!f32) return nb8;
  for (; nb8 > (ternary ? 4 : 2); nb8 /= 2)
    if (Layout(gs, q, nb8 * 8, true).bytes(2) <= MAX_SMEM) break;
  return nb8;
}

template <bool TERN, bool F32>
cudaError_t launch_tile(const Args& a, int nb8, int splits, float* y,
                        cudaStream_t s) {
  if (nb8 == 8) return launch_nb8<8, TERN, F32>(a, splits, y, s);
  if (nb8 == 4) return launch_nb8<4, TERN, F32>(a, splits, y, s);
  if constexpr (F32 && !TERN)
    if (nb8 == 2) return launch_nb8<2, TERN, F32>(a, splits, y, s);
  return cudaErrorInvalidValue;
}

bool aligned(const void* p, int n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

cudaError_t launch_bcq_mma(const void* x, const void* packed,
                           const void* alpha, const void* z, float* y,
                           float* part, int B, int M, int N, int NB, int G,
                           int q, int gs, int splits, bool ternary,
                           bool x_is_bf16, cudaStream_t s) {
  if (gs < 16 || gs % 16 || gs > BCQ_MMA_MAX_GS || q < 1 || q > 8 ||
      (ternary && (q != 2 || z != nullptr)) ||
      N % 8 || N > NB * 8 || G * gs != NB * 8 || !aligned(x, 16) ||
      splits < 1 || splits > G || splits > 65535)
    return cudaErrorInvalidValue;
  const int per = ceil_div(G, splits);
  if (ceil_div(G, per) != splits || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const bool f32 = !x_is_bf16;
  const int nb8 = batch_tile(B, q, gs, ternary, f32);
  if (ceil_div(B, nb8 * 8) > 65535) return cudaErrorInvalidValue;
  const int pb = gs / 8;
  int pw = 1;
  const int widths[3] = {16, 8, 4};
  for (int w : widths)
    if (pb % w == 0 && NB % w == 0 && aligned(packed, w)) {
      pw = w;
      break;
    }
  Args a{x,
         static_cast<const uint8_t*>(packed),
         static_cast<const float*>(alpha),
         static_cast<const float*>(z),
         splits > 1 ? part : y,
         B, M, N, NB, G, q, gs, ternary ? 1 : q, per, pw};
  if (ternary)
    return f32 ? launch_tile<true, true>(a, nb8, splits, y, s)
               : launch_tile<true, false>(a, nb8, splits, y, s);
  return f32 ? launch_tile<false, true>(a, nb8, splits, y, s)
             : launch_tile<false, false>(a, nb8, splits, y, s);
}

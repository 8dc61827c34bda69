// The dequantizing tensor-core tile: y[B, M] = x . dequant(W)^T for bf16
// or f32 activations, the "mma_dq" route of bcq_matmul, lut_gemm and
// ternary_matmul: every call that neither the decode tile ("gemv") nor
// the tensor-core tile ("mma") takes, at any row count (bcq_matmul's and
// ternary_matmul's decode rows at group sizes 8, 16, 24 or above 256 or
// at input widths that are not a multiple of 8; the same shapes above 8
// rows for all three).
//
// Replaces, at those shapes: src/repro/kernels/bcq_matmul/bcq_matmul.py
// ::_bcq_matmul_kernel (launcher bcq_matmul_tiled) and
// src/repro/kernels/ternary_matmul/ternary_matmul.py
// ::_ternary_matmul_kernel (launcher ternary_matmul_tiled); for lut_gemm
// above 8 rows src/repro/kernels/lut_gemm/lut_gemm.py::_lut_gemm_kernel
// (launcher lut_gemm_tiled), its keyed read re-associated as on the mma
// route.  The first dequantizes its weight tile in VMEM, W = sum_i
// alpha_i (+-1)_i + z in f32, and runs one product; this tile does the
// same in registers, so the group size is only an index (k / gs) and
// every group size and input width takes the same body.
//
// What bounds it on an H100: at 8 rows or fewer, bytes (the planes, and
// at small groups the f32 alpha rows: at g 8 they are 4 bytes per 8
// weights per plane, twice the plane bytes); above, operations (two bf16
// products of the dense size for bf16 x, three for f32 x, and the
// dequantization itself on the CUDA cores, once per block).
//
// The design (mma.sync, as the "mma" tile of bcq_mma.cu):
//  - above 8 rows a block of 8 warps owns 128 weight rows x 64 batch rows
//    (32 when B is at most 32); each warp owns 16 weight rows and all the
//    block's batch rows, so each weight fragment is built once per block;
//  - at 8 rows or fewer (bcq_dq_decode_kernel, bound by bytes) a block
//    owns 64, 32 or 16 weight rows, the most whose ring leaves room for
//    two blocks an SM (16 warps to hide the latency of the dequantizing
//    chain), and one n8 tile; the 16-row slabs share each stage's columns
//    out over the 8 warps (2, 4 or 8 warps a slab), whose sums are added
//    in warp order through shared memory at the end.  Its stages are 512
//    columns (BCQ_DQ_DECODE_STEP), so each weight row's plane bytes are
//    one 64-byte run a stage and its scale rows whole lines (128 bytes at
//    g 16), and two or three stages keep 40-100 KB an SM in flight.  A
//    warp loads a row's plane bits two k16 steps (4 bytes) at a time and
//    reads a step's alpha and z once (twice where its two bytes fall in
//    two groups, as at g 8); staged plane rows are 80 bytes apart, so
//    the 8 rows a warp reads at once fall in 8 bank groups;
//  - staging: a cp.async ring of stages of ks = 64 reduction columns
//    (512 at 8 rows), not of a group, each holding its x tile (bf16 rows
//    padded by 16 bytes, so ldmatrix is conflict-free; f32 rows as they
//    are), its plane bytes (q x rows x ks/8 bytes) and the alpha (and
//    z) of every group the stage touches, per row: ks/gs values when gs
//    divides ks, one when ks divides gs, else as many as a stage can
//    reach (rounded up to a power of two).  Where gs divides ks/4 the
//    values go as 16-byte copies (rows 4 floats longer than their
//    values, 12 at 4: the 8 rows a warp reads at once fall in 8 banks);
//    x rows of any width go as
//    16-, 8-, 4- or 2-byte copies by what the width allows (so an
//    in_features that is not a multiple of 8 needs no padded copy), and
//    rows past B or M, columns past N and groups past G are zero-filled
//    by the copies themselves.  The copy loops index by shifts, not
//    divisions.  Above 8 rows three or two stages where two blocks fit an
//    SM (occupancy hides the latency of the shared-memory reads the
//    operand is built from), else three or two;
//  - the weight operand (mma A, weight rows x k) is built by each thread
//    in registers from the staged bytes: for its 8 elements of each
//    m16 x k16 fragment (rows g, g + 8; columns 2t, 2t + 1, 2t + 8,
//    2t + 9), BCQ w = sum_i (bit ? alpha_i : -alpha_i) over the planes in
//    order, then + z (the reference's order and arithmetic, in f32);
//    ternary w = mask ? (sign ? alpha : -alpha) : 0.  The group of each
//    plane byte of the stage comes from a per-stage table of 4-bit
//    slots above 8 rows, from a running count at 8 rows or fewer (a
//    division per stage, none per element).  w is split
//    into hi = bf16(w) and lo = bf16(w - hi) (w - hi - lo is below
//    2^-16 of |w|);
//  - the products, mma.sync m16n8k16 bf16 with f32 accumulation, in this
//    order per k16 step: bf16 x: hi . x for every n8 tile, then lo . x;
//    f32 x (split once per stage in shared memory into its two leading
//    bf16 parts h = bf16(x), m = bf16(x - h), as the other tiles split
//    it): hi . h, lo . h, hi . m.  The dropped products (hi . l, lo . m,
//    lo . l) are below 2^-16 of hi . h.  A stage's products go to a
//    fresh fragment that is added into the accumulator at the stage's
//    end: the tensor cores' own f32 sums (which truncate) then run over
//    4 to 16 k16 steps, not the whole reduction axis, where their error
//    grew several-fold.  No per-group partial, no alpha fold, no x-sum
//    pass: z is inside w;
//  - where the output tiles alone would leave SMs idle, the stages are
//    split over blocks (gridDim.z) whose partials are added in split
//    order by a second pass, so the result does not depend on
//    scheduling.  Blocks run batch tile fastest, so the batch tiles of
//    one weight tile share its planes and alphas through L2.
//
// ops.dq_splits counts the splits; bcq_matmul.ref.dq_split_ref is the
// plain version of this walk.  On
// exact inputs (integer x, power-of-two alphas and offsets whose sums are
// bf16 values) lo = 0, m = 0 and every product and sum is exact, so the
// tile equals the plain versions bit for bit.
#include "bcq_dq.cuh"

namespace {

constexpr int MT = BCQ_DQ_ROWS;     // weight rows per block above 8 rows
constexpr int NT = 256;             // 8 warps, 16 weight rows each
constexpr int WM = MT / (NT / 32);  // weight rows per warp
constexpr int KSD = BCQ_DQ_DECODE_STEP;  // the decode stage's columns
// a decode stage's plane bytes per weight row, and their row stride in
// shared memory: the 8 rows a warp reads at once, 80 bytes apart, fall
// in 8 bank groups (64 apart, four would share one)
constexpr int PBD = KSD / 8;
constexpr int PRD = PBD + 16;
// a block's dynamic shared memory: the card's 232,448 bytes less room
// for the static; and the most each of two blocks on one SM can take
// (228 KB an SM, 1 KB of it reserved per block)
constexpr int MAX_SMEM = 232448 - 1024;
constexpr int HALF_SM = 233472 / 2 - 1024;

struct Args {
  const void* x;  // bf16, or f32 with the F32 kernels
  const uint8_t* packed;
  const float* alpha;
  const float* z;
  float* out;     // y, or the split partials [splits, B, M]
  int B, M, N, NB, G, q, gs;
  int arows;      // alpha rows: q, or 1 for ternary
  int nst, per;   // stages, and stages per split
  int S;          // ring stages
  int xw, pw, aw;  // bytes per copy of x, of plane bytes, of scales
  int xsh, psh, ash;  // log2 of the copies per row of x, planes, scales
  int sgs, sgp;   // group slots per scale row, floats between two rows
  int xrow;       // bytes per staged x row
  int xs;         // bytes per bf16 x row (staged, or one f32 part)
  int x_bytes, p_bytes, stage;  // a stage: x tile, plane bytes, scales
  int part;       // bytes of one bf16 part of an f32 x tile
  int mtsh;       // log2 of the weight rows per block (128; 64, 32 or 16
                  // at 8 rows or fewer)
  int prs;        // bytes between two staged plane rows
};

// two 8x8 b16 matrices from shared memory (lanes 8j .. 8j + 7 give the
// row addresses of matrix j)
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr)
      : "memory");
}

// wait until the ring's oldest stage has landed (S - 2 groups may stay
// in flight)
__device__ __forceinline__ void wait_ring(int S) {
  if (S == 2)
    cp_async_wait<0>();
  else if (S == 3)
    cp_async_wait<1>();
  else
    cp_async_wait<2>();
}

// stage s: the x tile (BT rows of KS columns), the plane bytes (rows prs
// bytes apart) and the scale rows (alpha, then z) of the groups it
// touches, for 2^mtsh weight rows
template <int KS, int BT, bool F32>
__device__ __forceinline__ void load_stage(const Args& a, unsigned char* st,
                                           int s, int m0, int b0, int tid,
                                           int mtsh, int prs) {
  constexpr int PB = KS / 8;  // plane bytes per row and stage
  const int k0 = s * KS;
  {
    constexpr int ES = F32 ? 4 : 2;
    const int epc = a.xw / ES;  // x values per copy
    const int nch = 1 << a.xsh;   // KS / epc
    const unsigned char* x = static_cast<const unsigned char*>(a.x);
    for (int i = tid; i < BT * nch; i += NT) {
      const int r = i >> a.xsh, c = i & (nch - 1);
      const int b = b0 + r, k = k0 + c * epc;
      // N % epc == 0: a copy is all inside the row or all past it
      const bool ok = b < a.B && k < a.N;
      const unsigned char* src = ok ? x + ((size_t)b * a.N + k) * ES : x;
      unsigned char* dst = st + r * a.xrow + c * a.xw;
      if (a.xw == 16)
        cp_async16(dst, src, ok ? 16 : 0);
      else if (a.xw == 8)
        cp_async8(dst, src, ok ? 8 : 0);
      else if (a.xw == 4)
        cp_async4(dst, src, ok ? 4 : 0);
      else
        *reinterpret_cast<uint16_t*>(dst) =
            ok ? *reinterpret_cast<const uint16_t*>(src) : 0;
    }
  }
  {
    unsigned char* ps = st + a.x_bytes;
    const int np = 1 << a.psh;  // PB / pw
    for (int i = tid; i < (a.q << mtsh) * np; i += NT) {
      const int pr = i >> a.psh, c = i & (np - 1);
      const int p = pr >> mtsh, r = pr & ((1 << mtsh) - 1);
      const int m = m0 + r, kb = s * PB + c * a.pw;
      const bool ok = m < a.M && kb < a.NB;
      const uint8_t* src =
          ok ? a.packed + ((size_t)p * a.M + m) * a.NB + kb : a.packed;
      unsigned char* dst = ps + pr * prs + c * a.pw;
      if (a.pw == 16)
        cp_async16(dst, src, ok ? 16 : 0);
      else if (a.pw == 8)
        cp_async8(dst, src, ok ? 8 : 0);
      else if (a.pw == 4)
        cp_async4(dst, src, ok ? 4 : 0);
      else
        *dst = ok ? *src : 0;
    }
  }
  {
    float* sc = reinterpret_cast<float*>(st + a.x_bytes + a.p_bytes);
    const int g0 = k0 / a.gs;
    const int ew = a.aw / 4;  // values per copy
    const int np = 1 << a.ash;  // sgs / ew
    const int nrow = a.arows + (a.z != nullptr);
    for (int i = tid; i < (nrow << mtsh) * np; i += NT) {
      const int pr = i >> a.ash, c = i & (np - 1);
      const int p = pr >> mtsh, r = pr & ((1 << mtsh) - 1);
      const int m = m0 + r, gg = g0 + c * ew;
      // with 16-byte copies G % 4 == 0 and g0 % 4 == 0: all in or all past
      const bool ok = m < a.M && gg < a.G;
      const float* src =
          !ok ? a.alpha
              : p < a.arows ? a.alpha + ((size_t)p * a.M + m) * a.G + gg
                            : a.z + (size_t)m * a.G + gg;
      float* dst = sc + pr * a.sgp + c * ew;
      if (ew == 4)
        cp_async16(dst, src, ok ? 16 : 0);
      else
        cp_async4(dst, src, ok ? 4 : 0);
    }
  }
}

// F32: the staged f32 x tile -> its two leading bf16 parts h, m in conv
// (part j at j * a.part, rows a.xs bytes apart: the layout of a staged
// bf16 x tile)
template <int KS, int BT>
__device__ __forceinline__ void split_stage(const Args& a,
                                            const unsigned char* xf,
                                            unsigned char* conv, int tid) {
  constexpr int NCH = KS / 4;  // float4 chunks per row
  for (int i = tid; i < BT * NCH; i += NT) {
    const int r = i / NCH, c = i % NCH;
    const float4 v =
        *reinterpret_cast<const float4*>(xf + r * a.xrow + c * 16);
    unsigned lo[3], hi[3];
    split_bf16x3(make_float2(v.x, v.y), lo);
    split_bf16x3(make_float2(v.z, v.w), hi);
#pragma unroll
    for (int p = 0; p < 2; ++p)
      *reinterpret_cast<uint2*>(conv + p * a.part + r * a.xs + c * 8) =
          make_uint2(lo[p], hi[p]);
  }
}

// w += +-alpha by bits 0, 1 (the step's low byte: columns 2t, 2t + 1) and
// 8, 9 (its high byte: columns 2t + 8, 2t + 9) of u0 (row g) and u1 (row
// g + 8); w holds the A fragment's order: (g, lo), (g + 8, lo), (g, hi),
// (g + 8, hi), two columns each
__device__ __forceinline__ void add_pm(float (&w)[8], unsigned u0,
                                       unsigned u1, float a0l, float a1l,
                                       float a0h, float a1h) {
  w[0] += (u0 & 1u) ? a0l : -a0l;
  w[1] += (u0 & 2u) ? a0l : -a0l;
  w[2] += (u1 & 1u) ? a1l : -a1l;
  w[3] += (u1 & 2u) ? a1l : -a1l;
  w[4] += (u0 & 0x100u) ? a0h : -a0h;
  w[5] += (u0 & 0x200u) ? a0h : -a0h;
  w[6] += (u1 & 0x100u) ? a1h : -a1h;
  w[7] += (u1 & 0x200u) ? a1h : -a1h;
}

// w = +-alpha, add_pm's first plane (0 + (+-alpha) is +-alpha)
__device__ __forceinline__ void set_pm(float (&w)[8], unsigned u0,
                                       unsigned u1, float a0l, float a1l,
                                       float a0h, float a1h) {
  w[0] = (u0 & 1u) ? a0l : -a0l;
  w[1] = (u0 & 2u) ? a0l : -a0l;
  w[2] = (u1 & 1u) ? a1l : -a1l;
  w[3] = (u1 & 2u) ? a1l : -a1l;
  w[4] = (u0 & 0x100u) ? a0h : -a0h;
  w[5] = (u0 & 0x200u) ? a0h : -a0h;
  w[6] = (u1 & 0x100u) ? a1h : -a1h;
  w[7] = (u1 & 0x200u) ? a1h : -a1h;
}

// mask ? (sign ? alpha : -alpha) : 0 for the bit of s and k under bit
__device__ __forceinline__ float tern(unsigned s, unsigned k, unsigned bit,
                                      float al) {
  return (k & bit) ? ((s & bit) ? al : -al) : 0.f;
}

// ternary w in add_pm's order, from the sign bits s0, s1 and mask bits
// k0, k1 of rows g and g + 8 (bits 0, 1: the low byte; 8, 9: the high)
__device__ __forceinline__ void tern_w(float (&w)[8], unsigned s0,
                                       unsigned s1, unsigned k0, unsigned k1,
                                       float a0l, float a1l, float a0h,
                                       float a1h) {
  w[0] = tern(s0, k0, 1u, a0l);
  w[1] = tern(s0, k0, 2u, a0l);
  w[2] = tern(s1, k1, 1u, a1l);
  w[3] = tern(s1, k1, 2u, a1l);
  w[4] = tern(s0, k0, 0x100u, a0h);
  w[5] = tern(s0, k0, 0x200u, a0h);
  w[6] = tern(s1, k1, 0x100u, a1h);
  w[7] = tern(s1, k1, 0x200u, a1h);
}

// w += z of rows g (z0) and g + 8 (z1), the low and high byte's groups
__device__ __forceinline__ void add_z(float (&w)[8], float z0l, float z1l,
                                      float z0h, float z1h) {
  w[0] += z0l;
  w[1] += z0l;
  w[2] += z1l;
  w[3] += z1l;
  w[4] += z0h;
  w[5] += z0h;
  w[6] += z1h;
  w[7] += z1h;
}

// hi = bf16(w), lo = bf16(w - hi), as bf16 pairs (the A fragments)
__device__ __forceinline__ void split_hilo(const float (&w)[8],
                                           unsigned (&hi)[4],
                                           unsigned (&lo)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(w[2 * j], w[2 * j + 1]);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l =
        __floats2bfloat162_rn(w[2 * j] - hf.x, w[2 * j + 1] - hf.y);
    hi[j] = *reinterpret_cast<const unsigned*>(&h);
    lo[j] = *reinterpret_cast<const unsigned*>(&l);
  }
}

// above 8 rows: NB8 n8 tiles (32 or 64 batch rows), 128 weight rows
template <int NB8, bool TERN, bool F32>
__global__ void __launch_bounds__(NT, 2) bcq_dq_kernel(const Args a) {
  constexpr int BT = NB8 * 8;  // batch rows per block
  constexpr int KS = BCQ_DQ_STEP;
  constexpr int PB = KS / 8;   // plane bytes per row and stage
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* conv = smem + a.S * a.stage;  // F32: the bf16 parts
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp * WM;
  const int b0 = blockIdx.x * BT, m0 = blockIdx.y * MT;
  const int sbeg = blockIdx.z * a.per;
  const int ns = min(a.nst, sbeg + a.per) - sbeg;
  const int gb = a.gs / 8;  // plane bytes per group
  const bool has_z = a.z != nullptr;
  // ldmatrix row of this lane: matrix j = lane / 8 covers batch rows
  // (j / 2) * 8 + [0, 8) and columns (j % 2) * 8 + [0, 8) of a k16 step
  const int lrow = (lane >> 4) * 8 + (lane & 7);
  const int lcol = ((lane >> 3) & 1) * 16;

  float acc[NB8][4];
#pragma unroll
  for (int j = 0; j < NB8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int s = 0; s < a.S - 1; ++s) {
    if (s < ns)
      load_stage<KS, BT, F32>(a, smem + s * a.stage, sbeg + s, m0, b0, tid,
                              7, PB);
    cp_async_commit();
  }

  for (int it = 0; it < ns; ++it) {
    wait_ring(a.S);
    __syncthreads();
    {
      const int nx = it + a.S - 1;
      if (nx < ns)
        load_stage<KS, BT, F32>(a, smem + (nx % a.S) * a.stage, sbeg + nx,
                                m0, b0, tid, 7, PB);
      cp_async_commit();
    }
    const unsigned char* st = smem + (it % a.S) * a.stage;
    if constexpr (F32) {
      split_stage<KS, BT>(a, st, conv, tid);
      __syncthreads();
    }
    const unsigned xaddr = smem_u32((F32 ? conv : st) + lrow * a.xs + lcol);
    const unsigned char* prow = st + a.x_bytes + (wm + g) * PB;
    const float* srow =
        reinterpret_cast<const float*>(st + a.x_bytes + a.p_bytes) +
        (wm + g) * a.sgp;
    const int sp = MT * a.sgp;  // floats between two planes' scale rows
    // the stage's products, added into acc at its end (the tensor
    // cores' f32 sums then run over one stage only)
    float sacc[NB8][4];
#pragma unroll
    for (int j = 0; j < NB8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
    // the scale slot of each plane byte of the stage, 4 bits each
    unsigned long long slots = 0;
    {
      int r = ((sbeg + it) * PB) % gb, sl = 0;
#pragma unroll
      for (int bi = 0; bi < PB; ++bi) {
        slots |= static_cast<unsigned long long>(sl) << (4 * bi);
        if (++r == gb) {
          r = 0;
          ++sl;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      const int slo = static_cast<int>(slots >> (8 * kk)) & 15;
      const int shi = static_cast<int>(slots >> (8 * kk + 4)) & 15;
      float w[8];
      if constexpr (TERN) {
        // sign plane, mask plane MT rows below it; one alpha row
        const unsigned char* pp = prow + 2 * kk;
        const unsigned s0 = *reinterpret_cast<const uint16_t*>(pp) >> (2 * t);
        const unsigned s1 =
            *reinterpret_cast<const uint16_t*>(pp + 8 * PB) >> (2 * t);
        const unsigned k0 =
            *reinterpret_cast<const uint16_t*>(pp + MT * PB) >> (2 * t);
        const unsigned k1 =
            *reinterpret_cast<const uint16_t*>(pp + MT * PB + 8 * PB) >>
            (2 * t);
        tern_w(w, s0, s1, k0, k1, srow[slo], srow[8 * a.sgp + slo],
               srow[shi], srow[8 * a.sgp + shi]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) w[e] = 0.f;
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          if (p >= a.q) break;
          const unsigned char* pp = prow + p * MT * PB + 2 * kk;
          const unsigned u0 =
              *reinterpret_cast<const uint16_t*>(pp) >> (2 * t);
          const unsigned u1 =
              *reinterpret_cast<const uint16_t*>(pp + 8 * PB) >> (2 * t);
          const float* sr = srow + p * sp;
          add_pm(w, u0, u1, sr[slo], sr[8 * a.sgp + slo], sr[shi],
                 sr[8 * a.sgp + shi]);
        }
        if (has_z) {
          const float* zr = srow + a.arows * sp;
          add_z(w, zr[slo], zr[8 * a.sgp + slo], zr[shi],
                zr[8 * a.sgp + shi]);
        }
      }
      unsigned hi[4], lo[4];
      split_hilo(w, hi, lo);
      {
        // n8 tiles 2j and 2j + 1: batch rows 16 j + [0, 16); the hi
        // products of every tile, then the lo ones (no mma waits on the
        // one before it)
        unsigned r[NB8 / 2][4];
#pragma unroll
        for (int j = 0; j < NB8 / 2; ++j)
          ldsm_x4(r[j], xaddr + j * 16 * a.xs + kk * 32);
#pragma unroll
        for (int j = 0; j < NB8 / 2; ++j) {
          mma_bf16(sacc[2 * j], hi, r[j][0], r[j][1]);
          mma_bf16(sacc[2 * j + 1], hi, r[j][2], r[j][3]);
        }
#pragma unroll
        for (int j = 0; j < NB8 / 2; ++j) {
          mma_bf16(sacc[2 * j], lo, r[j][0], r[j][1]);
          mma_bf16(sacc[2 * j + 1], lo, r[j][2], r[j][3]);
        }
        if constexpr (F32) {
#pragma unroll
          for (int j = 0; j < NB8 / 2; ++j)
            ldsm_x4(r[j], xaddr + a.part + j * 16 * a.xs + kk * 32);
#pragma unroll
          for (int j = 0; j < NB8 / 2; ++j) {
            mma_bf16(sacc[2 * j], hi, r[j][0], r[j][1]);
            mma_bf16(sacc[2 * j + 1], hi, r[j][2], r[j][3]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NB8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += sacc[j][e];
  }
  cp_async_wait<0>();

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

// at 8 rows or fewer: one n8 tile, 2^a.mtsh weight rows (64, 32 or 16)
// in 16-row slabs, each stage's KSD columns shared out over the 8 / slabs
// warps of a slab, whose sums are added in warp order at the end
template <bool TERN, bool F32>
__global__ void __launch_bounds__(NT, 2) bcq_dq_decode_kernel(const Args a) {
  constexpr int BT = 8;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* conv = smem + a.S * a.stage;  // F32: the bf16 parts
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt = 1 << a.mtsh;
  const int slabs = mt >> 4;                   // 4, 2 or 1
  const int kparts = NT / 32 / slabs;          // 2, 4 or 8
  const int wm = (warp & (slabs - 1)) * 16;
  const int kpart = warp >> (a.mtsh - 4);
  const int nks = KSD / 16 / kparts;           // k16 steps per warp
  const int kb0 = kpart * nks;                 // the warp's first one
  const int m0 = blockIdx.y << a.mtsh;
  const int sbeg = blockIdx.z * a.per;
  const int ns = min(a.nst, sbeg + a.per) - sbeg;
  const int gb = a.gs / 8;  // plane bytes per group
  const bool has_z = a.z != nullptr;
  const int sp = mt * a.sgp;  // floats between two scale rows' blocks
  const int r8 = 8 * a.sgp;   // floats between rows g and g + 8
  // ldmatrix .x2 rows: lanes 0-7 the 8 batch rows at columns 0-7 of a
  // k16 step, lanes 8-15 at columns 8-15
  const int lrow = lane & 7;
  const int lcol = ((lane >> 3) & 1) * 16;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < a.S - 1; ++s) {
    if (s < ns)
      load_stage<KSD, BT, F32>(a, smem + s * a.stage, sbeg + s, m0, 0, tid,
                               a.mtsh, PRD);
    cp_async_commit();
  }

  for (int it = 0; it < ns; ++it) {
    wait_ring(a.S);
    __syncthreads();
    {
      const int nx = it + a.S - 1;
      if (nx < ns)
        load_stage<KSD, BT, F32>(a, smem + (nx % a.S) * a.stage, sbeg + nx,
                                 m0, 0, tid, a.mtsh, PRD);
      cp_async_commit();
    }
    const unsigned char* st = smem + (it % a.S) * a.stage;
    if constexpr (F32) {
      split_stage<KSD, BT>(a, st, conv, tid);
      __syncthreads();
    }
    const unsigned xaddr =
        smem_u32((F32 ? conv : st) + lrow * a.xs + lcol) + kb0 * 32;
    const unsigned char* prow = st + a.x_bytes + (wm + g) * PRD + kb0 * 2;
    const float* srow =
        reinterpret_cast<const float*>(st + a.x_bytes + a.p_bytes) +
        (wm + g) * a.sgp;
    // the slot (group less the stage's first) of this warp's next plane
    // byte, and the byte's place in its group (a division per stage)
    const int byte0 = (sbeg + it) * PBD;
    int r = (byte0 + kb0 * 2) % gb;
    int sl = (byte0 + kb0 * 2) / gb - byte0 / gb;
    float sacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int k2 = 0; k2 < nks; k2 += 2) {
      // plane bits of k16 steps k2 and k2 + 1 (4 bytes) of rows g, g + 8
      unsigned w0[8], w1[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        if (p >= (TERN ? 2 : a.q)) break;
        const unsigned char* pp = prow + p * mt * PRD + 2 * k2;
        w0[p] = *reinterpret_cast<const unsigned*>(pp);
        w1[p] = *reinterpret_cast<const unsigned*>(pp + 8 * PRD);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = k2 + h;
        // the groups of the step's low and high byte (one group unless
        // the group size is 8 or a group ends between them)
        const int sl_lo = sl;
        if (++r == gb) { r = 0; ++sl; }
        const int sl_hi = sl;
        if (++r == gb) { r = 0; ++sl; }
        const bool two = sl_hi != sl_lo;
        const int sh = 16 * h + 2 * t;
        float w[8];
        if constexpr (TERN) {
          // sign plane, then the mask plane; one alpha row
          const unsigned s0 = w0[0] >> sh, s1 = w1[0] >> sh;
          const unsigned k0 = w0[1] >> sh, k1 = w1[1] >> sh;
          const float a0l = srow[sl_lo], a1l = srow[r8 + sl_lo];
          tern_w(w, s0, s1, k0, k1, a0l, a1l, two ? srow[sl_hi] : a0l,
                 two ? srow[r8 + sl_hi] : a1l);
        } else {
          // plane 0 sets w, planes 1 .. q - 1 add to it
          {
            const float a0l = srow[sl_lo], a1l = srow[r8 + sl_lo];
            set_pm(w, w0[0] >> sh, w1[0] >> sh, a0l, a1l,
                   two ? srow[sl_hi] : a0l, two ? srow[r8 + sl_hi] : a1l);
          }
#pragma unroll
          for (int p = 1; p < 8; ++p) {
            if (p >= a.q) break;
            const float* sr = srow + p * sp;
            const float a0l = sr[sl_lo], a1l = sr[r8 + sl_lo];
            add_pm(w, w0[p] >> sh, w1[p] >> sh, a0l, a1l,
                   two ? sr[sl_hi] : a0l, two ? sr[r8 + sl_hi] : a1l);
          }
          if (has_z) {
            // z, the scale row after the q alphas
            const float* zr = srow + a.q * sp;
            const float z0l = zr[sl_lo], z1l = zr[r8 + sl_lo];
            add_z(w, z0l, z1l, two ? zr[sl_hi] : z0l,
                  two ? zr[r8 + sl_hi] : z1l);
          }
        }
        unsigned hi[4], lo[4];
        split_hilo(w, hi, lo);
        unsigned xr[2];
        ldsm_x2(xr, xaddr + kk * 32);
        mma_bf16(sacc, hi, xr[0], xr[1]);
        mma_bf16(sacc, lo, xr[0], xr[1]);
        if constexpr (F32) {
          ldsm_x2(xr, xaddr + a.part + kk * 32);
          mma_bf16(sacc, hi, xr[0], xr[1]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += sacc[e];
  }
  cp_async_wait<0>();
  // the k parts of each slab, added in warp order through shared memory
  __syncthreads();
  float4* red = reinterpret_cast<float4*>(smem);
  const int slab = warp & (slabs - 1);
  if (kpart > 0)
    red[((kpart - 1) * slabs + slab) * 32 + lane] =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  if (kpart > 0) return;
  for (int k = 1; k < kparts; ++k) {
    const float4 v = red[((k - 1) * slabs + slab) * 32 + lane];
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  }
  float* out = a.out + (size_t)blockIdx.z * a.B * a.M;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = m0 + wm + g + (e >> 1) * 8;
    const int b = 2 * t + (e & 1);
    if (m < a.M && b < a.B) out[(size_t)b * a.M + m] = acc[e];
  }
}

template <int NB8, bool TERN, bool F32>
cudaError_t launch_k(const Args& a, int smem, int splits, float* y,
                     cudaStream_t s) {
  void (*kernel)(const Args);
  if constexpr (NB8 == 1)
    kernel = bcq_dq_decode_kernel<TERN, F32>;
  else
    kernel = bcq_dq_kernel<NB8, TERN, F32>;
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
  dim3 grid(ceil_div(a.B, NB8 * 8), ceil_div(a.M, 1 << a.mtsh), splits);
  kernel<<<grid, NT, smem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return launch_sum_splits(a.out, y, splits, (size_t)a.B * a.M, s);
}

template <bool TERN, bool F32>
cudaError_t launch_nb8(const Args& a, int nb8, int smem, int splits,
                       float* y, cudaStream_t s) {
  if (nb8 == 1) return launch_k<1, TERN, F32>(a, smem, splits, y, s);
  if (nb8 == 4) return launch_k<4, TERN, F32>(a, smem, splits, y, s);
  return launch_k<8, TERN, F32>(a, smem, splits, y, s);
}

int ilog2(int v) {
  int r = 0;
  while ((1 << r) < v) ++r;
  return r;
}

bool aligned(const void* p, int n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// scale slots a stage of ks columns needs per row: the groups it can
// touch, rounded up to a power of two (the copy loop indexes by shifts)
int group_slots(int gs, int ks) {
  if (ks % gs == 0) return ks / gs;
  if (gs % ks == 0) return 1;
  int n = 1;
  while (n < (ks - 8) / gs + 2) n *= 2;
  return n < ks / 8 ? n : ks / 8;
}

}  // namespace

cudaError_t launch_bcq_dq(const void* x, const void* packed,
                          const void* alpha, const void* z, float* y,
                          float* part, int B, int M, int N, int NB, int G,
                          int q, int gs, int splits, bool ternary,
                          bool x_is_bf16, cudaStream_t s) {
  if (B < 1 || M < 1 || N < 1 || gs < 8 || gs % 8 || q < 1 || q > 8 ||
      (ternary && (q != 2 || z != nullptr)) || N > NB * 8 ||
      G * gs != NB * 8 || !aligned(x, 16) || splits < 1 || splits > 65535)
    return cudaErrorInvalidValue;
  const int nb8 = B <= 8 ? 1 : (B <= 32 ? 4 : 8);
  const int ks = nb8 == 1 ? KSD : BCQ_DQ_STEP;
  const int pb = ks / 8;
  const int nst = ceil_div(NB, pb);
  const int per = ceil_div(nst, splits);
  if (splits > nst || ceil_div(nst, per) != splits ||
      (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const bool f32 = !x_is_bf16;
  Args a{};
  a.x = x;
  a.packed = static_cast<const uint8_t*>(packed);
  a.alpha = static_cast<const float*>(alpha);
  a.z = static_cast<const float*>(z);
  a.out = splits > 1 ? part : y;
  a.B = B;
  a.M = M;
  a.N = N;
  a.NB = NB;
  a.G = G;
  a.q = q;
  a.gs = gs;
  a.arows = ternary ? 1 : q;
  a.nst = nst;
  a.per = per;
  // copy widths: x by what N allows (the base is 16-byte aligned), plane
  // bytes by NB and the base, scales 16 bytes where a stage holds whole
  // runs of 4 groups (gs dividing ks / 4) and G and the bases allow
  const int es = f32 ? 4 : 2;
  a.xw = 16;
  while (a.xw > es && N % (a.xw / es)) a.xw /= 2;
  a.pw = 1;
  for (int w = 16; w >= 4 && a.pw == 1; w /= 2)
    if (w <= pb && NB % w == 0 && aligned(packed, w)) a.pw = w;
  a.sgs = group_slots(gs, ks);
  a.aw = (ks % gs == 0 && (ks / gs) % 4 == 0 && G % 4 == 0 &&
          aligned(alpha, 16) && (z == nullptr || aligned(z, 16)))
             ? 16
             : 4;
  // scale rows: with 16-byte copies 16-byte aligned, else odd; either
  // way the 8 rows a warp reads at once fall in 8 banks
  a.sgp = a.aw == 16 ? (a.sgs == 4 ? 12 : a.sgs + 4) : (a.sgs | 1);
  a.xsh = ilog2(ks * es / a.xw);
  a.psh = ilog2(pb / a.pw);
  a.ash = ilog2(a.sgs * 4 / a.aw);
  const int bt = nb8 * 8;
  a.xs = ks * 2 + 16;
  a.xrow = f32 ? ks * 4 : a.xs;
  a.x_bytes = bt * a.xrow;
  a.part = bt * a.xs;
  a.prs = nb8 == 1 ? PRD : pb;
  const int conv = f32 ? 2 * a.part : 0;
  const int nrow = a.arows + (z != nullptr);
  // rows per block and ring stages: above 8 rows 128 rows, three or two
  // stages where two blocks fit an SM, else three or two for one block;
  // at 8 rows or fewer (bound by bytes) the most rows of 64, 32 and 16
  // that take three or two stages with two blocks an SM, else one
  a.S = 0;
  const int caps[2] = {HALF_SM, MAX_SMEM};
  for (int cap : caps)
    for (int sh = nb8 == 1 ? 6 : 7; sh >= (nb8 == 1 ? 4 : 7) && !a.S; --sh)
      for (int st = 3; st >= 2 && !a.S; --st) {
        const int stage = a.x_bytes + (q << sh) * a.prs +
                          (nrow << sh) * a.sgp * 4;
        if (st * stage + conv <= cap) {
          a.S = st;
          a.mtsh = sh;
          a.stage = stage;
          a.p_bytes = (q << sh) * a.prs;
        }
      }
  if (!a.S || ceil_div(M, 1 << a.mtsh) > 65535) return cudaErrorInvalidValue;
  const int smem = a.S * a.stage + conv;
  if (ternary)
    return f32 ? launch_nb8<true, true>(a, nb8, smem, splits, y, s)
               : launch_nb8<true, false>(a, nb8, smem, splits, y, s);
  return f32 ? launch_nb8<false, true>(a, nb8, smem, splits, y, s)
             : launch_nb8<false, false>(a, nb8, smem, splits, y, s);
}

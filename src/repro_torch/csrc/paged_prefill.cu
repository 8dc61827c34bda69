// Chunked-prefill attention on Hopper's tensor cores, from the KV block
// pool: bf16 pools, and int8 pools with per-slot scales computed in bf16.
//
// Replaces: src/repro/kernels/paged_attention/paged_attention.py
//   ::_paged_prefill_kernel (launcher paged_prefill_tiled), in its two
//   bf16-compute flavours: float pools in bf16 (k_scale=None) and int8
//   pools with k_scale / v_scale.  The f32-compute flavours stay on the
//   CUDA-core body in paged_attention.cu.
//
// What bounds it on an H100: a C-row chunk does 4 * C * L * D flops per
// (row, head) against the K/V bytes of its L live slots; at C = 512 that
// is ~200 flops per byte, near the card's bf16 ridge (~295), so it is
// bound by how fast the products run, which only the tensor cores make
// fast.  The byte bound of chip_smoke.py (each input read once) is what
// the kernel is held against.  Under the causal mask the query tiles
// walk 1 to C / 64 K/V tiles, so the last tile's serial walk, not the
// card's total rate, sets the time.
//
// What the design does about it (FlashAttention-2 on mma.sync):
//  - a block of 4 warps owns one (batch row, kv head, tile of 64 query
//    vectors); query vector row = cc * rep + r, so one staged K/V tile
//    serves all rep heads of its kv head (GQA);
//  - each warp owns 16 query vectors; q is read in its own dtype with
//    coalesced 16-byte loads, scaled in f32 and rounded to bf16 in the
//    kernel (the wrapper's (q.float() * scale).to(bf16)), staged once in
//    shared memory and held in registers as mma A fragments for the walk;
//  - K/V tiles of 64 logical slots are gathered through the block table,
//    whole pages at a time (64 / BS pages; a page larger than 64 slots is
//    cut into 64-slot tiles), each slot row copied with 16-byte cp.async
//    from its own page into a two-stage ring, one barrier per tile: tile
//    t + 1 loads while tile t is computed; rows of a table entry < 0 or
//    past the table are zero-filled and masked; the row stride is padded
//    by 16 bytes so ldmatrix (.trans for V) is conflict-free;
//  - S = Q K^T and O += P V run as bf16 mma.sync.m16n8k16 with f32
//    accumulation; the row max and sum come from quad shuffles; P is
//    rounded to bf16 in registers and is the A operand of the P V mma;
//    the output is normalized by one reciprocal per row and written in
//    out's dtype, bf16 or f32, two values per store;
//  - int8 tiles land as int8; each thread widens the bytes it copied
//    itself to bf16 (exact, by byte permutes and a float add) into one
//    of two bf16 tiles, so no extra barrier is needed; each raw score is
//    multiplied by k_scale[slot] before the running max, the running sum
//    adds the unscaled p, and the P V operand is round_bf16(p *
//    v_scale[slot]): the reference's order;
//  - causal skipping: tiles that start past the block's last query
//    position are never visited, and a warp skips those that start past
//    its own;
//  - balance: blockIdx.z takes the query tiles with the most pages to
//    walk first and then the fewest, so the blocks that share an SM carry
//    about even work; no result depends on the order blocks run in;
//  - the shared-memory opt-in is set once per device, not per launch.
// Liveness is the paged_view rule: entry >= 0, stored position == the
// slot's logical index, and pos <= the query's position.  A query vector
// with no live slot (a pad row at position -1) outputs exactly 0.
// Widths: D is zero-padded in shared memory to the next multiple of 16
// (up to PREFILL_MMA_MAX_D); rows whose byte width is not a multiple of
// 16 are staged with plain loads instead of cp.async.
#include "paged_prefill.cuh"

namespace {

constexpr int TQ = 64;       // query vectors per block
constexpr int TK = 64;       // slots per K/V tile
constexpr int THREADS = 128;

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
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

// two f32 -> one register of two bf16 (lo in the low half), rounded to
// nearest even as .to(torch.bfloat16) does
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// four int8 (one word) -> four bf16 (two words), exactly: the float
// 2^23 + (x + 128) minus 2^23 + 128 is x, and x has at most 8 significant
// bits, so its bf16 is the float's upper half.  Full-rate byte permutes
// and adds instead of quarter-rate integer-to-float conversions.
__device__ __forceinline__ void w4_from_i8(unsigned x, unsigned& lo,
                                           unsigned& hi) {
  const unsigned u = x ^ 0x80808080u;  // x + 128 in each byte
  float f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + k)) -
           8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u);
}

template <typename T>
__device__ __forceinline__ T kv_zero();
template <>
__device__ __forceinline__ __nv_bfloat16 kv_zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}
template <>
__device__ __forceinline__ int8_t kv_zero<int8_t>() {
  return 0;
}

template <bool SCALED>
struct Layout {
  int DP;        // padded width
  int RW;        // bytes per row of a bf16 tile (DP + 8 elements)
  int RS;        // bytes per row of a staged tile
  int stage;     // bytes per ring stage
  int ring;      // bytes of the two-stage ring, at offset 0
  int wide;      // int8 pools: bytes of one widened bf16 K/V tile; two
                 // of them follow the ring
  int qoff;      // the q tile: after the ring (float pools) or on the
                 // second widened tile, first written after q is read
  int total;     // dynamic shared memory
  __host__ __device__ explicit Layout(int dp) {
    DP = dp;
    RW = (dp + 8) * 2;
    RS = SCALED ? dp + 16 : RW;
    stage = 2 * TK * RS + TK * 4 + (SCALED ? 2 * TK * 4 : 0);
    ring = 2 * stage;
    wide = SCALED ? 2 * TK * RW : 0;
    qoff = ring + wide;
    total = SCALED ? ring + 2 * wide : ring + TQ * RW;
  }
};

template <typename KV, bool SCALED, int NKT>
__global__ void __launch_bounds__(THREADS)
    prefill_mma_kernel(const PrefillMmaArgs a) {
  constexpr int DP = NKT * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wmax[THREADS / 32];
  const Layout<SCALED> L(DP);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const int nrows = a.C * a.rep;
  // query tiles: the longest walks first, then the shortest, so that the
  // blocks that share an SM carry about even work
  const int nz = gridDim.z, z = blockIdx.z, half = (nz + 1) / 2;
  const int tile0 = (z < half ? nz - 1 - z : z - half) * TQ;
  const int D = a.D, BS = a.BS, Hkv = a.Hkv, rep = a.rep, pages = a.pages;
  const KV* kpool = static_cast<const KV*>(a.k);
  const KV* vpool = static_cast<const KV*>(a.v);
  // 16-byte copies and loads need 16-byte aligned bases
  const bool kv16 = ((reinterpret_cast<uintptr_t>(a.k) |
                      reinterpret_cast<uintptr_t>(a.v)) & 15) == 0;
  const bool q16 = (reinterpret_cast<uintptr_t>(a.q) & 15) == 0;

  // a width padded to DP: zero shared memory first, since the pad
  // columns [D, DP) are never written again and must read as 0 (q's pad
  // columns are 0, and 0 * garbage could be NaN)
  if (D < DP) {
    for (int i = tid * 16; i < L.total; i += THREADS * 16)
      *reinterpret_cast<uint4*>(smem + i) = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  const int TS = BS >= TK ? TK : (TK / BS) * BS;  // slots per tile
  const int total_tiles = (pages * BS + TS - 1) / TS;

  // issue the copies of tile t into ring stage st
  auto issue = [&](int st, int t) {
    unsigned char* sb = smem + st * L.stage;
    int* spos = reinterpret_cast<int*>(sb + 2 * TK * L.RS);
    float* ksc = reinterpret_cast<float*>(spos + TK);
    float* vsc = ksc + TK;
    const int s0 = t * TS;
    const int rowb = D * (int)sizeof(KV);
    // one 16-byte chunk c of slot row sl, of K and of V
    auto chunk = [&](int sl, int c) {
      const int s = s0 + sl, j = s / BS;
      const int entry =
          (sl < TS && j < pages) ? a.tables[(size_t)b * pages + j] : -1;
      const size_t off =
          entry >= 0 ? ((((size_t)entry * BS + (s - j * BS)) * Hkv + h) *
                        D) * sizeof(KV) + (size_t)c * 16
                     : 0;
      const int n = entry >= 0 ? 16 : 0;
      unsigned char* dst = sb + sl * L.RS + c * 16;
      cp_async16(dst, reinterpret_cast<const unsigned char*>(kpool) + off, n);
      cp_async16(dst + TK * L.RS,
                 reinterpret_cast<const unsigned char*>(vpool) + off, n);
    };
    if (D == DP && kv16) {
      // unpadded rows: a compile-time share of chunks per thread, so its
      // table reads issue together
      constexpr int CPR = DP * (int)sizeof(KV) / 16;
      constexpr int PER = (TK * CPR + THREADS - 1) / THREADS;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int idx = tid + k * THREADS;
        if (TK * CPR % THREADS != 0 && idx >= TK * CPR) break;
        chunk(idx / CPR, idx % CPR);
      }
    } else if (rowb % 16 == 0 && kv16) {
      const int cpr = rowb / 16;
      for (int idx = tid; idx < TK * cpr; idx += THREADS)
        chunk(idx / cpr, idx % cpr);
    } else {
      for (int idx = tid; idx < 2 * TK * D; idx += THREADS) {
        const int which = idx / (TK * D);
        const int rem = idx - which * TK * D;
        const int sl = rem / D, d = rem - sl * D;
        const int s = s0 + sl, j = s / BS;
        const int entry =
            (sl < TS && j < pages) ? a.tables[(size_t)b * pages + j] : -1;
        KV* dst = reinterpret_cast<KV*>(sb + (which * TK + sl) * L.RS);
        if (entry >= 0) {
          const KV* pool = which ? vpool : kpool;
          dst[d] = pool[(((size_t)entry * BS + (s - j * BS)) * Hkv + h) *
                            D +
                        d];
        } else {
          dst[d] = kv_zero<KV>();
        }
      }
    }
    for (int sl = tid; sl < TK; sl += THREADS) {
      const int s = s0 + sl, j = s / BS;
      const int entry =
          (sl < TS && j < pages) ? a.tables[(size_t)b * pages + j] : -1;
      if (entry >= 0) {
        const size_t slot = (size_t)entry * BS + (s - j * BS);
        cp_async4(spos + sl, a.pos + slot);
        if (SCALED) {
          cp_async4(ksc + sl, a.ks + slot * Hkv + h);
          cp_async4(vsc + sl, a.vs + slot * Hkv + h);
        }
      } else {
        spos[sl] = -1;
        if (SCALED) {
          ksc[sl] = 0.f;
          vsc[sl] = 0.f;
        }
      }
    }
  };

  // int8 pools: widen the bytes of stage st that this thread copied
  // itself (so its own cp.async wait suffices) into bf16 tile st
  auto widen = [&](int st) {
    const unsigned char* sb = smem + st * L.stage;
    unsigned char* wk = smem + L.ring + st * L.wide;
    auto chunk = [&](int sl, int c) {  // 16 int8 of K and of V
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            sb + (kv * TK + sl) * L.RS + c * 16);
        uint4 lo, hi;
        w4_from_i8(v.x, lo.x, lo.y);
        w4_from_i8(v.y, lo.z, lo.w);
        w4_from_i8(v.z, hi.x, hi.y);
        w4_from_i8(v.w, hi.z, hi.w);
        uint4* dst =
            reinterpret_cast<uint4*>(wk + (kv * TK + sl) * L.RW + c * 32);
        dst[0] = lo;
        dst[1] = hi;
      }
    };
    if (D == DP && kv16) {
      constexpr int CPR = DP / 16;
      constexpr int PER = (TK * CPR + THREADS - 1) / THREADS;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int idx = tid + k * THREADS;
        if (TK * CPR % THREADS != 0 && idx >= TK * CPR) break;
        chunk(idx / CPR, idx % CPR);
      }
    } else if (D % 16 == 0 && kv16) {
      for (int idx = tid; idx < TK * (D / 16); idx += THREADS)
        chunk(idx / (D / 16), idx % (D / 16));
    } else {
      for (int idx = tid; idx < 2 * TK * D; idx += THREADS) {
        const int row = idx / D, d = idx - row * D;  // rows K then V
        reinterpret_cast<__nv_bfloat16*>(wk + row * L.RW)[d] =
            __float2bfloat16_rn(static_cast<float>(
                reinterpret_cast<const int8_t*>(sb + row * L.RS)[d]));
      }
    }
  };

  // tile 0, the positions, then q: their latencies overlap
  if (total_tiles > 0) issue(0, 0);
  cp_async_commit();
  // this thread's two query vectors (rows g and g + 8 of its warp); the
  // block's last query position decides how many tiles it walks
  int qpos[2];
  int grow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    grow[r] = tile0 + warp * 16 + (lane >> 2) + 8 * r;
    qpos[r] = grow[r] < nrows
                  ? a.positions[(size_t)b * a.C + grow[r] / rep]
                  : -1;
  }
  // q, scaled in f32 and rounded to bf16, is staged in shared memory by
  // coalesced loads (pad columns and rows past the chunk 0), then held in
  // registers as A fragments
  unsigned char* qs = smem + L.qoff;
  auto qrow = [&](int g) {  // element offset of query vector g's row
    const int cc = g / rep, rr = g - cc * rep;
    return ((((size_t)b * a.C + cc) * Hkv + h) * rep + rr) * D;
  };
  const float* qf = static_cast<const float*>(a.q);
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q);
  if (D == DP && q16) {
    constexpr int QU = TQ * DP / 8;  // 8-value units, a multiple of THREADS
    float x[QU / THREADS][8];
#pragma unroll
    for (int k = 0; k < QU / THREADS; ++k) {
      const int idx = tid + k * THREADS;
      const int g = tile0 + idx / (DP / 8), c = idx % (DP / 8) * 8;
      if (g >= nrows) {
#pragma unroll
        for (int u = 0; u < 8; ++u) x[k][u] = 0.f;
      } else if (a.q_bf16) {
        const uint4 w = *reinterpret_cast<const uint4*>(qb + qrow(g) + c);
        const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 f = __bfloat1622float2(p2[u]);
          x[k][2 * u] = f.x;
          x[k][2 * u + 1] = f.y;
        }
      } else {
        const float4* p4 = reinterpret_cast<const float4*>(qf + qrow(g) + c);
        const float4 lo = p4[0], hi = p4[1];
        x[k][0] = lo.x; x[k][1] = lo.y; x[k][2] = lo.z; x[k][3] = lo.w;
        x[k][4] = hi.x; x[k][5] = hi.y; x[k][6] = hi.z; x[k][7] = hi.w;
      }
    }
#pragma unroll
    for (int k = 0; k < QU / THREADS; ++k) {
      const int idx = tid + k * THREADS;
      uint4 w;
      w.x = pack_bf16(x[k][0] * a.scale, x[k][1] * a.scale);
      w.y = pack_bf16(x[k][2] * a.scale, x[k][3] * a.scale);
      w.z = pack_bf16(x[k][4] * a.scale, x[k][5] * a.scale);
      w.w = pack_bf16(x[k][6] * a.scale, x[k][7] * a.scale);
      *reinterpret_cast<uint4*>(qs + idx / (DP / 8) * L.RW +
                                idx % (DP / 8) * 16) = w;
    }
  } else {
    for (int idx = tid; idx < TQ * DP; idx += THREADS) {
      const int g = tile0 + idx / DP, col = idx % DP;
      float x = 0.f;
      if (g < nrows && col < D)
        x = (a.q_bf16 ? __bfloat162float(qb[qrow(g) + col])
                      : qf[qrow(g) + col]) *
            a.scale;
      reinterpret_cast<__nv_bfloat16*>(qs + idx / DP * L.RW)[col] =
          __float2bfloat16_rn(x);
    }
  }
  // the warp's last query position
  const int wq = __reduce_max_sync(0xffffffffu, max(qpos[0], qpos[1]));
  if (lane == 0) wmax[warp] = wq;
  __syncthreads();  // q's tile and wmax
  int qmax = wmax[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) qmax = max(qmax, wmax[w]);
  const int n_t = qmax < 0 ? 0 : min(total_tiles, qmax / TS + 1);
  unsigned qa[NKT][4];
#pragma unroll
  for (int kk = 0; kk < NKT; ++kk)
    ldsm_x4(qa[kk], qs + (warp * 16 + (lane >> 3 & 1) * 8 + (lane & 7)) *
                             L.RW +
                        (16 * kk + (lane >> 4) * 8) * 2);

  float o[2 * NKT][4];
#pragma unroll
  for (int n = 0; n < 2 * NKT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float mrow[2] = {NEG_INF_F, NEG_INF_F};
  float lrow[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int t = 0; t < n_t; ++t) {
    // tile t has landed (and, for int8 pools, is widened) for every
    // thread and tile t - 1 is consumed, so tile t + 1 may refill its
    // stage while tile t is computed
    cp_async_wait<0>();
    if (SCALED) widen(t & 1);
    __syncthreads();
    if (t + 1 < n_t) issue((t + 1) & 1, t + 1);
    cp_async_commit();
    const unsigned char* sb = smem + (t & 1) * L.stage;
    const int* spos = reinterpret_cast<const int*>(sb + 2 * TK * L.RS);
    const float* ksc = reinterpret_cast<const float*>(spos + TK);
    const float* vsc = ksc + TK;
    const unsigned char* kt =
        SCALED ? smem + L.ring + (t & 1) * L.wide : sb;
    const unsigned char* vt = kt + TK * (SCALED ? L.RW : L.RS);
    const int sbase = t * TS;
    // a warp whose rows see no slot of this tile skips it (all p = 0)
    if (wq >= sbase) {
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      const int mi = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < NKT; ++kk) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          unsigned bk[4];
          const int sl = 16 * np + (mi >> 1) * 8 + (lane & 7);
          const int col = 16 * kk + (mi & 1) * 8;
          ldsm_x4(bk, kt + sl * L.RW + col * 2);
          mma_bf16(s[2 * np], qa[kk], bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qa[kk], bk[2], bk[3]);
        }
      }
      // mask, k_scale, running max over the quad
      float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * (lane & 3) + (e & 1), r = e >> 1;
          const int sg = sbase + col;
          const bool ok = spos[col] == sg && sg <= qpos[r];
          float v = s[n][e];
          if (SCALED) v *= ksc[col];
          v = ok ? v : NEG_INF_F;
          s[n][e] = v;
          mx[r] = fmaxf(mx[r], v);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = __expf(mrow[r] - mx[r]);
        mrow[r] = mx[r];
        lrow[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < 2 * NKT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
      // p (unscaled into the sum), then the P V operand
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * (lane & 3) + (e & 1), r = e >> 1;
          const float v = s[n][e];
          const float p = v == NEG_INF_F ? 0.f : __expf(v - mrow[r]);
          lrow[r] += p;
          s[n][e] = SCALED ? p * vsc[col] : p;
        }
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        const unsigned pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < NKT; ++np) {
          unsigned bv[4];
          const int sl = 16 * kk + (mi & 1) * 8 + (lane & 7);
          const int col = 16 * np + (mi >> 1) * 8;
          ldsm_x4_trans(bv, vt + sl * L.RW + col * 2);
          mma_bf16(o[2 * np], pa, bv[0], bv[1]);
          mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: the quad's row sums, o / max(l, 1e-30), out in its dtype
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
    lrow[r] = 1.f / fmaxf(lrow[r], 1e-30f);  // now its reciprocal
  }
  float* of = static_cast<float*>(a.out);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (grow[r] >= nrows) continue;
    const size_t base = qrow(grow[r]);
#pragma unroll
    for (int n = 0; n < 2 * NKT; ++n) {
      const int col = n * 8 + 2 * (lane & 3);
      const float v0 = o[n][2 * r] * lrow[r], v1 = o[n][2 * r + 1] * lrow[r];
      if (D % 2 == 0 && col < D) {  // col even: an aligned pair
        if (a.out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(ob + base + col) =
              __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(of + base + col) = make_float2(v0, v1);
      } else {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (col + u >= D) continue;
          const float v = u ? v1 : v0;
          if (a.out_bf16)
            ob[base + col + u] = __float2bfloat16_rn(v);
          else
            of[base + col + u] = v;
        }
      }
    }
  }
}

template <typename KV, bool SCALED, int NKT>
cudaError_t launch_nkt(const PrefillMmaArgs& a, cudaStream_t s) {
  const Layout<SCALED> L(NKT * 16);
  auto kernel = prefill_mma_kernel<KV, SCALED, NKT>;
  // the shared-memory opt-in, once per device (set on every launch it
  // cost the launch more than the kernel's own prologue)
  static unsigned ready = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(ready >> dev & 1u)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L.total);
    if (e != cudaSuccess) return e;
    ready |= 1u << dev;
  }
  const int tiles = ceil_div(a.C * a.rep, TQ);
  dim3 grid(a.Hkv, a.B, tiles);
  kernel<<<grid, THREADS, L.total, s>>>(a);
  return cudaGetLastError();
}

template <typename KV, bool SCALED>
cudaError_t launch(const PrefillMmaArgs& a, cudaStream_t s) {
  const int nkt = ceil_div(a.D, 16);
  if (a.D < 1 || a.D > PREFILL_MMA_MAX_D || a.B > 65535 ||
      ceil_div(a.C * a.rep, TQ) > 65535)
    return cudaErrorInvalidValue;
  switch (nkt) {
    case 1: return launch_nkt<KV, SCALED, 1>(a, s);
    case 2: return launch_nkt<KV, SCALED, 2>(a, s);
    case 3: return launch_nkt<KV, SCALED, 3>(a, s);
    case 4: return launch_nkt<KV, SCALED, 4>(a, s);
    case 5: return launch_nkt<KV, SCALED, 5>(a, s);
    case 6: return launch_nkt<KV, SCALED, 6>(a, s);
    case 7: return launch_nkt<KV, SCALED, 7>(a, s);
    case 8: return launch_nkt<KV, SCALED, 8>(a, s);
    // above 128 the width is padded to 192 or 256
    case 9: case 10: case 11: case 12:
      return launch_nkt<KV, SCALED, 12>(a, s);
    case 13: case 14: case 15: case 16:
      return launch_nkt<KV, SCALED, 16>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t prefill_mma_bf16(const PrefillMmaArgs& a, cudaStream_t s) {
  return launch<__nv_bfloat16, false>(a, s);
}

cudaError_t prefill_mma_int8(const PrefillMmaArgs& a, cudaStream_t s) {
  return launch<int8_t, true>(a, s);
}

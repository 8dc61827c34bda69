// Paged decode attention straight from the KV block pool, over float pools
// and over int8 pools with per-slot scales, split over the block table
// (flash-decoding).
//
// Replaces:
//   paged_decode      -> src/repro/kernels/paged_attention/paged_attention.py
//                        ::_paged_attn_kernel (launcher paged_attention_tiled)
//   paged_decode_int8 -> ::_paged_attn_int8_kernel (launcher
//                        paged_attention_int8_tiled)
// Both compute, per (batch row, kv head, query head of the group), one
// pre-scaled query against the row's block table with an online softmax
// and the paged_view liveness rule.
//
// What bounds it on an H100: bytes.  Every live K/V row is read once per
// (batch row, kv head) for 4 * rep flops per element (rep = query heads
// per kv head), far below the card's ~295 flops per byte; an int8 pool
// halves the bytes (plus two f32 scales per slot and head).
//
// What the design does about it:
//  - the walk is split: a block owns one (batch row, kv head, group of up
//    to 8 query heads, range of the table) and writes its partial (max,
//    sum, accumulator); the last block of each (row, head group) to
//    finish (an atomic counter per group, which it sets back to 0) merges
//    the partials in split order, so the result does not depend on
//    scheduling and no second kernel is launched.  The split count is a
//    fixed rule of B * Hkv, the table's width and the SM count
//    (ops.decode_splits); a split with no live slot merges as empty (max
//    -1e30, sum 0, accumulator 0);
//  - a block's first round trip fetches, all at once, the row's
//    position, the table entries its split touches and the raw query
//    heads; q is scaled in f32 and rounded to the compute type in the
//    kernel (the reference wrapper's (q.float() * scale).to(cdt)), and
//    the output is written in its final dtype, bf16 or f32: the wrapper
//    launches nothing else;
//  - the table is walked in tiles of 16 logical slots (one page at block
//    size 16; several pages or part of one at other sizes) through a
//    ring of 4 stages, so three tiles are in flight while one is
//    computed.  Each slot's K row and V row arrive by one TMA bulk copy
//    each, completing on the stage's mbarrier (per-thread 16-byte
//    cp.async copies of the same rows kept fewer bytes in flight and
//    were slower); its pos_pool entry and, for int8 pools, its two
//    scales by cp.async.  One barrier per tile.  Slots of a table entry
//    < 0 or past the table copy nothing and are masked; tiles past the
//    query's position are never visited;
//  - all query heads of a kv group read the staged tile once (GQA);
//  - each of the 4 warps owns 4 slots of every tile and keeps its own
//    online-softmax state (max, sum, f32 accumulator) in registers: no
//    thread runs a row's softmax alone, and warps never wait on each
//    other inside the walk.  Scores: 8 lanes per slot split the head
//    dimension over 16-byte vectors from shared memory (conflict-free:
//    each 8-lane phase reads one row's 128 contiguous bytes) and reduce
//    by shuffles; P V: each lane owns 4 columns per 128 and takes its
//    slots' probabilities by shuffles, skipping dead slots.  The 4 warp
//    states merge through shared memory at the end of the walk;
//  - int8 rows are widened exactly by byte permutes (2^23 + (x + 128)
//    minus 2^23 + 128), not by integer-to-float conversions.
// Rounding order (the reference's): q is scaled in f32 and rounded to
// the compute type (the pool's type for float pools, bf16 or f32 for
// int8 pools).  For int8 pools each raw score is multiplied by k_scale[slot,
// head] before the running max; the running sum adds the UNSCALED
// probabilities, and the P V product uses round(p * v_scale[slot, head])
// to the compute type.  For float pools p itself is rounded to the
// storage type.  p is taken against the running max of the warp's own
// slots of its split: in f32 nothing is rounded, so only the order of
// the f32 sums differs from the reference.
// Liveness is the paged_view rule: a slot counts iff its table entry is
// >= 0, its stored position equals its logical index j * BS + i, and
// pos <= the query's position.  A row with no live slot (an idle decode
// row) outputs exactly 0.
// Widths: D % 16 == 0 and D <= 256 (every served head width; a row is
// then a whole number of 16-byte units, as bulk copies need); the
// wrapper refuses others.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int NW = 4;             // warps per block
constexpr int NT = NW * 32;
constexpr int TS = 16;            // logical slots per staged tile
constexpr int SPW = TS / NW;      // slots per warp per tile
constexpr int STAGES = 4;
constexpr int MAX_D = 256;
// a block's dynamic shared memory: the card's 232,448 bytes less room
// for static buffers
constexpr int MAX_SMEM = 232448 - 1024;

static_assert(SPW * 8 == 32, "8 lanes per slot, one slot per lane group");

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// N (a multiple of 4) consecutive elements from shared memory as f32;
// every conversion is exact
template <int N>
__device__ __forceinline__ void ld_f32(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 u = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = u.x;
    v[4 * i + 1] = u.y;
    v[4 * i + 2] = u.z;
    v[4 * i + 3] = u.w;
  }
}

__device__ __forceinline__ void bf16x2_f32(unsigned w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

template <int N>
__device__ __forceinline__ void ld_f32(const __nv_bfloat16* p,
                                       float (&v)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      bf16x2_f32(u.x, v + 8 * i);
      bf16x2_f32(u.y, v + 8 * i + 2);
      bf16x2_f32(u.z, v + 8 * i + 4);
      bf16x2_f32(u.w, v + 8 * i + 6);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint2 u = reinterpret_cast<const uint2*>(p)[i];
      bf16x2_f32(u.x, v + 4 * i);
      bf16x2_f32(u.y, v + 4 * i + 2);
    }
  }
}

// four int8 (one word) -> four f32, exactly: the float 2^23 + (x + 128)
// minus 2^23 + 128 is x.  Byte permutes and adds instead of
// quarter-rate integer-to-float conversions.
__device__ __forceinline__ void i8x4_f32(unsigned x, float* v) {
  const unsigned u = x ^ 0x80808080u;  // x + 128 in each byte
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + k)) -
           8388736.f;
}

template <int N>
__device__ __forceinline__ void ld_f32(const int8_t* p, float (&v)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint2 u = reinterpret_cast<const uint2*>(p)[i];
      i8x4_f32(u.x, v + 8 * i);
      i8x4_f32(u.y, v + 8 * i + 4);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      i8x4_f32(reinterpret_cast<const unsigned*>(p)[i], v + 4 * i);
  }
}

struct DecodeArgs {
  const void* q;          // [B, Hkv, rep, D], bf16 or f32, unscaled
  const void* k;          // pools [NB, BS, Hkv, D]
  const void* v;
  const float* ks;        // int8 pools: [NB, BS, Hkv] (else null)
  const float* vs;
  const int* pos;         // [NB, BS]
  const int* tables;      // [B, pages]
  const int* positions;   // [B]
  void* out;              // [B, Hkv, rep, D], bf16 or f32
  float* part_o;          // splits > 1: [splits, B, Hkv, rep, D]
  float* part_ml;         // splits > 1: [splits, B, Hkv, rep, 2]
  int* sem;               // splits > 1: [B, Hkv * nrc], zero between calls
  int B, Hkv, rep, D, BS, pages;
  float scale;
  int q_bf16, out_bf16;
  int nrc;                // blocks per kv head (groups of up to RB heads)
  int splits, per;        // table splits, tiles per split
  int nent;               // most table entries one split's tiles touch
};

// shared-memory layout: a ring of STAGES tiles (K rows, V rows, pos, and
// for int8 pools k_scale and v_scale), the query heads (rounded to the
// compute type, held as f32), the raw query heads as they arrive and the
// split's table entries; the warps' final states reuse the ring
struct Layout {
  int row;    // bytes per K or V row
  int stage;  // one tile
  int ring;   // the ring, or the merge buffers where those are larger
  int qs;     // the query heads, rounded to the compute type, as f32
  int qraw;   // the query heads, as they arrive (at most f32)
  int total;
  __host__ __device__ Layout(int D, int kv_size, int rb, bool scaled,
                             int nent) {
    row = D * kv_size;
    stage = 2 * TS * row + TS * 4 + (scaled ? 2 * TS * 4 : 0);
    const int merge = (2 * NW * rb + NW * rb * D) * 4;
    ring = STAGES * stage > merge ? STAGES * stage : merge;
    qs = rb * D * 4;
    qraw = rb * D * 4;
    total = ring + qs + qraw + nent * 4;
  }
};

// Q: the compute type q and p are rounded to; KV: the pool's
// storage type; SCALED: int8 pools with per-slot k/v scales; RB: query
// heads per block (a power of two >= the block's heads); KD: columns
// per lane in P V over 128 (1 for D <= 128, 2 up to 256).
template <typename Q, typename KV, bool SCALED, int RB, int KD>
__global__ void __launch_bounds__(NT) paged_decode_kernel(const DecodeArgs a) {
  constexpr int EV = sizeof(KV) == 4 ? 4 : 8;  // elements per score vector
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int qpos_s, last_s;
  __shared__ __align__(8) uint64_t mbar[STAGES];  // one per ring stage
  const int D = a.D;
  const Layout L(D, sizeof(KV), RB, SCALED, a.nent);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 3, gl = lane & 7;
  const int split = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y / a.nrc, r0 = (blockIdx.y % a.nrc) * RB;
  const int nr = min(RB, a.rep - r0);
  const int ntab = cdiv(a.pages * a.BS, TS);
  const int t0 = split * a.per, tend = min(t0 + a.per, ntab);
  // the pages this split's tiles touch: entries j0 .. j0 + nent - 1
  const int j0 = t0 * TS / a.BS;
  const int nent =
      tend > t0 ? min(a.pages - 1, (tend * TS - 1) / a.BS) - j0 + 1 : 0;
  // q as f32, each score vector's EV values in EV / 4 runs of 4 (run h
  // of vector vi of head r at ((r * EV / 4 + h) * nv + vi) * 4): a lane
  // reads its vector with 16-byte loads that 8 lanes take conflict-free
  constexpr int QH = EV / 4;
  const int nv = D / EV;
  float* qs = reinterpret_cast<float*>(smem + L.ring);
  unsigned char* qraw = smem + L.ring + L.qs;
  int* ent = reinterpret_cast<int*>(qraw + L.qraw);

  // the row's position, the split's table entries and the raw query
  // heads, all in flight at once (one dependent round trip before the
  // first K/V copy), then q scaled in f32 and rounded to the compute type
  // as the reference's wrapper does it
  {
    if (tid == 0) cp_async4(&qpos_s, a.positions + b);
    for (int i = tid; i < nent; i += NT)
      cp_async4(ent + i, a.tables + (size_t)b * a.pages + j0 + i);
    const int qb = a.q_bf16 ? 2 : 4;
    const unsigned char* qsrc = static_cast<const unsigned char*>(a.q) +
                                (((size_t)b * a.Hkv + h) * a.rep + r0) * D *
                                    qb;
    for (int i = tid; i < nr * D * qb / 16; i += NT)
      cp_async16(qraw + 16 * i, qsrc + 16 * i, 16);
    if (tid == 0) {
      for (int st = 0; st < STAGES; ++st) mbar_init(&mbar[st], TS);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int i = tid; i < RB * D; i += NT) {
      float x = 0.f;
      if (i < nr * D)
        x = a.q_bf16
                ? __bfloat162float(
                      reinterpret_cast<const __nv_bfloat16*>(qraw)[i])
                : reinterpret_cast<const float*>(qraw)[i];
      const int r = i / D, d = i - r * D, e = d % EV;
      qs[((r * QH + e / 4) * nv + d / EV) * 4 + e % 4] =
          round_to<Q>(x * a.scale);
    }
  }
  const int qpos = qpos_s;
  const int nlive = qpos < 0 ? 0 : min(ntab, qpos / TS + 1);
  const int t1 = min(tend, nlive);

  // stage tile t (logical slots t * TS .. + TS) into ring stage st: lane
  // q < SPW of warp w takes slot SPW w + q, looks up its page once, and
  // issues a TMA bulk copy of its K row and of its V row (arriving on the
  // stage's mbarrier with their bytes) and cp.async copies of its
  // pos_pool entry and scales.  A slot of a table entry < 0 or past the
  // table copies nothing: its position reads -1, so it is masked
  // (scores replaced, P V skipped) whatever its rows hold.
  auto load_tile = [&](int t, int st) {
    if (lane >= SPW) return;
    unsigned char* base = smem + st * L.stage;
    int* ps = reinterpret_cast<int*>(base + 2 * TS * L.row);
    float* sc = reinterpret_cast<float*>(ps + TS);
    const int r = warp * SPW + lane;
    const int ls = t * TS + r, j = ls / a.BS, ii = ls - j * a.BS;
    const int e = j < a.pages ? ent[j - j0] : -1;
    mbar_expect_tx(&mbar[st], e >= 0 ? 2 * L.row : 0);
    if (e >= 0) {
      const size_t slot = (size_t)e * a.BS + ii;
      const size_t off = (slot * a.Hkv + h) * L.row;
      bulk_copy(base + r * L.row, static_cast<const unsigned char*>(a.k) + off,
                L.row, &mbar[st]);
      bulk_copy(base + (TS + r) * L.row,
                static_cast<const unsigned char*>(a.v) + off, L.row,
                &mbar[st]);
      cp_async4(ps + r, a.pos + slot);
      if constexpr (SCALED) {
        cp_async4(sc + r, a.ks + slot * a.Hkv + h);
        cp_async4(sc + TS + r, a.vs + slot * a.Hkv + h);
      }
    } else {
      ps[r] = -1;
      if constexpr (SCALED) sc[r] = sc[TS + r] = 0.f;
    }
  };

  float m[RB], l[RB], acc[RB][KD][4];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = NEG_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int k = 0; k < KD; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][k][e] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (t0 + s < t1) load_tile(t0 + s, s);
    cp_async_commit();
  }

  for (int t = t0; t < t1; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    {
      const int nx = t + STAGES - 1;
      if (nx < t1) load_tile(nx, (nx - t0) % STAGES);
      cp_async_commit();
    }
    mbar_wait(&mbar[(t - t0) % STAGES], ((t - t0) / STAGES) & 1);
    const unsigned char* base = smem + ((t - t0) % STAGES) * L.stage;
    const KV* ks = reinterpret_cast<const KV*>(base);
    const KV* vs = ks + TS * D;
    const int* ps = reinterpret_cast<const int*>(base + 2 * TS * L.row);
    const float* ksc = reinterpret_cast<const float*>(ps + TS);
    const float* vsc = ksc + TS;

    // scores of this lane group's slot, all heads: 8 lanes split D
    const int slot = warp * SPW + grp;
    const int ls = t * TS + slot;
    const bool live = ps[slot] == ls && ls <= qpos;
    float s[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) s[r] = 0.f;
    for (int vi = gl; vi * EV < D; vi += 8) {
      float kf[EV];
      ld_f32<EV>(ks + slot * D + vi * EV, kf);
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int hh = 0; hh < QH; ++hh) {
          const float4 qv = *reinterpret_cast<const float4*>(
              qs + ((r * QH + hh) * nv + vi) * 4);
          s[r] = fmaf(qv.x, kf[4 * hh], s[r]);
          s[r] = fmaf(qv.y, kf[4 * hh + 1], s[r]);
          s[r] = fmaf(qv.z, kf[4 * hh + 2], s[r]);
          s[r] = fmaf(qv.w, kf[4 * hh + 3], s[r]);
        }
    }
    float pw[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float v = s[r];
      v += __shfl_xor_sync(~0u, v, 1);
      v += __shfl_xor_sync(~0u, v, 2);
      v += __shfl_xor_sync(~0u, v, 4);
      if constexpr (SCALED) v *= ksc[slot];
      v = live ? v : NEG_INF_F;
      // the tile's max over the warp's slots, then the online update
      float mt = fmaxf(v, __shfl_xor_sync(~0u, v, 8));
      mt = fmaxf(mt, __shfl_xor_sync(~0u, mt, 16));
      const float mn = fmaxf(m[r], mt);
      const float corr = expf(m[r] - mn);
      const float p = live ? expf(v - mn) : 0.f;
      float psum = p + __shfl_xor_sync(~0u, p, 8);
      psum += __shfl_xor_sync(~0u, psum, 16);
      l[r] = l[r] * corr + psum;
      m[r] = mn;
      pw[r] = round_to<Q>(SCALED ? p * vsc[slot] : p);
#pragma unroll
      for (int k = 0; k < KD; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][k][e] *= corr;
    }
    // P V over the warp's slots: lane owns columns 4 (lane + 32 k) .. + 3
    const unsigned lm = __ballot_sync(~0u, live);
#pragma unroll
    for (int j = 0; j < SPW; ++j) {
      float pj[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) pj[r] = __shfl_sync(~0u, pw[r], 8 * j);
      if (!((lm >> (8 * j)) & 1u)) continue;  // uniform across the warp
      const KV* vrow = vs + (warp * SPW + j) * D;
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        const int d0 = 4 * (lane + 32 * k);
        if (d0 >= D) continue;
        float vf[4];
        ld_f32<4>(vrow + d0, vf);
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[r][k][e] = fmaf(pj[r], vf[e], acc[r][k][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the 4 warps' states (in the ring, no longer read)
  float* mw = reinterpret_cast<float*>(smem);  // [NW][RB]
  float* lw = mw + NW * RB;                    // [NW][RB]
  float* ow = lw + NW * RB;                    // [NW][RB][D]
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      mw[warp * RB + r] = m[r];
      lw[warp * RB + r] = l[r];
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int k = 0; k < KD; ++k) {
      const int d0 = 4 * (lane + 32 * k);
      if (d0 < D)
        *reinterpret_cast<float4*>(ow + (warp * RB + r) * D + d0) =
            make_float4(acc[r][k][0], acc[r][k][1], acc[r][k][2],
                        acc[r][k][3]);
    }
  __syncthreads();
  const size_t rows = (size_t)a.B * a.Hkv * a.rep;
  const size_t row0 = ((size_t)b * a.Hkv + h) * a.rep + r0;
  auto store = [&](size_t i, float v) {
    if (a.out_bf16)
      static_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16(v);
    else
      static_cast<float*>(a.out)[i] = v;
  };
  for (int i = tid; i < nr * D; i += NT) {
    const int r = i / D, d = i - r * D;
    float mx = NEG_INF_F;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, mw[w * RB + r]);
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(mw[w * RB + r] - mx);
      sum = fmaf(lw[w * RB + r], f, sum);
      o = fmaf(ow[(w * RB + r) * D + d], f, o);
    }
    const size_t row = row0 + r;
    if (a.splits == 1) {
      store(row * D + d, o / fmaxf(sum, 1e-30f));
    } else {
      a.part_o[((size_t)split * rows + row) * D + d] = o;
      if (d == 0) {
        a.part_ml[((size_t)split * rows + row) * 2] = mx;
        a.part_ml[((size_t)split * rows + row) * 2 + 1] = sum;
      }
    }
  }
  if (a.splits == 1) return;

  // the last split of this (row, head group) to finish merges all of
  // them in split order (so the result does not depend on which block
  // that is) and sets the group's counter back to 0 for the next call
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int g = b * gridDim.y + blockIdx.y;
    last_s = atomicAdd(a.sem + g, 1) == a.splits - 1;
    if (last_s) a.sem[g] = 0;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int i = tid; i < nr * D; i += NT) {
    const int r = i / D, d = i - r * D;
    const size_t row = row0 + r;
    float mx = NEG_INF_F;
    for (int sp = 0; sp < a.splits; ++sp)
      mx = fmaxf(mx, __ldcg(a.part_ml + ((size_t)sp * rows + row) * 2));
    float sum = 0.f, o = 0.f;
    for (int sp = 0; sp < a.splits; ++sp) {
      const size_t pr = (size_t)sp * rows + row;
      const float f = expf(__ldcg(a.part_ml + pr * 2) - mx);
      sum = fmaf(__ldcg(a.part_ml + pr * 2 + 1), f, sum);
      o = fmaf(__ldcg(a.part_o + pr * D + d), f, o);
    }
    store(row * D + d, o / fmaxf(sum, 1e-30f));
  }
}

template <typename Q, typename KV, bool SCALED, int RB, int KD>
cudaError_t launch_rk(const DecodeArgs& a, cudaStream_t s) {
  auto kernel = paged_decode_kernel<Q, KV, SCALED, RB, KD>;
  const Layout L(a.D, sizeof(KV), RB, SCALED, a.nent);
  if (L.total > MAX_SMEM) return cudaErrorInvalidValue;
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
  dim3 grid(a.splits, a.Hkv * a.nrc, a.B);
  kernel<<<grid, NT, L.total, s>>>(a);
  return cudaGetLastError();
}

template <typename Q, typename KV, bool SCALED, int RB>
cudaError_t launch_r(const DecodeArgs& a, cudaStream_t s) {
  return a.D <= 128 ? launch_rk<Q, KV, SCALED, RB, 1>(a, s)
                    : launch_rk<Q, KV, SCALED, RB, 2>(a, s);
}

bool aligned(const void* p, int n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// checks the call, fills in the derived fields and picks the heads per
// block: the GQA group if it is at most 8 heads (rounded up to a power
// of two), else groups of 8
template <typename Q, typename KV, bool SCALED>
cudaError_t decode_t(DecodeArgs a, cudaStream_t s) {
  if (a.B < 1 || a.Hkv < 1 || a.rep < 1 || a.BS < 1 || a.pages < 1 ||
      a.D < 16 || a.D % 16 || a.D > MAX_D || a.splits < 1 ||
      a.B > 65535 || a.splits > 65535 || !aligned(a.q, 16))
    return cudaErrorInvalidValue;
  const int ntab = ceil_div(a.pages * a.BS, TS);
  a.per = ceil_div(ntab, a.splits);
  if (ceil_div(ntab, a.per) != a.splits ||
      (a.splits > 1 && (a.part_o == nullptr || a.part_ml == nullptr ||
                        a.sem == nullptr)))
    return cudaErrorInvalidValue;
  a.nent = std::min(a.pages, (a.per * TS - 1) / a.BS + 2);
  if (!aligned(a.k, 16) || !aligned(a.v, 16)) return cudaErrorInvalidValue;
  const int rb = a.rep <= 1 ? 1 : a.rep <= 2 ? 2 : a.rep <= 4 ? 4 : 8;
  a.nrc = ceil_div(a.rep, rb);
  if (a.Hkv * a.nrc > 65535) return cudaErrorInvalidValue;
  switch (rb) {
    case 1: return launch_r<Q, KV, SCALED, 1>(a, s);
    case 2: return launch_r<Q, KV, SCALED, 2>(a, s);
    case 4: return launch_r<Q, KV, SCALED, 4>(a, s);
    default: return launch_r<Q, KV, SCALED, 8>(a, s);
  }
}

}  // namespace

// Float pools (bf16 or f32; p rounded to the pool's type).  q arrives
// unscaled in bf16 or f32 (q_is_bf16); the kernel scales it in f32 and
// rounds it to the pool's type, and writes out in bf16 or f32
// (out_is_bf16).  With splits > 1, part_o f32 [splits, B, Hkv, rep, D]
// and part_ml f32 [splits, B, Hkv, rep, 2] hold the partials, and sem
// int32 [B, Hkv * ceil(rep / 8)], all zero, counts each group's finished
// splits (the last one merges and zeroes it again).
extern "C" int launch_paged_decode(const void* q, const void* k,
                                   const void* v, const void* pos,
                                   const void* tables, const void* positions,
                                   void* out, void* part_o, void* part_ml,
                                   void* sem, int B, int C, int Hkv, int rep,
                                   int D, int BS, int pages, int kv_is_bf16,
                                   float scale, int q_is_bf16,
                                   int out_is_bf16, int splits,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C != 1) return static_cast<int>(cudaErrorInvalidValue);
  const DecodeArgs a{q, k, v, nullptr, nullptr,
                     static_cast<const int*>(pos),
                     static_cast<const int*>(tables),
                     static_cast<const int*>(positions), out,
                     static_cast<float*>(part_o),
                     static_cast<float*>(part_ml), static_cast<int*>(sem),
                     B, Hkv, rep, D, BS, pages, scale, q_is_bf16,
                     out_is_bf16, 1, splits, 0, 0};
  return static_cast<int>(
      kv_is_bf16 ? decode_t<__nv_bfloat16, __nv_bfloat16, false>(a, s)
                 : decode_t<float, float, false>(a, s));
}

// int8 pools: k/v int8, k_scale / v_scale f32 [NB, BS, Hkv], computed in
// bf16 (the reference's compute type; compute_bf16) or f32; q, out and
// the partials as for float pools
extern "C" int launch_paged_decode_int8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pos, const void* tables,
    const void* positions, void* out, void* part_o, void* part_ml, void* sem,
    int B, int C, int Hkv, int rep, int D, int BS, int pages,
    int compute_bf16, float scale, int q_is_bf16, int out_is_bf16,
    int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C != 1) return static_cast<int>(cudaErrorInvalidValue);
  const DecodeArgs a{q, k, v, static_cast<const float*>(ks),
                     static_cast<const float*>(vs),
                     static_cast<const int*>(pos),
                     static_cast<const int*>(tables),
                     static_cast<const int*>(positions), out,
                     static_cast<float*>(part_o),
                     static_cast<float*>(part_ml), static_cast<int*>(sem),
                     B, Hkv, rep, D, BS, pages, scale, q_is_bf16,
                     out_is_bf16, 1, splits, 0, 0};
  return static_cast<int>(
      compute_bf16 ? decode_t<__nv_bfloat16, int8_t, true>(a, s)
                   : decode_t<float, int8_t, true>(a, s));
}

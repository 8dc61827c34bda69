// Absorbed MLA decode attention straight from the latent block pool.
//
// Replaces: src/repro/kernels/paged_attention/paged_attention.py
//           ::_paged_attn_mla_kernel (launcher paged_attention_mla_tiled).
//
// What it computes, per batch row b and query head h:
//   s[k]  = (q_eff[b,h] . ckv[k] + q_rope[b,h] . krope[k]) * scale
//   ctx   = softmax over the row's live slots of s, times ckv  -> [lora]
// The caller absorbs w_uk into q_eff before and applies w_uv after, so
// the kernel never sees per-head K or V: every head of a row reads the
// same latent slots (kv_lora + qk_rope values each, 576 bytes in bf16 at
// MiniCPM3's 256 + 32).
//
// What bounds it on an H100: each live page is needed once per batch
// row, and the work per byte is 4 flops per head (score and context),
// about 80 flops per latent byte at 40 heads: far below the ~295 at
// which bf16 tensor cores would be the limit, so it is bound by bytes.
// At B = 8 the latent of a 150-page cache is 1.4 MB, under a
// microsecond of HBM time, so launch latency and the per-page
// load-to-use latency dominate.
//
// What the design does about it:
//  * One block owns one batch row and a tile of HEADS_PER_BLOCK heads,
//    one warp per head.  It stages each live page in shared memory once,
//    in the pool's type, as combined rows [ckv | krope] (one per slot),
//    and every warp of the tile reads it from there: the latent is read
//    once per head tile instead of once per head (40x fewer bytes than a
//    per-head walk).
//  * The Pallas grid (B, H / block_h, pages) carries (m, l, out) across
//    its sequential page axis in VMEM scratch; CUDA blocks run in no
//    order, so the block walks its row's block table itself.  Pages are
//    double-buffered: cp.async copies page j+1 into the other buffer
//    while the warps compute on page j.
//  * A lane accumulates partial dots for 16 slots at once over the dims
//    lane + 32 k (16 independent FMA chains), and one butterfly that
//    halves the values a lane keeps at each step sums them over the warp
//    (16 shuffles per 16 slots, where a reduction per slot takes 80):
//    lane l then holds slot l / 2's score, and the page's max, sum and
//    probabilities take four more shuffles each.  Each warp's [q_eff |
//    q_rope] row and f32 context accumulator live in shared memory, each
//    entry owned by one lane, so the loops over the width stay rolled:
//    the code is small and every register index is a constant.  (Fully
//    unrolled loops over 16 slots x the width, with q and the accumulator
//    in registers, measured 0.33 ms at the main-path case; this layout
//    0.087 ms.)
//  * H need not be a power of two or a multiple of the tile: warps past
//    H stage pages with the others but compute nothing.
// Liveness is the reference's: a table entry < 0 is not allocated and
// its page is skipped outright (the reference reads trash block 0 and
// masks it); a slot is live only if its stored position equals its
// logical index j * BS + i (a recycled block holds stale positions) and
// is <= positions[b].  Pages past positions[b] / BS hold no live slot and
// are not visited.  A row with no live slot outputs zeros (l is clamped
// at 1e-30 and the accumulator stays 0), never NaN.
// Rounding: q_eff and q_rope arrive in f32 and stay so (no rounding to
// the pool type); pool values are converted to f32 on read; scores,
// softmax and the context accumulate in f32, as in the reference.  Only
// the summation order differs from the plain version.
#include "common.cuh"

namespace {

constexpr int HEADS_PER_BLOCK = 8;   // warps per block
constexpr int SLOTS = 16;            // slots scored at once (two lanes each)

// the next allocated page after j that can hold a live slot, or -1
__device__ __forceinline__ int next_page(const int* __restrict__ table,
                                         int j, int last) {
  for (++j; j <= last; ++j)
    if (table[j] >= 0) return j;
  return -1;
}

// Copy one page's latent rows into shared memory as combined rows
// [ckv | krope] of lora + dr values (one row per slot), and its slot
// positions.  VEC: both parts of every row start on 16-byte boundaries
// (checked by the launcher), so they go as 16-byte cp.async; otherwise
// element by element (synchronous, the same result).
template <typename T, bool VEC>
__device__ __forceinline__ void stage_page(T* rows, int* pos_s,
                                           const T* __restrict__ ckv,
                                           const T* __restrict__ krope,
                                           const int* __restrict__ pos_pool,
                                           int entry, int BS, int lora,
                                           int dr) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int KD = lora + dr;
  const T* ck_g = ckv + (size_t)entry * BS * lora;
  const T* kr_g = krope + (size_t)entry * BS * dr;
  if (VEC) {
    constexpr int E = 16 / sizeof(T);
    const int cpr = lora / E, rpr = dr / E;   // 16-byte chunks per row
    for (int i = tid; i < BS * cpr; i += nt) {
      const int r = i / cpr, c = i - r * cpr;
      cp_async16(rows + r * KD + c * E, ck_g + (size_t)i * E);
    }
    for (int i = tid; i < BS * rpr; i += nt) {
      const int r = i / rpr, c = i - r * rpr;
      cp_async16(rows + r * KD + lora + c * E, kr_g + (size_t)i * E);
    }
  } else {
    for (int i = tid; i < BS * KD; i += nt) {
      const int r = i / KD, d = i - r * KD;
      rows[i] = d < lora ? ck_g[r * lora + d] : kr_g[r * dr + (d - lora)];
    }
  }
  for (int i = tid; i < BS; i += nt)
    cp_async4(pos_s + i, pos_pool + (size_t)entry * BS + i);
}

// One butterfly step: lanes whose bit O is clear keep slots [0, HALF) of
// their values and send [HALF, 2 HALF); the others the reverse.
template <int HALF, int O>
__device__ __forceinline__ void keep_half(float (&v)[SLOTS], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// Sum each lane's 16 per-slot partials over the warp: four butterfly
// steps that halve the values a lane keeps, so lane l ends with the full
// sum of slot (l >> 1) & 15 (the same value in lanes 2s and 2s+1) after
// 8 + 4 + 2 + 1 + 1 shuffles, in a fixed order.  Every index is a
// compile-time constant, so v stays in registers.
__device__ __forceinline__ float slot_sums(float (&v)[SLOTS], int lane) {
  keep_half<8, 16>(v, lane);
  keep_half<4, 8>(v, lane);
  keep_half<2, 4>(v, lane);
  keep_half<1, 2>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// shared memory of one launch: two page buffers of combined rows and
// slot positions, then each warp's q row and context accumulator
struct Layout {
  size_t rows, pos, buf, q, acc;
  __host__ __device__ Layout(int BS, int lora, int dr, size_t elem) {
    rows = ((size_t)BS * (lora + dr) * elem + 15) / 16 * 16;
    pos = ((size_t)BS * sizeof(int) + 15) / 16 * 16;
    buf = rows + pos;
    q = (size_t)HEADS_PER_BLOCK * (lora + dr) * sizeof(float);
    acc = (size_t)HEADS_PER_BLOCK * lora * sizeof(float);
  }
  size_t bytes() const { return 2 * buf + q + acc; }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(HEADS_PER_BLOCK * 32)
    paged_decode_mla_kernel(const float* __restrict__ q_eff,
                            const float* __restrict__ q_rope,
                            const T* __restrict__ ckv,
                            const T* __restrict__ krope,
                            const int* __restrict__ pos_pool,
                            const int* __restrict__ tables,
                            const int* __restrict__ positions,
                            float* __restrict__ out, int H, int lora, int dr,
                            int BS, int pages, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x * HEADS_PER_BLOCK + warp;
  const bool active = h < H;
  const int KD = lora + dr;
  const Layout L(BS, lora, dr, sizeof(T));
  // each lane owns entries d = lane + 32 k of its warp's q row and
  // accumulator, so neither needs a barrier
  float* qs = reinterpret_cast<float*>(smem_raw + 2 * L.buf) + warp * KD;
  float* acc = reinterpret_cast<float*>(smem_raw + 2 * L.buf + L.q) +
               warp * lora;
  for (int d = lane; d < KD; d += 32) {
    float v = 0.f;
    if (active)
      v = d < lora ? q_eff[((size_t)b * H + h) * lora + d]
                   : q_rope[((size_t)b * H + h) * dr + (d - lora)];
    qs[d] = v;
    if (d < lora) acc[d] = 0.f;
  }
  float m = NEG_INF_F, l = 0.f;

  const int qpos = positions[b];
  const int last = qpos < 0 ? -1 : min(pages - 1, qpos / BS);
  const int* table = tables + (size_t)b * pages;

  int j = next_page(table, -1, last);
  if (j >= 0)
    stage_page<T, VEC>(reinterpret_cast<T*>(smem_raw),
                       reinterpret_cast<int*>(smem_raw + L.rows), ckv, krope,
                       pos_pool, table[j], BS, lora, dr);
  cp_async_commit();
  int buf = 0;
  while (j >= 0) {
    const int jn = next_page(table, j, last);
    if (jn >= 0) {
      unsigned char* nb = smem_raw + (buf ^ 1) * L.buf;
      stage_page<T, VEC>(reinterpret_cast<T*>(nb),
                         reinterpret_cast<int*>(nb + L.rows), ckv, krope,
                         pos_pool, table[jn], BS, lora, dr);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // page j is in buffer `buf` for every thread

    if (active) {
      const unsigned char* cb = smem_raw + buf * L.buf;
      const T* rows = reinterpret_cast<const T*>(cb);
      const int* sp = reinterpret_cast<const int*>(cb + L.rows);
      for (int s0 = 0; s0 < BS; s0 += SLOTS) {
        const int ns = min(SLOTS, BS - s0);
        // slots past the page (ns < SLOTS) read its last row and are
        // masked below, so the slot loops need no branch
        int ro[SLOTS];
#pragma unroll
        for (int i = 0; i < SLOTS; ++i) ro[i] = min(s0 + i, BS - 1) * KD;
        // per-lane partial dots of the SLOTS slots over this lane's dims
        float v[SLOTS];
#pragma unroll
        for (int i = 0; i < SLOTS; ++i) v[i] = 0.f;
        for (int d = lane; d < KD; d += 32) {
          const float qv = qs[d];
#pragma unroll
          for (int i = 0; i < SLOTS; ++i)
            v[i] = fmaf(qv, to_f32(rows[ro[i] + d]), v[i]);
        }
        // lane -> slot (lane >> 1): its score, liveness and probability
        const int i = (lane >> 1) & (SLOTS - 1);
        const float dot = slot_sums(v, lane) * scale;
        const int r = s0 + i, p = i < ns ? sp[r] : -1;
        const bool live = i < ns && p == j * BS + r && p <= qpos;
        const float sc = live ? dot : NEG_INF_F;
        float mx = sc;
#pragma unroll
        for (int o = 2; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        mx = fmaxf(m, mx);
        const float pr = live ? expf(sc - mx) : 0.f;
        float lsum = pr;
#pragma unroll
        for (int o = 2; o < 32; o <<= 1)
          lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
        const float corr = expf(m - mx);
        l = l * corr + lsum;
        m = mx;
        // the latent context: acc = acc * corr + sum_slot p[slot] ckv[slot]
        float pv[SLOTS];
#pragma unroll
        for (int ii = 0; ii < SLOTS; ++ii)
          pv[ii] = __shfl_sync(0xffffffffu, pr, 2 * ii);
        for (int d = lane; d < lora; d += 32) {
          float a = acc[d] * corr;
#pragma unroll
          for (int ii = 0; ii < SLOTS; ++ii)
            a = fmaf(pv[ii], to_f32(rows[ro[ii] + d]), a);
          acc[d] = a;
        }
      }
    }
    __syncthreads();  // buffer `buf` is free for page jn's successor
    j = jn;
    buf ^= 1;
  }

  if (!active) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = lane; d < lora; d += 32)
    out[((size_t)b * H + h) * lora + d] = acc[d] * inv;
}

template <typename T>
cudaError_t launch_t(const float* qe, const float* qr, const void* ckv,
                     const void* krope, const int* pos, const int* tables,
                     const int* positions, float* out, int B, int H,
                     int lora, int dr, int BS, int pages, float scale,
                     cudaStream_t s) {
  if (lora <= 0 || dr < 0 || BS <= 0) return cudaErrorInvalidValue;
  const size_t bytes = Layout(BS, lora, dr, sizeof(T)).bytes();
  // 16-byte copies need both parts of every row (and the pool bases)
  // 16-byte aligned
  const bool vec = ((size_t)lora * sizeof(T)) % 16 == 0 &&
                   ((size_t)dr * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ckv) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(krope) % 16 == 0;
  const dim3 grid(ceil_div(H, HEADS_PER_BLOCK), B);
  const dim3 block(HEADS_PER_BLOCK * 32);
  cudaError_t e;
  if (vec) {
    auto k = paged_decode_mla_kernel<T, true>;
    if (bytes > 48 * 1024) {
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
      if (e != cudaSuccess) return e;
    }
    k<<<grid, block, bytes, s>>>(qe, qr, static_cast<const T*>(ckv),
                                 static_cast<const T*>(krope), pos, tables,
                                 positions, out, H, lora, dr, BS, pages,
                                 scale);
  } else {
    auto k = paged_decode_mla_kernel<T, false>;
    if (bytes > 48 * 1024) {
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
      if (e != cudaSuccess) return e;
    }
    k<<<grid, block, bytes, s>>>(qe, qr, static_cast<const T*>(ckv),
                                 static_cast<const T*>(krope), pos, tables,
                                 positions, out, H, lora, dr, BS, pages,
                                 scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q_eff f32 [B, H, lora], q_rope f32 [B, H, dr]; ckv [NB, BS, lora] and
// krope [NB, BS, dr] in bf16 (kv_is_bf16) or f32; pos int32 [NB, BS];
// tables int32 [B, pages]; positions int32 [B]; out f32 [B, H, lora]
extern "C" int launch_paged_decode_mla(const void* q_eff, const void* q_rope,
                                       const void* ckv, const void* krope,
                                       const void* pos, const void* tables,
                                       const void* positions, void* out,
                                       int B, int H, int lora, int dr, int BS,
                                       int pages, float scale, int kv_is_bf16,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qe = static_cast<const float*>(q_eff);
  const float* qr = static_cast<const float*>(q_rope);
  const int* p = static_cast<const int*>(pos);
  const int* t = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(positions);
  float* o = static_cast<float*>(out);
  cudaError_t e =
      kv_is_bf16
          ? launch_t<__nv_bfloat16>(qe, qr, ckv, krope, p, t, ps, o, B, H,
                                    lora, dr, BS, pages, scale, s)
          : launch_t<float>(qe, qr, ckv, krope, p, t, ps, o, B, H, lora, dr,
                            BS, pages, scale, s);
  return static_cast<int>(e);
}

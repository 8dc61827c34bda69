// Absorbed MLA decode attention straight from the latent block pool,
// split over the block table (flash-decoding).
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
// which bf16 tensor cores would be the limit, so its bound is bytes.
// But at B = 8 the latent of a 150-page cache is 1.4 MB, under a
// microsecond of HBM time, so what holds it is latency: how many SMs
// share the walk, and how long each waits on its pages.
//
// What the design does about it:
//  * The walk is split: a block owns one batch row, a tile of up to 40
//    query heads (all of MiniCPM3's: 20 warps, 2 heads a warp) and a
//    range of whole pages of the row's table (ops.mla_splits: about one
//    block per SM, 16 splits at B 8).  Each page a block visits is
//    staged once for all its heads.  A block writes its partial (max, sum,
//    unnormalized context) per head; the last block of each (row, head
//    tile) to finish (a counter, set back to 0 by that block) merges the
//    partials in split order, so the result does not depend on which
//    blocks ran when and no second kernel is launched.  The merge first
//    turns each split's (max, sum) into one weight per head, then reads
//    the partial contexts with 16-byte loads, several in flight.  A split
//    with no live slot merges as empty (max -1e30, sum 0, context 0).
//    The merge reads splits x heads x lora floats, so more splits than
//    about one block per SM cost more than they give (32 splits measured
//    slower than 16 at B 8, at every head tile tried).
//  * Thread 0 reads the row's position and the split's table entries,
//    lists the allocated pages that can hold a live slot, and starts TMA
//    bulk copies of the first three into a ring of STAGES stages on
//    mbarriers: per page, its ckv rows, its krope rows (each contiguous
//    in the pool) and its slot positions.  It refills a stage as soon as
//    every warp is done with it.  Meanwhile the block loads q_eff and
//    q_rope of its heads into shared memory (skipped when the split has
//    no page to visit).
//  * Each warp keeps the online-softmax state of its 2 heads in
//    registers: max, sum and the f32 context, 8 values of each head per
//    lane at lora <= 256 (dims lane + 32 k; 16 up to 512).  Slots are
//    scored 8 at a time: a lane accumulates partial dots of its dims for
//    8 slots x 2 heads (every latent value read from shared memory feeds
//    both heads), and one butterfly that halves the values a lane keeps
//    at each step sums them over the warp (lane l then holds slot
//    (l >> 2) & 7's score).  Two heads a warp rather than four: twice
//    the warps to hide the latency of the page loop's loads and shuffles,
//    which measured faster.
//    The context takes each live slot's 2 probabilities by shuffles and
//    its latent row from shared memory; dead slots are skipped, so
//    whatever they hold never reaches the output.
//  * Widths whose page blocks are not whole 16-byte units (the tests'
//    ragged cases) are staged by plain loads of all threads instead,
//    one page at a time: the same arithmetic, no TMA.
// Liveness is the reference's: a table entry < 0 is not allocated and
// its page is skipped outright (the reference reads trash block 0 and
// masks it); a slot is live only if its stored position equals its
// logical index j * BS + i (a recycled block holds stale positions) and
// is <= positions[b].  Pages past positions[b] / BS hold no live slot and
// are not visited.  A row with no live slot outputs zeros, never NaN.
// Rounding: q_eff and q_rope arrive in f32 and stay so (no rounding to
// the pool type); pool values are converted to f32 on read; scores,
// softmax and the context accumulate in f32, as in the reference.  Only
// the summation order differs from the plain version.
#include "common.cuh"

namespace {

constexpr int HW = 2;               // query heads per warp
constexpr int MAX_WARPS = 20;
constexpr int CS = 8;               // slots scored at once
constexpr int STAGES = 3;
constexpr int MAX_LORA = 512;
// a block's dynamic shared memory: the card's 232,448 bytes less room
// for static buffers
constexpr int MAX_SMEM = 232448 - 1024;

struct MlaArgs {
  const float* q_eff;     // [B, H, lora]
  const float* q_rope;    // [B, H, dr]
  const void* ckv;        // [NB, BS, lora]
  const void* krope;      // [NB, BS, dr]
  const int* pos;         // [NB, BS]
  const int* tables;      // [B, pages]
  const int* positions;   // [B]
  float* out;             // [B, H, lora]
  float* part_o;          // splits > 1: [splits, B, H, lora]
  float* part_ml;         // splits > 1: [splits, B, H, 2]
  int* sem;               // splits > 1: [B, head tiles], zero between calls
  int B, H, lora, dr, BS, pages;
  float scale;
  int splits, per;        // table splits, pages per split
  int hb;                 // head slots per block (4 per warp)
  int vec;                // TMA bulk copies (16-byte page blocks)
};

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

// shared memory: q_eff and q_rope of the block's heads (f32), the list
// of pages to visit, then a ring of STAGES pages (ckv rows, krope rows,
// slot positions)
struct Layout {
  int qe, qr, list, ck, kr, ps, stage, ring, total;
  __host__ __device__ Layout(int hb, int lora, int dr, int BS, int elem,
                             int per, int splits) {
    qe = hb * lora * 4;
    qr = hb * dr * 4;
    list = round16(per * 8);
    ck = round16(BS * lora * elem);
    kr = round16(BS * dr * elem);
    ps = round16(BS * 4);
    stage = ck + kr + ps;
    ring = qe + qr + list;
    // the ring, or the merge's per-split weights where those are larger
    const int merge = splits * hb * 4;
    total = ring + (STAGES * stage > merge ? STAGES * stage : merge);
  }
};

// One butterfly step over N per-slot partials: lanes whose bit O is
// clear keep slots [0, HALF) of their values and send [HALF, 2 HALF); the
// others the reverse.
template <int HALF, int O, int N>
__device__ __forceinline__ void keep_half(float (&v)[N], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// Sum each lane's 8 per-slot partials over the warp: three butterfly
// steps that halve the values a lane keeps, then two plain ones, so lane
// l ends with the full sum of slot (l >> 2) & 7 (the same value in the 4
// lanes of a slot), in a fixed order.  Every index is a compile-time
// constant, so v stays in registers.
__device__ __forceinline__ float slot_sums(float (&v)[CS], int lane) {
  keep_half<4, 16>(v, lane);
  keep_half<2, 8>(v, lane);
  keep_half<1, 4>(v, lane);
  float s = v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
  return s + __shfl_xor_sync(0xffffffffu, s, 2);
}

// T: the pools' type; ND: context values per lane and head (lora <= 32 ND)
template <typename T, int ND>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    paged_decode_mla_kernel(const MlaArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t mbar[STAGES];
  __shared__ int n_s, qpos_s, last_s;
  const int split = blockIdx.x, b = blockIdx.y, ht = blockIdx.z;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int lora = a.lora, dr = a.dr, BS = a.BS, H = a.H;
  const int h0 = ht * a.hb, wh = warp * HW;  // block's and warp's heads
  const Layout L(a.hb, lora, dr, BS, sizeof(T), a.per, a.splits);
  float* qe_s = reinterpret_cast<float*>(smem);
  float* qr_s = reinterpret_cast<float*>(smem + L.qe);
  int2* list = reinterpret_cast<int2*>(smem + L.qe + L.qr);
  unsigned char* ring = smem + L.ring;
  const T* ckv = static_cast<const T*>(a.ckv);
  const T* krope = static_cast<const T*>(a.krope);

  // stage page `entry` into ring slot st by three TMA bulk copies
  auto issue = [&](int st, int entry) {
    unsigned char* base = ring + st * L.stage;
    const unsigned ckb = BS * lora * sizeof(T), krb = BS * dr * sizeof(T);
    mbar_expect_tx(&mbar[st], ckb + krb + BS * 4);
    bulk_copy(base, ckv + (size_t)entry * BS * lora, ckb, &mbar[st]);
    if (krb)
      bulk_copy(base + L.ck, krope + (size_t)entry * BS * dr, krb, &mbar[st]);
    bulk_copy(base + L.ck + L.kr, a.pos + (size_t)entry * BS, BS * 4,
              &mbar[st]);
  };

  // the pages of this split that can hold a live slot, and the first
  // copies
  if (tid == 0) {
    const int qpos = a.positions[b];
    const int last = qpos < 0 ? -1 : min(a.pages - 1, qpos / BS);
    const int j0 = split * a.per, j1 = min(j0 + a.per, last + 1);
    const int* table = a.tables + (size_t)b * a.pages;
    int n = 0;
    for (int j = j0; j < j1; ++j) {
      const int e = table[j];
      if (e >= 0) list[n++] = make_int2(j, e);
    }
    n_s = n;
    qpos_s = qpos;
    if (a.vec) {
      for (int st = 0; st < STAGES; ++st) mbar_init(&mbar[st], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int i = 0; i < min(n, STAGES); ++i) issue(i, list[i].y);
    }
  }
  __syncthreads();
  const int n = n_s, qpos = qpos_s;
  if (n > 0) {
    // the block's heads are contiguous in q_eff and q_rope
    const int nh = min(a.hb, H - h0);
    const float* qe = a.q_eff + ((size_t)b * H + h0) * lora;
    const float* qr = a.q_rope + ((size_t)b * H + h0) * dr;
    for (int i = tid; i < a.hb * lora; i += nt)
      qe_s[i] = i < nh * lora ? qe[i] : 0.f;
    for (int i = tid; i < a.hb * dr; i += nt)
      qr_s[i] = i < nh * dr ? qr[i] : 0.f;
  }
  __syncthreads();

  const bool active = h0 + wh < H;
  float m[HW], l[HW], acc[HW][ND];
#pragma unroll
  for (int h = 0; h < HW; ++h) {
    m[h] = NEG_INF_F;
    l[h] = 0.f;
#pragma unroll
    for (int k = 0; k < ND; ++k) acc[h][k] = 0.f;
  }

  for (int i = 0; i < n; ++i) {
    const int st = a.vec ? i % STAGES : 0;
    unsigned char* base = ring + st * L.stage;
    if (a.vec) {
      mbar_wait(&mbar[st], (i / STAGES) & 1);
    } else {
      // plain loads of all threads, one page at a time
      const size_t e = list[i].y;
      T* ckd = reinterpret_cast<T*>(base);
      T* krd = reinterpret_cast<T*>(base + L.ck);
      int* psd = reinterpret_cast<int*>(base + L.ck + L.kr);
      for (int k = tid; k < BS * lora; k += nt) ckd[k] = ckv[e * BS * lora + k];
      for (int k = tid; k < BS * dr; k += nt) krd[k] = krope[e * BS * dr + k];
      for (int k = tid; k < BS; k += nt) psd[k] = a.pos[e * BS + k];
      __syncthreads();
    }
    const T* ck = reinterpret_cast<const T*>(base);
    const T* kr = reinterpret_cast<const T*>(base + L.ck);
    const int* sp = reinterpret_cast<const int*>(base + L.ck + L.kr);
    const int j = list[i].x;
    if (active) {
      for (int s0 = 0; s0 < BS; s0 += CS) {
        // slots past the page read its last row and are masked below, so
        // the slot loops need no branch
        int ro[CS];
#pragma unroll
        for (int c = 0; c < CS; ++c) ro[c] = min(s0 + c, BS - 1);
        // per-lane partial dots of CS slots x HW heads over its dims
        float v[HW][CS];
#pragma unroll
        for (int h = 0; h < HW; ++h)
#pragma unroll
          for (int c = 0; c < CS; ++c) v[h][c] = 0.f;
        for (int d = lane; d < lora; d += 32) {
          float kv[CS];
#pragma unroll
          for (int c = 0; c < CS; ++c) kv[c] = to_f32(ck[ro[c] * lora + d]);
#pragma unroll
          for (int h = 0; h < HW; ++h) {
            const float qv = qe_s[(wh + h) * lora + d];
#pragma unroll
            for (int c = 0; c < CS; ++c) v[h][c] = fmaf(qv, kv[c], v[h][c]);
          }
        }
        for (int d = lane; d < dr; d += 32) {
          float kv[CS];
#pragma unroll
          for (int c = 0; c < CS; ++c) kv[c] = to_f32(kr[ro[c] * dr + d]);
#pragma unroll
          for (int h = 0; h < HW; ++h) {
            const float qv = qr_s[(wh + h) * dr + d];
#pragma unroll
            for (int c = 0; c < CS; ++c) v[h][c] = fmaf(qv, kv[c], v[h][c]);
          }
        }
        // lane -> slot c = (lane >> 2) & 7: its liveness, and per head its
        // score, the online update and its probability
        const int r = s0 + ((lane >> 2) & (CS - 1));
        const int p = r < BS ? sp[r] : -1;
        const bool live = r < BS && p == j * BS + r && p <= qpos;
        float pr[HW];
#pragma unroll
        for (int h = 0; h < HW; ++h) {
          const float dot = slot_sums(v[h], lane);  // every lane shuffles
          const float sc = live ? dot * a.scale : NEG_INF_F;
          float mx = fmaxf(sc, __shfl_xor_sync(0xffffffffu, sc, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          mx = fmaxf(m[h], mx);
          pr[h] = live ? expf(sc - mx) : 0.f;
          float ls = pr[h] + __shfl_xor_sync(0xffffffffu, pr[h], 4);
          ls += __shfl_xor_sync(0xffffffffu, ls, 8);
          ls += __shfl_xor_sync(0xffffffffu, ls, 16);
          const float corr = expf(m[h] - mx);
          l[h] = l[h] * corr + ls;
          m[h] = mx;
#pragma unroll
          for (int k = 0; k < ND; ++k) acc[h][k] *= corr;
        }
        // the context: acc += p[slot] ckv[slot] over the live slots
        const unsigned lm = __ballot_sync(0xffffffffu, live);
#pragma unroll
        for (int c = 0; c < CS; ++c) {
          float pc[HW];
#pragma unroll
          for (int h = 0; h < HW; ++h)
            pc[h] = __shfl_sync(0xffffffffu, pr[h], 4 * c);
          if (!((lm >> (4 * c)) & 1u)) continue;  // uniform across the warp
          const T* row = ck + (s0 + c) * lora;
#pragma unroll
          for (int k = 0; k < ND; ++k) {
            const int d = lane + 32 * k;
            if (d < lora) {
              const float vv = to_f32(row[d]);
#pragma unroll
              for (int h = 0; h < HW; ++h)
                acc[h][k] = fmaf(pc[h], vv, acc[h][k]);
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage st
    if (a.vec && tid == 0 && i + STAGES < n) issue(st, list[i + STAGES].y);
  }

  const size_t rows = (size_t)a.B * H;
  if (a.splits == 1) {
#pragma unroll
    for (int h = 0; h < HW; ++h) {
      const int hh = h0 + wh + h;
      if (hh >= H) continue;
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
      for (int k = 0; k < ND; ++k) {
        const int d = lane + 32 * k;
        if (d < lora) a.out[((size_t)b * H + hh) * lora + d] = acc[h][k] * inv;
      }
    }
    return;
  }
#pragma unroll
  for (int h = 0; h < HW; ++h) {
    const int hh = h0 + wh + h;
    if (hh >= H) continue;
    const size_t pr = (size_t)split * rows + (size_t)b * H + hh;
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      const int d = lane + 32 * k;
      if (d < lora) a.part_o[pr * lora + d] = acc[h][k];
    }
    if (lane == 0) {
      a.part_ml[pr * 2] = m[h];
      a.part_ml[pr * 2 + 1] = l[h];
    }
  }

  // the last split of this (row, head tile) to finish merges all of them
  // in split order and sets the tile's counter back to 0 for the next call
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int g = b * gridDim.z + ht;
    last_s = atomicAdd(a.sem + g, 1) == a.splits - 1;
    if (last_s) a.sem[g] = 0;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // each split's weight per head, exp(m_s - max m) / sum_s l_s exp(m_s -
  // max m), into the ring (no longer read), then the context as the
  // weighted sum of the partials, in split order
  const int nh = min(a.hb, H - h0);
  float* f = reinterpret_cast<float*>(ring);   // [splits][hb]
  for (int hl = tid; hl < nh; hl += nt) {
    const size_t row = (size_t)b * H + h0 + hl;
    float mx = NEG_INF_F;
    for (int s = 0; s < a.splits; ++s)
      mx = fmaxf(mx, __ldcg(a.part_ml + ((size_t)s * rows + row) * 2));
    float sum = 0.f;
    for (int s = 0; s < a.splits; ++s) {
      const size_t pr = (size_t)s * rows + row;
      const float e = expf(__ldcg(a.part_ml + pr * 2) - mx);
      f[s * a.hb + hl] = e;
      sum = fmaf(__ldcg(a.part_ml + pr * 2 + 1), e, sum);
    }
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    for (int s = 0; s < a.splits; ++s) f[s * a.hb + hl] *= inv;
  }
  __syncthreads();
  // 4 dims a thread (16-byte loads) where the rows allow it; the split
  // loop unrolled so several loads are in flight
  const int vw = lora % 4 == 0 ? 4 : 1, nv = lora / vw;
  for (int i = tid; i < nh * nv; i += nt) {
    const int hl = i / nv, d = (i - hl * nv) * vw;
    const size_t row = (size_t)b * H + h0 + hl;
    const float* src = a.part_o + row * lora + d;
    const size_t stride = rows * lora;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    if (vw == 4) {
#pragma unroll 4
      for (int s = 0; s < a.splits; ++s) {
        const float4 v =
            __ldcg(reinterpret_cast<const float4*>(src + s * stride));
        const float w = f[s * a.hb + hl];
        o[0] = fmaf(v.x, w, o[0]);
        o[1] = fmaf(v.y, w, o[1]);
        o[2] = fmaf(v.z, w, o[2]);
        o[3] = fmaf(v.w, w, o[3]);
      }
      *reinterpret_cast<float4*>(a.out + row * lora + d) =
          make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll 4
      for (int s = 0; s < a.splits; ++s)
        o[0] = fmaf(__ldcg(src + s * stride), f[s * a.hb + hl], o[0]);
      a.out[row * lora + d] = o[0];
    }
  }
}

template <typename T, int ND>
cudaError_t launch_nd(const MlaArgs& a, int smem, int warps,
                      cudaStream_t s) {
  auto kernel = paged_decode_mla_kernel<T, ND>;
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
  const dim3 grid(a.splits, a.B, ceil_div(a.H, a.hb));
  kernel<<<grid, warps * 32, smem, s>>>(a);
  return cudaGetLastError();
}

bool aligned(const void* p, int n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

template <typename T>
cudaError_t launch_t(MlaArgs a, cudaStream_t s) {
  const int elem = sizeof(T);
  if (a.B < 1 || a.B > 65535 || a.H < 1 || a.lora < 1 ||
      a.lora > MAX_LORA || a.dr < 0 || a.BS < 1 || a.pages < 1 ||
      a.splits < 1 || a.splits > a.pages)
    return cudaErrorInvalidValue;
  a.per = ceil_div(a.pages, a.splits);
  if (ceil_div(a.pages, a.per) != a.splits ||
      (a.splits > 1 && (a.part_o == nullptr || a.part_ml == nullptr ||
                        a.sem == nullptr)))
    return cudaErrorInvalidValue;
  if (a.hb < HW || a.hb > HW * MAX_WARPS || a.hb % HW ||
      ceil_div(a.H, a.hb) > 65535)
    return cudaErrorInvalidValue;
  const int warps = a.hb / HW;
  // bulk copies need every page block a whole number of 16-byte units
  // from a 16-byte aligned base
  a.vec = (a.BS * a.lora * elem) % 16 == 0 &&
          (a.BS * a.dr * elem) % 16 == 0 && (a.BS * 4) % 16 == 0 &&
          aligned(a.ckv, 16) && aligned(a.krope, 16) && aligned(a.pos, 16);
  // the merge writes 16-byte vectors when lora % 4 == 0
  if (a.lora % 4 == 0 && (!aligned(a.out, 16) ||
                          (a.splits > 1 && !aligned(a.part_o, 16))))
    return cudaErrorInvalidValue;
  const int smem =
      Layout(a.hb, a.lora, a.dr, a.BS, elem, a.per, a.splits).total;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  return a.lora <= 256 ? launch_nd<T, 8>(a, smem, warps, s)
                       : launch_nd<T, 16>(a, smem, warps, s);
}

}  // namespace

// q_eff f32 [B, H, lora], q_rope f32 [B, H, dr]; ckv [NB, BS, lora] and
// krope [NB, BS, dr] in bf16 (kv_is_bf16) or f32; pos int32 [NB, BS];
// tables int32 [B, pages]; positions int32 [B]; out f32 [B, H, lora].
// heads_per_block: the head tile, even, up to 40 (2 heads a warp).  With splits > 1, part_o f32 [splits, B, H, lora] and part_ml
// f32 [splits, B, H, 2] hold the partials, and sem int32 [B, ceil(H /
// heads_per_block)], all zero, counts each (row, head tile)'s finished
// splits (the last one merges and zeroes it again).
extern "C" int launch_paged_decode_mla(const void* q_eff, const void* q_rope,
                                       const void* ckv, const void* krope,
                                       const void* pos, const void* tables,
                                       const void* positions, void* out,
                                       void* part_o, void* part_ml,
                                       void* sem, int B, int H, int lora,
                                       int dr, int BS, int pages, float scale,
                                       int kv_is_bf16, int heads_per_block,
                                       int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MlaArgs a{static_cast<const float*>(q_eff),
                  static_cast<const float*>(q_rope), ckv, krope,
                  static_cast<const int*>(pos),
                  static_cast<const int*>(tables),
                  static_cast<const int*>(positions),
                  static_cast<float*>(out), static_cast<float*>(part_o),
                  static_cast<float*>(part_ml), static_cast<int*>(sem),
                  B, H, lora, dr, BS, pages, scale, splits, 0,
                  heads_per_block, 0};
  return static_cast<int>(kv_is_bf16 ? launch_t<__nv_bfloat16>(a, s)
                                     : launch_t<float>(a, s));
}

// Chunked prefill straight from the KV block pool, over float pools and
// over int8 pools with per-slot scales.  (Decode is paged_decode.cu.)
//
// Replaces:
//   paged_prefill      -> src/repro/kernels/paged_attention/paged_attention.py
//                         ::_paged_prefill_kernel, float flavour (launcher
//                         paged_prefill_tiled, k_scale=None)
//   paged_prefill_int8 -> ::_paged_prefill_kernel, int8 flavour (launcher
//                         paged_prefill_tiled with k_scale/v_scale)
// The two entry points dispatch by dtype: bf16 compute (bf16 pools; int8
// pools computed in bf16, the main path) runs the tensor-core kernel of
// paged_prefill.cu; f32 compute (f32 pools; int8 pools computed in f32,
// kept for exact checks) runs the CUDA-core attend_tile body below.
//
// What bounds it on an H100: the f32 chunked prefill re-reads each block
// once per query tile and does 4 * C * L * D flops per (row, head) on
// CUDA cores.
//
// What the CUDA-core body does about it: a block owns one (batch row,
// kv head, tile of the chunk's queries) and walks the row's block table
// itself.  The online-softmax state (running max,
// running sum, f32 accumulator) lives in shared memory for the block's
// whole walk: the Pallas grid carries it across its innermost page axis
// in VMEM scratch, but CUDA blocks cannot carry anything between each
// other.  Per live page it stages the K/V block (converted to f32; int8
// converts exactly), the slot liveness and, for int8 pools, the page's
// k_scale / v_scale rows in shared memory; K rows and Q rows use a
// stride of D + 1 floats so the per-(query, slot) dot products read
// distinct banks.
// Liveness is the paged_view rule: a slot counts iff its table entry is
// >= 0, its stored position equals its logical index j * BS + i, and it
// is causally visible (pos <= the query's position).  Table entries < 0
// (which the reference reads through trash block 0 and masks) and pages
// that start past the tile's last query position hold no live slot, so
// they are skipped outright: the result is identical, and the work
// follows the data.  Masked probabilities are forced to 0, and a query
// with no live slot (a pad row at position -1) outputs exactly 0.
// Rounding order (the reference's): q arrives scaled and rounded to the
// compute type (the pool's type for float pools, bf16 for int8 pools).
// For int8 pools each raw score is multiplied by k_scale[slot, head]
// before the running max; the running sum adds the UNSCALED
// probabilities, and the PV product uses round(p * v_scale[slot, head])
// to the compute type.  For float pools p itself is rounded to the
// storage type.  The float instantiations are the same code with the
// scale steps compiled out.
#include "common.cuh"
#include "paged_prefill.cuh"

namespace {

// Q: the compute type q arrives in and p is rounded to; KV: the pool's
// storage type; SCALED: int8 pools with per-slot k/v scales.
template <typename Q, typename KV, bool SCALED>
__device__ void attend_tile(const Q* __restrict__ q,
                            const KV* __restrict__ kpool,
                            const KV* __restrict__ vpool,
                            const float* __restrict__ kscale,
                            const float* __restrict__ vscale,
                            const int* __restrict__ pos_pool,
                            const int* __restrict__ tables,
                            const int* __restrict__ positions,
                            float* __restrict__ out, int b, int h, int c0,
                            int nq, int C, int Hkv, int rep, int D, int BS,
                            int pages, float* smem) {
  const int rows = nq * rep;  // query vectors: row = cc * rep + r
  const int DP = D + 1;
  float* qs = smem;               // rows x DP
  float* ks = qs + rows * DP;     // BS x DP
  float* vs = ks + BS * DP;       // BS x D
  float* sc = vs + BS * D;        // rows x BS (scores, then probabilities)
  float* acc = sc + rows * BS;    // rows x D
  float* mrow = acc + rows * D;   // rows
  float* lrow = mrow + rows;      // rows
  float* corr = lrow + rows;      // rows
  float* ksc = corr + rows;       // BS (int8 pools only)
  float* vsc = ksc + (SCALED ? BS : 0);
  int* qp = reinterpret_cast<int*>(vsc + (SCALED ? BS : 0));  // nq
  int* slot = qp + nq;                                        // BS
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i < rows * D; i += nt) {
    const int row = i / D, d = i % D;
    const int cc = row / rep, r = row % rep;
    qs[row * DP + d] =
        to_f32(q[((((size_t)b * C + c0 + cc) * Hkv + h) * rep + r) * D + d]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < rows; i += nt) {
    mrow[i] = NEG_INF_F;
    lrow[i] = 0.f;
  }
  for (int i = tid; i < nq; i += nt) qp[i] = positions[(size_t)b * C + c0 + i];
  __syncthreads();

  int qmax = -1;
  for (int i = 0; i < nq; ++i) qmax = max(qmax, qp[i]);
  const int last = qmax < 0 ? -1 : min(pages - 1, qmax / BS);

  for (int j = 0; j <= last; ++j) {
    const int entry = tables[(size_t)b * pages + j];
    if (entry < 0) continue;  // uniform across the block
    for (int i = tid; i < BS * D; i += nt) {
      const int ii = i / D, d = i % D;
      const size_t off = (((size_t)entry * BS + ii) * Hkv + h) * D + d;
      ks[ii * DP + d] = to_f32(kpool[off]);
      vs[ii * D + d] = to_f32(vpool[off]);
    }
    for (int i = tid; i < BS; i += nt) {
      const int sp = pos_pool[(size_t)entry * BS + i];
      slot[i] = (sp == j * BS + i) ? sp : -1;
      if (SCALED) {
        const size_t so = ((size_t)entry * BS + i) * Hkv + h;
        ksc[i] = kscale[so];
        vsc[i] = vscale[so];
      }
    }
    __syncthreads();
    for (int i = tid; i < rows * BS; i += nt) {
      const int row = i / BS, ii = i % BS;
      const int sp = slot[ii];
      float v = NEG_INF_F;
      if (sp >= 0 && sp <= qp[row / rep]) {
        const float* qr = qs + row * DP;
        const float* kr = ks + ii * DP;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        v = SCALED ? dot * ksc[ii] : dot;
      }
      sc[i] = v;
    }
    __syncthreads();
    for (int row = tid; row < rows; row += nt) {
      const int qpos = qp[row / rep];
      const float mp = mrow[row];
      float mx = mp;
      for (int ii = 0; ii < BS; ++ii) mx = fmaxf(mx, sc[row * BS + ii]);
      float lsum = 0.f;
      for (int ii = 0; ii < BS; ++ii) {
        const int sp = slot[ii];
        const bool ok = sp >= 0 && sp <= qpos;
        const float p = ok ? expf(sc[row * BS + ii] - mx) : 0.f;
        lsum += p;
        sc[row * BS + ii] = round_to<Q>(SCALED ? p * vsc[ii] : p);
      }
      const float cr = expf(mp - mx);
      lrow[row] = lrow[row] * cr + lsum;
      mrow[row] = mx;
      corr[row] = cr;
    }
    __syncthreads();
    for (int i = tid; i < rows * D; i += nt) {
      const int row = i / D, d = i % D;
      float a = acc[i] * corr[row];
      for (int ii = 0; ii < BS; ++ii) a = fmaf(sc[row * BS + ii], vs[ii * D + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }
  for (int i = tid; i < rows * D; i += nt) {
    const int row = i / D, d = i % D;
    const int cc = row / rep, r = row % rep;
    out[((((size_t)b * C + c0 + cc) * Hkv + h) * rep + r) * D + d] =
        acc[i] / fmaxf(lrow[row], 1e-30f);
  }
}

template <typename Q, typename KV, bool SCALED>
__global__ void paged_prefill_kernel(const Q* q, const KV* kpool,
                                     const KV* vpool, const float* kscale,
                                     const float* vscale,
                                     const int* pos_pool, const int* tables,
                                     const int* positions, float* out, int C,
                                     int Hkv, int rep, int D, int BS,
                                     int pages, int qt) {
  extern __shared__ float smem[];
  const int c0 = blockIdx.x * qt;
  attend_tile<Q, KV, SCALED>(q, kpool, vpool, kscale, vscale, pos_pool,
                             tables, positions, out, blockIdx.z, blockIdx.y,
                             c0, min(qt, C - c0), C, Hkv, rep, D, BS, pages,
                             smem);
}

size_t smem_bytes(int rows, int nq, int D, int BS, bool scaled) {
  const size_t floats = (size_t)rows * (D + 1) + (size_t)BS * (D + 1) +
                        (size_t)BS * D + (size_t)rows * BS +
                        (size_t)rows * D + 3 * (size_t)rows +
                        (scaled ? 2 * (size_t)BS : 0);
  return floats * sizeof(float) + (size_t)(nq + BS) * sizeof(int);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// the pointers of one call, as the C entry points receive them
struct Args {
  const void *q, *k, *v, *ks, *vs, *pos, *tables, *positions;
  void* out;
};

template <typename Q, typename KV, bool SCALED>
cudaError_t prefill_t(const Args& a, int B, int C, int Hkv, int rep, int D,
                      int BS, int pages, cudaStream_t s) {
  const int qt = max(1, 16 / rep);
  const size_t bytes = smem_bytes(qt * rep, qt, D, BS, SCALED);
  cudaError_t e = allow_smem(paged_prefill_kernel<Q, KV, SCALED>, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(ceil_div(C, qt), Hkv, B);
  paged_prefill_kernel<Q, KV, SCALED><<<grid, 256, bytes, s>>>(
      static_cast<const Q*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.pos),
      static_cast<const int*>(a.tables),
      static_cast<const int*>(a.positions), static_cast<float*>(a.out), C,
      Hkv, rep, D, BS, pages, qt);
  return cudaGetLastError();
}

}  // namespace

// Float pools.  bf16 pools compute on the tensor cores (paged_prefill.cu):
// q arrives unscaled in bf16 or f32 (q_is_bf16), the kernel scales it
// and writes the output in bf16 or f32 (out_is_bf16).  f32 pools run the
// CUDA-core body above: q arrives pre-scaled in f32, out is f32, and
// scale / q_is_bf16 / out_is_bf16 must be 1 / 0 / 0.
extern "C" int launch_paged_prefill(const void* q, const void* k,
                                    const void* v, const void* pos,
                                    const void* tables, const void* positions,
                                    void* out, int B, int C, int Hkv, int rep,
                                    int D, int BS, int pages, int kv_is_bf16,
                                    float scale, int q_is_bf16,
                                    int out_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_is_bf16) {
    const PrefillMmaArgs a{q,      k,         v,     nullptr, nullptr,
                           static_cast<const int*>(pos),
                           static_cast<const int*>(tables),
                           static_cast<const int*>(positions),
                           out,    B,         C,     Hkv,     rep,
                           D,      BS,        pages, scale,   q_is_bf16,
                           out_is_bf16};
    return static_cast<int>(prefill_mma_bf16(a, s));
  }
  if (q_is_bf16 || out_is_bf16 || scale != 1.f)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, nullptr, nullptr, pos, tables, positions, out};
  return static_cast<int>(
      prefill_t<float, float, false>(a, B, C, Hkv, rep, D, BS, pages, s));
}

// int8 pools.  bf16 compute (compute_bf16) runs on the tensor cores as
// launch_paged_prefill does for bf16 pools; f32 compute runs the CUDA-core
// body, q pre-scaled in f32, out f32.
extern "C" int launch_paged_prefill_int8(const void* q, const void* k,
                                         const void* v, const void* ks,
                                         const void* vs, const void* pos,
                                         const void* tables,
                                         const void* positions, void* out,
                                         int B, int C, int Hkv, int rep,
                                         int D, int BS, int pages,
                                         int compute_bf16, float scale,
                                         int q_is_bf16, int out_is_bf16,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (compute_bf16) {
    const PrefillMmaArgs a{q,      k,         v,
                           static_cast<const float*>(ks),
                           static_cast<const float*>(vs),
                           static_cast<const int*>(pos),
                           static_cast<const int*>(tables),
                           static_cast<const int*>(positions),
                           out,    B,         C,     Hkv,   rep,
                           D,      BS,        pages, scale, q_is_bf16,
                           out_is_bf16};
    return static_cast<int>(prefill_mma_int8(a, s));
  }
  if (q_is_bf16 || out_is_bf16 || scale != 1.f)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, ks, vs, pos, tables, positions, out};
  return static_cast<int>(
      prefill_t<float, int8_t, true>(a, B, C, Hkv, rep, D, BS, pages, s));
}

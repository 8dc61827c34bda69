// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel file exposes `extern "C" int launch_<name>(...)`: it
// launches on the caller's stream (PyTorch's current stream, passed as
// a raw pointer), never synchronises, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused
// launch.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define NEG_INF_F (-1e30f)

template <typename T>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

// round an f32 to the storage type and back (the reference casts the
// softmax probabilities to the V dtype before the PV contraction)
template <typename T>
__device__ __forceinline__ float round_to(float v);

template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

static inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// asynchronous copies of 16, 8 and 4 bytes to shared memory; with
// src_bytes below the size the rest of the destination is zero-filled
// (0: all of it, and nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes = 8) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarriers (shared memory) that TMA bulk copies complete on
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

// one arrival, announcing ``bytes`` more to land in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT%=;\n}" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}

// a TMA bulk copy of ``bytes`` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on mbarrier b
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

// eight activations x[off .. off + 8) as f32 (columns col .. col + 8 of a
// row of N); 16-byte loads when ``vec`` (aligned rows) and the eight lie
// inside the row, else element loads with columns >= N read as 0
template <typename T>
__device__ __forceinline__ void load_x8(const T* __restrict__ x, size_t off,
                                        int col, int N, bool vec,
                                        float (&v)[8]) {
  if (vec && col + 8 <= N) {
    if constexpr (sizeof(T) == 2) {
      const uint4 u = *reinterpret_cast<const uint4*>(x + off);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    } else {
      const float4 a = *reinterpret_cast<const float4*>(x + off);
      const float4 b = *reinterpret_cast<const float4*>(x + off + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = (col + e < N) ? to_f32(x[off + e]) : 0.f;
  }
}

namespace {

// y = sum over the splits of the partial sums part[S][n], in split order,
// so a split reduction axis gives the same result however blocks ran
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ y, int S, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += part[(size_t)k * n + i];
  y[i] = s;
}

inline cudaError_t launch_sum_splits(const float* part, float* y, int S,
                                     size_t n, cudaStream_t s) {
  sum_splits_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      part, y, S, n);
  return cudaGetLastError();
}

}  // namespace

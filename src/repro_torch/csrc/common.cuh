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
